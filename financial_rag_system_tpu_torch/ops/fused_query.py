"""Fused two-stage query: embed -> top-k -> gather -> rerank, on the device.

Port of ``financial_rag_system_tpu/ops/fused_query.py``.  With the full model
stack, the flat tier (:func:`fused_two_stage`, ``fused_kind == "full"``),
the IVF tier (:func:`fused_ivf_two_stage`, ``"ivf_full"``) and the HNSW
tier (:func:`fused_hnsw_two_stage`, ``"hnsw_full"``):

  q_ids --BGE encoder--> qv --masked top-k kernel (flat), centroid
        probe + probed-tiles kernel (IVF) or pool routing + descent +
        graph walk (HNSW, torch ops: the JAX walk is XLA)--> rows
        --gather of pretokenized chunk ids from the device token store-->
        pair batch --MiniLM cross-encoder (pair-attention kernel)--> logits

Over a corpus sharded on a mesh (:mod:`index.sharded`), the
``make_sharded_fused_*`` builders run each shard's search (kernel 1, the
probe kernel or the walk) on its device, merge the (B, k) partials in
shard order and rerank the merged set work-balanced: one ``psum`` fetches
the owned candidates' tokens and each shard cross-encodes an even
``ceil(B * k / S)`` slice of the pairs (:func:`_sharded_balanced_rerank`).

PyTorch runs eagerly, so this is one Python call that queues every stage
on the device's stream with no host synchronisation in between; the
caller reads rows, bi scores and logits back once per batch.  The corpus
side contributes two device tensors: embeddings (N, D) and token ids
(N, DLEN), so candidate texts never travel to the host for rerank
tokenization.

With the hermetic hash stack (:mod:`models.embedder` HashEmbedder,
:mod:`models.reranker` HashReranker), the flat tier
(:func:`fused_hash_query`, ``"hash"``) and the IVF tier
(:func:`fused_ivf_hash_query`, ``"ivf_hash"``): a hash bag of the query
tokens, then the same masked top-k or probe kernel, and, with a token
store and a non-identity reranker, the de-aliased hash rerank of the
gathered candidates (:func:`fused_hash_rerank_query`,
:func:`fused_ivf_hash_rerank_query`).  The bags are gathers and
mean-pools, which the JAX package leaves to XLA; here they are torch ops.

Pair layout: [CLS] q (padded to LQ) [SEP] doc [SEP], with the doc segment
at the fixed offset LQ; with trained weights this shifts doc position ids
by (LQ - len(q)) versus compact packing.  Pad positions are
attention-masked, so scores are otherwise exact.  The pair length stays
exact unless the flash path would engage at the length rounded up to 128
(``RAG_TPU_FLASH``, ``models/bert.py _flash_enabled``); then it is
rounded up to 128, as in the JAX package (400 -> 512 at the rerank
shape), and the pairs' attention runs the flash kernel, or kernel 2 where
the pair-attention gate comes first.
"""

from __future__ import annotations

import functools

import torch

from financial_rag_system_tpu_torch.index.flat import quantize_int8
from financial_rag_system_tpu_torch.index.ivf import ivf_probe, probe_tile_list
from financial_rag_system_tpu_torch.models import bert
from financial_rag_system_tpu_torch.models.embedder import _hash_embed
from financial_rag_system_tpu_torch.index.sharded import merge_partials
from financial_rag_system_tpu_torch.ops.topk import masked_topk
from financial_rag_system_tpu_torch.parallel.collectives import all_gather, psum
from financial_rag_system_tpu_torch.parallel.mesh import AXIS_CORPUS

CLS_ID = 101


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _prep_queries(qv: torch.Tensor, corpus_dtype: torch.dtype) -> torch.Tensor:
    """Match query vectors to the corpus representation inside the fused
    pipeline, the twin of ``FlatIndex.prep_queries``: an int8 corpus gets
    the rows' symmetric int8 quantization, any other a plain cast (JAX
    ``fused_query.py:79-86``)."""
    if corpus_dtype == torch.int8:
        return quantize_int8(qv)
    return qv.to(corpus_dtype).contiguous()


def _embed(embed_model: bert.BertModel, q_ids, q_types, q_mask) -> torch.Tensor:
    """Stage 1: bi-encoder embedding, CLS pool + L2 norm."""
    cls = embed_model.encode(q_ids, q_types, q_mask)[:, 0, :]
    return cls / torch.linalg.norm(cls, dim=-1, keepdim=True).clamp_min(1e-12)


def _assemble_pairs(
    pair_q: torch.Tensor,   # (P, LQ) per-pair query token ids
    pair_d: torch.Tensor,   # (P, DLEN) per-pair doc token ids
    *,
    rerank_cfg: bert.BertConfig,
):
    """Lay P (query, doc) token-id pairs out as one padded cross-encoder
    batch.  Returns int32 (pair_ids, pair_types, pair_mask) of shape
    (round_up(P, 8), plen), plen rounded up to 128 under the flash path."""
    p, lq = pair_q.shape
    dlen = pair_d.shape[1]
    # first-party trained rerankers carry the length they were trained at
    # (cfg.max_seq_length): positions past it are random init, so the
    # pair must not exceed it — trim the doc portion
    if rerank_cfg.max_seq_length and lq + dlen > rerank_cfg.max_seq_length:
        dlen = max(8, rerank_cfg.max_seq_length - lq)
        pair_d = pair_d[:, :dlen]
    pair_ids = torch.cat([pair_q, pair_d], dim=1).to(torch.int32)
    pair_types = torch.cat(
        [torch.zeros_like(pair_q, dtype=torch.int32),
         torch.ones_like(pair_d, dtype=torch.int32)],
        dim=1,
    )
    pair_mask = (pair_ids != 0).to(torch.int32)
    # pad the pair batch to a multiple of 8, as the JAX package does:
    # 480 pairs at B=32, K=15
    pad = _round_up(p, 8) - p
    # and the pair length up to the flash blocks' 128 where the flash gate
    # would take the rounded length (JAX fused_query.py:126-136), after the
    # trim above
    plen = pair_ids.shape[1]
    plen_up = _round_up(plen, 128)
    pad_l = plen_up - plen if bert._flash_enabled(plen_up, rerank_cfg.heads) else 0
    if pad or pad_l:
        pair_ids, pair_types, pair_mask = (
            torch.nn.functional.pad(x, (0, pad_l, 0, pad))
            for x in (pair_ids, pair_types, pair_mask)
        )
    return pair_ids, pair_types, pair_mask


def _pair_head(rerank_model: bert.BertModel, hh: torch.Tensor, p: int) -> torch.Tensor:
    """Pooler + classifier epilogue over encoded pairs: (P', L, H) CLS
    slice -> tanh pooler -> 1-logit classifier -> (p,) f32."""
    return bert.pair_head(rerank_model, hh[:, 0, :])[:p]


def _cross_encode_pairs(
    rerank_model: bert.BertModel,
    pair_q: torch.Tensor,
    pair_d: torch.Tensor,
    *,
    rerank_cfg: bert.BertConfig,
) -> torch.Tensor:
    """Cross-encode P (query, doc) token-id pairs in one forward.
    Returns (P,) f32 logits; callers mask empty slots."""
    p = pair_q.shape[0]
    pair_ids, pair_types, pair_mask = _assemble_pairs(
        pair_q, pair_d, rerank_cfg=rerank_cfg
    )
    hh = rerank_model.encode(pair_ids, pair_types, pair_mask)
    return _pair_head(rerank_model, hh, p)


def _gather_pairs(q_ids: torch.Tensor, rows: torch.Tensor, doc_tokens: torch.Tensor):
    """Stage 3: candidate token ids from the device token store, laid out
    as (B*K, LQ) query and (B*K, DLEN) doc ids.  Empty slots (-1) clamp
    to row 0 and are masked by the caller."""
    b, lq = q_ids.shape
    k = rows.shape[1]
    dtok = doc_tokens[rows.clamp_min(0).long()]  # (B, K, DLEN)
    pair_q = q_ids[:, None, :].expand(b, k, lq).reshape(b * k, lq)
    return pair_q, dtok.reshape(b * k, -1)


def _mask_empty(logits, rows, bi_scores):
    # hide rerank logits for empty slots (bi score == -inf or row == -1)
    keep = torch.isfinite(bi_scores) & (rows >= 0)
    return torch.where(keep, logits, torch.full_like(logits, float("-inf")))


def _cross_rerank(
    rerank_model: bert.BertModel,
    q_ids: torch.Tensor,       # (B, LQ)
    rows: torch.Tensor,        # (B, K) int32 candidate rows (-1 = empty)
    bi_scores: torch.Tensor,   # (B, K) f32 (-inf = empty)
    doc_tokens: torch.Tensor,  # (N, DLEN)
    *,
    rerank_cfg: bert.BertConfig,
) -> torch.Tensor:
    """Stages 3+4: gather candidate token ids on the device and
    cross-encode all B*K pairs in one forward.  Returns (B, K) logits
    with empty slots masked to -inf."""
    b, k = rows.shape
    pair_q, pair_d = _gather_pairs(q_ids, rows, doc_tokens)
    logits = _cross_encode_pairs(
        rerank_model, pair_q, pair_d, rerank_cfg=rerank_cfg
    ).reshape(b, k)
    return _mask_empty(logits, rows, bi_scores)


@torch.inference_mode()
def fused_two_stage(
    embed_model: bert.BertModel,
    rerank_model: bert.BertModel,
    q_ids: torch.Tensor,         # (B, LQ) int32, [CLS]...[SEP] + 0-padding
    q_types: torch.Tensor,       # (B, LQ)
    q_mask: torch.Tensor,        # (B, LQ)
    query_filter: torch.Tensor,  # (B, 2) int32
    corpus_emb: torch.Tensor,    # (N, D) bf16, or int8 for a quantized index
    corpus_codes: torch.Tensor,  # (2, N) int32
    doc_tokens: torch.Tensor,    # (N, DLEN) int32, tokenized [..., SEP], 0-pad
    n_valid: int,
    *,
    rerank_cfg: bert.BertConfig,
    k: int,
):
    """Returns (rows (B,k) int32, bi_scores (B,k) f32, ce_logits (B,k) f32).
    An int8 corpus gets its query vectors quantized as its rows are."""
    qv = _embed(embed_model, q_ids, q_types, q_mask)
    q = _prep_queries(qv, corpus_emb.dtype)
    bi_scores, rows = masked_topk(q, corpus_emb, corpus_codes, query_filter, n_valid, k)
    logits = _cross_rerank(
        rerank_model, q_ids, rows, bi_scores, doc_tokens, rerank_cfg=rerank_cfg,
    )
    return rows, bi_scores, logits


@torch.inference_mode()
def fused_two_stage_prefix(
    embed_model: bert.BertModel,
    rerank_model: bert.BertModel,
    q_ids: torch.Tensor,
    q_types: torch.Tensor,
    q_mask: torch.Tensor,
    query_filter: torch.Tensor,
    corpus_emb: torch.Tensor,
    corpus_codes: torch.Tensor,
    doc_tokens: torch.Tensor,
    n_valid: int,
    *,
    rerank_cfg: bert.BertConfig,
    k: int,
    stop: str = "full",
):
    """Telescoping prefixes of :func:`fused_two_stage` for stage
    attribution: ``"embed"`` returns the (B, D) query vectors;
    ``"search"`` (rows, bi); ``"gather"`` (rows, a checksum of the
    gathered pair block); ``"layers"`` (rows, the (B, K) CLS column sum);
    ``"full"`` the same as :func:`fused_two_stage`.  Each prefix reuses
    the exact helpers of the full path, so the difference of two
    consecutive prefixes' times is that stage's cost."""
    qv = _embed(embed_model, q_ids, q_types, q_mask)
    if stop == "embed":
        return qv
    q = _prep_queries(qv, corpus_emb.dtype)
    bi, rows = masked_topk(q, corpus_emb, corpus_codes, query_filter, n_valid, k)
    if stop == "search":
        return rows, bi
    b = q_ids.shape[0]
    pair_q, pair_d = _gather_pairs(q_ids, rows, doc_tokens)
    pair_ids, pair_types, pair_mask = _assemble_pairs(
        pair_q, pair_d, rerank_cfg=rerank_cfg
    )
    if stop == "gather":
        chk = (
            pair_ids[: b * k].reshape(b, -1).sum(dim=1)
            + pair_types[: b * k].reshape(b, -1).sum(dim=1)
            + pair_mask[: b * k].reshape(b, -1).sum(dim=1)
        )
        return rows, chk
    hh = rerank_model.encode(pair_ids, pair_types, pair_mask)
    if stop == "layers":
        return rows, hh[:, 0, :].sum(dim=-1)[: b * k].reshape(b, k)
    logits = _pair_head(rerank_model, hh, b * k).reshape(b, k)
    return rows, bi, _mask_empty(logits, rows, bi)


def make_fused_query(rerank_cfg: bert.BertConfig, *, k: int):
    """:func:`fused_two_stage` with its static arguments bound.  The
    embedder's config rides on its model; the reranker's is passed for
    its trained-length hint (``max_seq_length``)."""
    return functools.partial(fused_two_stage, rerank_cfg=rerank_cfg, k=k)


# ---------------------------------------------------------------------------
# fused IVF tier: embed -> centroid probe -> probed-tiles kernel -> rerank
# ---------------------------------------------------------------------------


def _probe_tiles(
    q: torch.Tensor,           # (B, D) corpus-representation queries
    centroids: torch.Tensor,   # (K_cl, D)
    *,
    nprobe: int,
    tiles_per_cluster: int,
    num_tiles: int,
) -> torch.Tensor:
    """Batch-union probed tile ids, -1 padded to the budget the batch
    size fixes — the same list ``IVFIndex.search_device`` probes."""
    budget = min(num_tiles, q.shape[0] * nprobe * tiles_per_cluster)
    return probe_tile_list(
        q, centroids, nprobe=nprobe, tpc=tiles_per_cluster, budget=budget
    )


@torch.inference_mode()
def fused_ivf_two_stage(
    embed_model: bert.BertModel,
    rerank_model: bert.BertModel,
    q_ids: torch.Tensor,         # (B, LQ) int32
    q_types: torch.Tensor,       # (B, LQ)
    q_mask: torch.Tensor,        # (B, LQ)
    query_filter: torch.Tensor,  # (B, 2) int32
    centroids: torch.Tensor,     # (K_cl, D)
    packed_emb: torch.Tensor,    # (K_cl*C_max, D) cluster-major packing
    packed_codes: torch.Tensor,  # (2, K_cl*C_max)
    packed_gids: torch.Tensor,   # (1, K_cl*C_max) original row ids, -1 pad
    doc_tokens: torch.Tensor,    # (N, DLEN) flat-index token store
    *,
    rerank_cfg: bert.BertConfig,
    k: int,
    tile: int,
    nprobe: int,
    tiles_per_cluster: int,
):
    """The sub-linear twin of :func:`fused_two_stage`: the flat masked
    top-k is replaced by centroid probing and the probed-tiles kernel
    (index/ivf.py), queued on the device with no host sync.  Returns
    (rows, bi, ce, active_tiles): ``active_tiles`` is the 0-d int32 count
    of probed tiles, for the caller's one readback.  An int8 packing
    keeps bf16 centroids."""
    qv = _embed(embed_model, q_ids, q_types, q_mask)
    q = _prep_queries(qv, packed_emb.dtype)
    tile_ids = _probe_tiles(
        q, centroids, nprobe=nprobe, tiles_per_cluster=tiles_per_cluster,
        num_tiles=packed_emb.shape[0] // tile,
    )
    bi_scores, rows = ivf_probe(
        q, query_filter, packed_emb, packed_codes, packed_gids, tile_ids, k,
        tile=tile,
    )
    logits = _cross_rerank(
        rerank_model, q_ids, rows, bi_scores, doc_tokens, rerank_cfg=rerank_cfg,
    )
    return rows, bi_scores, logits, (tile_ids >= 0).sum().to(torch.int32)


def make_fused_ivf_query(
    rerank_cfg: bert.BertConfig,
    *,
    k: int,
    tile: int,
    nprobe: int,
    tiles_per_cluster: int,
):
    """:func:`fused_ivf_two_stage` with the IVF geometry bound."""
    return functools.partial(
        fused_ivf_two_stage, rerank_cfg=rerank_cfg, k=k, tile=tile,
        nprobe=nprobe, tiles_per_cluster=tiles_per_cluster,
    )


# ---------------------------------------------------------------------------
# fused HNSW tier: embed -> pool routing -> descent -> graph walk -> rerank
# ---------------------------------------------------------------------------


@torch.inference_mode()
def fused_hnsw_two_stage(
    embed_model: bert.BertModel,
    rerank_model: bert.BertModel,
    q_ids: torch.Tensor,         # (B, LQ) int32
    q_types: torch.Tensor,       # (B, LQ)
    q_mask: torch.Tensor,        # (B, LQ)
    query_filter: torch.Tensor,  # (B, 2) int32
    emb: torch.Tensor,           # (cap, D) flat-index rows, bf16 or int8
    codes: torch.Tensor,         # (2, cap) int32
    adj_pad: torch.Tensor,       # (pad_id+1, 2M) int32 level-0 adjacency
    entries: torch.Tensor,       # (E,) int32 fixed entries
    doc_tokens: torch.Tensor,    # (cap, DLEN) flat-index token store
    pool_rows: torch.Tensor | None = None,  # (P,) k-center pool, with pool_take
    hier: tuple | None = None,              # (hi_ids, hi_adj, hi_n), with descend
    *,
    rerank_cfg: bert.BertConfig,
    k: int,
    ef: int,
    steps: int,
    frontier: int,
    pad_id: int,
    descend: tuple[int, int, int] | None = None,
    pool_take: int = 0,
):
    """The graph tier's member of the fused family: the query embed, then
    the k-center pool's seeds (``pool_take`` > 0) and the descent over the
    upper levels (``descend``) where the snapshot has them, the
    ring-visited beam walk (``index/hnsw.py``), the token gather and the
    cross-encoder (pair-attention kernel), queued on the device with no
    host sync.  Returns (rows, bi, ce)."""
    from financial_rag_system_tpu_torch.index.hnsw import hnsw_routed_walk, walk_queries

    qv = _embed(embed_model, q_ids, q_types, q_mask)
    q = walk_queries(qv, emb.dtype)
    bi_scores, rows = hnsw_routed_walk(
        q, query_filter, emb, codes, adj_pad, entries, pool_rows, hier, k,
        ef=ef, steps=steps, frontier=frontier, pad_id=pad_id, take=pool_take,
        descend=descend,
    )
    logits = _cross_rerank(
        rerank_model, q_ids, rows, bi_scores, doc_tokens, rerank_cfg=rerank_cfg,
    )
    return rows, bi_scores, logits


def make_fused_hnsw_query(
    rerank_cfg: bert.BertConfig,
    *,
    k: int,
    ef: int,
    steps: int,
    frontier: int,
    pad_id: int,
    descend: tuple[int, int, int] | None = None,
    pool_take: int = 0,
):
    """:func:`fused_hnsw_two_stage` with the walk's geometry bound: the
    sentinel ``pad_id`` captured at build (the engine serves staged when
    the live snapshot's differs), the descent's (beam, steps, frontier)
    and the pool's seed count."""
    return functools.partial(
        fused_hnsw_two_stage, rerank_cfg=rerank_cfg, k=k, ef=ef, steps=steps,
        frontier=frontier, pad_id=pad_id, descend=descend, pool_take=pool_take,
    )


# ---------------------------------------------------------------------------
# the hermetic hash stack: hash bag -> top-k or probe kernel -> hash rerank
# ---------------------------------------------------------------------------


def _hash_rerank(
    rerank_table: torch.Tensor,
    q_ids: torch.Tensor,       # (B, LQ)
    q_mask: torch.Tensor,      # (B, LQ)
    rows: torch.Tensor,        # (B, K) candidate rows (-1 = empty)
    bi_scores: torch.Tensor,   # (B, K)
    doc_tokens: torch.Tensor,  # (N, DLEN), [... SEP] 0-padded (no CLS)
) -> torch.Tensor:
    """Second-stage hash rerank with the reranker's de-aliased table (JAX
    ``fused_query.py:55-78``): a leading CLS column makes each candidate's
    bag match ``HashEmbedder.encode``'s [CLS] ... [SEP] token stream.
    Returns (B, K) cosines, -inf in empty slots."""
    b, k = rows.shape
    dtok = doc_tokens[rows.clamp_min(0).long()]  # (B, K, DLEN)
    cls = torch.full((b, k, 1), CLS_ID, dtype=dtok.dtype, device=dtok.device)
    d_ids = torch.cat([cls, dtok], dim=2)
    dvec = _hash_embed(rerank_table, d_ids, d_ids != 0)  # (B, K, D)
    qvec = _hash_embed(rerank_table, q_ids, q_mask)      # (B, D)
    ce = torch.einsum("bkd,bd->bk", dvec, qvec)
    return _mask_empty(ce, rows, bi_scores)


@torch.inference_mode()
def fused_hash_query(
    table: torch.Tensor,         # (V, D) hash embedding table
    q_ids: torch.Tensor,         # (B, L) int32
    q_mask: torch.Tensor,        # (B, L)
    query_filter: torch.Tensor,  # (B, 2) int32
    corpus_emb: torch.Tensor,
    corpus_codes: torch.Tensor,
    n_valid: int,
    *,
    k: int,
):
    """Embed and search for the hash stack: the query bag, then the masked
    top-k kernel.  Returns (qv, scores, rows)."""
    qv = _hash_embed(table, q_ids, q_mask)
    q = _prep_queries(qv, corpus_emb.dtype)
    scores, rows = masked_topk(q, corpus_emb, corpus_codes, query_filter, n_valid, k)
    return qv, scores, rows


@torch.inference_mode()
def fused_hash_rerank_query(
    table: torch.Tensor,         # (V, D) retrieval hash table
    rerank_table: torch.Tensor,  # (V, Dr) de-aliased reranker hash table
    q_ids: torch.Tensor,
    q_mask: torch.Tensor,
    query_filter: torch.Tensor,
    corpus_emb: torch.Tensor,
    corpus_codes: torch.Tensor,
    doc_tokens: torch.Tensor,    # (N, DLEN) device token store
    n_valid: int,
    *,
    k: int,
):
    """The hash stack with its de-aliased second stage over the gathered
    token-store rows.  Returns (qv, bi_scores, rows, ce)."""
    qv, bi, rows = fused_hash_query(
        table, q_ids, q_mask, query_filter, corpus_emb, corpus_codes, n_valid, k=k,
    )
    ce = _hash_rerank(rerank_table, q_ids, q_mask, rows, bi, doc_tokens)
    return qv, bi, rows, ce


def make_fused_hash_query(*, k: int, rerank: bool = False):
    """:func:`fused_hash_query`, or with ``rerank``
    :func:`fused_hash_rerank_query`, with ``k`` bound."""
    return functools.partial(
        fused_hash_rerank_query if rerank else fused_hash_query, k=k
    )


@torch.inference_mode()
def fused_ivf_hash_query(
    table: torch.Tensor,
    q_ids: torch.Tensor,
    q_mask: torch.Tensor,
    query_filter: torch.Tensor,
    centroids: torch.Tensor,
    packed_emb: torch.Tensor,
    packed_codes: torch.Tensor,
    packed_gids: torch.Tensor,
    *,
    k: int,
    tile: int,
    nprobe: int,
    tiles_per_cluster: int,
):
    """IVF probing for the hash stack: the query bag, the centroid probe
    and the probed-tiles kernel.  Returns (qv, scores, rows,
    active_tiles), the last as :func:`fused_ivf_two_stage` gives it."""
    qv = _hash_embed(table, q_ids, q_mask)
    q = _prep_queries(qv, packed_emb.dtype)
    tile_ids = _probe_tiles(
        q, centroids, nprobe=nprobe, tiles_per_cluster=tiles_per_cluster,
        num_tiles=packed_emb.shape[0] // tile,
    )
    scores, rows = ivf_probe(
        q, query_filter, packed_emb, packed_codes, packed_gids, tile_ids, k,
        tile=tile,
    )
    return qv, scores, rows, (tile_ids >= 0).sum().to(torch.int32)


@torch.inference_mode()
def fused_ivf_hash_rerank_query(
    table: torch.Tensor,
    rerank_table: torch.Tensor,
    q_ids: torch.Tensor,
    q_mask: torch.Tensor,
    query_filter: torch.Tensor,
    centroids: torch.Tensor,
    packed_emb: torch.Tensor,
    packed_codes: torch.Tensor,
    packed_gids: torch.Tensor,
    doc_tokens: torch.Tensor,   # (N, DLEN) flat-index token store (global rows)
    *,
    k: int,
    tile: int,
    nprobe: int,
    tiles_per_cluster: int,
):
    """IVF probing and the de-aliased hash rerank (probe rows are global
    flat ids, so they gather the flat token store directly).  Returns
    (qv, bi, rows, ce, active_tiles)."""
    qv, bi, rows, active = fused_ivf_hash_query(
        table, q_ids, q_mask, query_filter, centroids, packed_emb,
        packed_codes, packed_gids, k=k, tile=tile, nprobe=nprobe,
        tiles_per_cluster=tiles_per_cluster,
    )
    ce = _hash_rerank(rerank_table, q_ids, q_mask, rows, bi, doc_tokens)
    return qv, bi, rows, ce, active


def make_fused_ivf_hash_query(
    *, k: int, tile: int, nprobe: int, tiles_per_cluster: int, rerank: bool = False,
):
    """:func:`fused_ivf_hash_query`, or with ``rerank``
    :func:`fused_ivf_hash_rerank_query`, with the IVF geometry bound."""
    return functools.partial(
        fused_ivf_hash_rerank_query if rerank else fused_ivf_hash_query,
        k=k, tile=tile, nprobe=nprobe, tiles_per_cluster=tiles_per_cluster,
    )


# ---------------------------------------------------------------------------
# the corpus-sharded mesh: per-shard search, merge, work-balanced rerank
# ---------------------------------------------------------------------------
#
# JAX runs these programs once per device under ``shard_map``; the port
# embeds the batch once on the mesh's home device (every JAX device
# computes the same replicated value), runs each shard's search on its
# device, merges the (B, k) partials (index/sharded.py merge_partials)
# and reranks the merged set work-balanced.  The models live on the home
# device, so every shard's rerank chunk runs there.


def _shard_search(mesh, q, qf, search):
    """``search(i, q_dev, qf_dev) -> (bi, global rows)`` on each local
    shard's device, rows of non-finite scores set to -1 (JAX's
    ``isfinite`` guard).  Returns the per-shard lists (bi, rows)."""
    bi_parts, row_parts = [], []
    for i, dev in enumerate(mesh.devices):
        bi, rows = search(i, q.to(dev), qf.to(dev))
        bi_parts.append(bi)
        row_parts.append(torch.where(torch.isfinite(bi), rows, -1))
    return bi_parts, row_parts


def _sharded_balanced_rerank(
    mesh,
    rerank_model: bert.BertModel,
    q_ids: torch.Tensor,     # (B, LQ) query token ids
    g_rows: torch.Tensor,    # (B, k) GLOBAL candidate rows after the merge
    top_bi: torch.Tensor,    # (B, k) merged bi scores (-inf = empty)
    dtok_shards,             # this process's (rows_per_shard, DLEN) token stores
    *,
    rows_per_shard: int,
    rerank_cfg: bert.BertConfig,
) -> torch.Tensor:
    """Work-balanced cross-encoder rerank for corpus-sharded meshes (JAX
    ``fused_query.py:198-254``).

    The merged global top-k is the only pair set that needs stage-2
    scores, but its rows live on whichever shards own them (shard ``s``
    owns global rows ``[s * rows_per_shard, ...)``):

      1. token fetch: each shard contributes the (B, k, DLEN) rows it
         owns (zeros elsewhere); one ``psum`` (exact on int32) gives the
         whole candidate token block;
      2. balanced split: global shard ``s`` cross-encodes pairs
         ``[s * chunk, (s + 1) * chunk)``, ``chunk = ceil(B * k / S)``,
         of the flattened pair batch (clipped duplicates pad the last
         chunk), then one all-gather reassembles the logits.

    Returns (B, k) logits with empty slots masked to -inf."""
    b, k = g_rows.shape
    parts = []
    for i, dev in enumerate(mesh.devices):
        dtok = dtok_shards[i]
        rows = g_rows.to(dev)
        local = torch.where(rows >= 0, rows - mesh.shard_index(i) * rows_per_shard, -1)
        own = (local >= 0) & (local < dtok.shape[0])
        safe = local.clamp(0, dtok.shape[0] - 1).long()
        parts.append(torch.where(own[..., None], dtok[safe], 0))
    g_dtok = psum(mesh, parts).to(q_ids.device).reshape(b * k, -1)  # replicated
    p = b * k
    chunk = -(-p // mesh.shape[AXIS_CORPUS])
    logits = []
    for i in range(len(mesh.devices)):
        idx = (mesh.shard_index(i) * chunk
               + torch.arange(chunk, device=q_ids.device)).clamp(0, p - 1)
        logits.append(_cross_encode_pairs(
            rerank_model, q_ids[idx // k], g_dtok[idx], rerank_cfg=rerank_cfg))
    ce = all_gather(mesh, logits, dim=0)[:p].reshape(b, k).to(top_bi.device)
    return _mask_empty(ce, g_rows, top_bi)


@torch.inference_mode()
def sharded_fused_two_stage(
    mesh,
    embed_model: bert.BertModel,
    rerank_model: bert.BertModel,
    q_ids: torch.Tensor,
    q_types: torch.Tensor,
    q_mask: torch.Tensor,
    query_filter: torch.Tensor,
    emb_shards,       # this process's (P, D) row blocks
    codes_shards,     # their (2, P) codes
    dtok_shards,      # their (P, DLEN) token stores
    n_valid: int,
    *,
    rerank_cfg: bert.BertConfig,
    k: int,
):
    """The fused two-stage pipeline over a corpus-sharded mesh (JAX
    ``make_sharded_fused_query``): embed, kernel 1 on every shard with
    ``local_valid = clamp(n_valid - base, 0, P)``, the merge of the
    (B, k) partials (exactly the single-device retrieve-15 set), then the
    work-balanced rerank.  Returns (rows, bi, ce)."""
    p = emb_shards[0].shape[0]
    q = _prep_queries(_embed(embed_model, q_ids, q_types, q_mask), emb_shards[0].dtype)

    def search(i, q_dev, qf_dev):
        base = mesh.shard_index(i) * p
        bi, rows = masked_topk(q_dev, emb_shards[i], codes_shards[i], qf_dev,
                               min(max(n_valid - base, 0), p), k)
        return bi, rows + base

    top_bi, rows = merge_partials(mesh, *_shard_search(mesh, q, query_filter, search), k)
    ce = _sharded_balanced_rerank(mesh, rerank_model, q_ids, rows, top_bi, dtok_shards,
                                  rows_per_shard=p, rerank_cfg=rerank_cfg)
    return rows, top_bi, ce


def make_sharded_fused_query(mesh, rerank_cfg: bert.BertConfig, *, k: int):
    """:func:`sharded_fused_two_stage` with the mesh and ``k`` bound."""
    return functools.partial(sharded_fused_two_stage, mesh, rerank_cfg=rerank_cfg, k=k)


@torch.inference_mode()
def sharded_fused_ivf_two_stage(
    mesh,
    embed_model: bert.BertModel,
    rerank_model: bert.BertModel,
    q_ids: torch.Tensor,
    q_types: torch.Tensor,
    q_mask: torch.Tensor,
    query_filter: torch.Tensor,
    centroids: torch.Tensor,  # (K_cl, D) replicated codebook
    packed_emb,               # this process's (K_cl * C_max, D) packings
    packed_codes,             # their (2, K_cl * C_max) codes
    packed_gids,              # their (1, K_cl * C_max) GLOBAL rows, -1 pad
    dtok_shards,              # the flat index's (P, DLEN) token stores
    *,
    rerank_cfg: bert.BertConfig,
    k: int,
    tile: int,
    nprobe: int,
    tiles_per_cluster: int,
    rows_per_shard: int,
):
    """The sub-linear fused pipeline over a corpus-sharded mesh (JAX
    ``make_sharded_fused_ivf_query``): one probe list from the replicated
    centroids indexes every shard's packing alike, kernel 3 on each
    shard, the merge, then the work-balanced rerank (a shard's packed
    rows all live in its block of ``rows_per_shard`` flat rows, so
    ownership is the block test).  ``rows_per_shard`` is captured at
    build: the engine serves staged when the flat index grew.  Returns
    (rows, bi, ce, active_tiles), the last the 0-d count of probed
    tiles."""
    q = _prep_queries(_embed(embed_model, q_ids, q_types, q_mask), packed_emb[0].dtype)
    tile_ids = _probe_tiles(
        q, centroids, nprobe=nprobe, tiles_per_cluster=tiles_per_cluster,
        num_tiles=packed_emb[0].shape[0] // tile,
    )

    def search(i, q_dev, qf_dev):
        return ivf_probe(q_dev, qf_dev, packed_emb[i], packed_codes[i], packed_gids[i],
                         tile_ids.to(q_dev.device), k, tile=tile)

    top_bi, rows = merge_partials(mesh, *_shard_search(mesh, q, query_filter, search),
                                  k)
    ce = _sharded_balanced_rerank(mesh, rerank_model, q_ids, rows, top_bi, dtok_shards,
                                  rows_per_shard=rows_per_shard, rerank_cfg=rerank_cfg)
    return rows, top_bi, ce, (tile_ids >= 0).sum().to(torch.int32)


def make_sharded_fused_ivf_query(
    mesh, rerank_cfg: bert.BertConfig, *, k: int, tile: int, nprobe: int,
    tiles_per_cluster: int, rows_per_shard: int,
):
    """:func:`sharded_fused_ivf_two_stage` with the mesh and geometry bound."""
    return functools.partial(
        sharded_fused_ivf_two_stage, mesh, rerank_cfg=rerank_cfg, k=k, tile=tile,
        nprobe=nprobe, tiles_per_cluster=tiles_per_cluster, rows_per_shard=rows_per_shard,
    )


@torch.inference_mode()
def sharded_fused_hnsw_two_stage(
    mesh,
    embed_model: bert.BertModel,
    rerank_model: bert.BertModel,
    q_ids: torch.Tensor,
    q_types: torch.Tensor,
    q_mask: torch.Tensor,
    query_filter: torch.Tensor,
    emb_shards,       # this process's (P, D) row blocks
    codes_shards,     # their (2, P) codes
    adj_shards,       # their (P + 1, 2M) level-0 adjacencies, sentinel P
    entry_shards,     # their (E,) fixed entries
    dtok_shards,      # their (P, DLEN) token stores
    pool_shards=None,  # their (P',) k-center pools, with pool_take
    *,
    rerank_cfg: bert.BertConfig,
    k: int,
    ef: int,
    steps: int,
    frontier: int,
    per_shard: int,
    pool_take: int = 0,
):
    """The sharded graph tier (JAX ``make_sharded_fused_hnsw_query``):
    each shard walks ITS graph over its rows, seeded by its own pool,
    then the merge and the work-balanced rerank (walk ids are
    shard-local, the same block as the shard's token store).  Returns
    (rows, bi, ce)."""
    from financial_rag_system_tpu_torch.index.hnsw import hnsw_routed_walk, walk_queries

    q = walk_queries(_embed(embed_model, q_ids, q_types, q_mask), emb_shards[0].dtype)

    def search(i, q_dev, qf_dev):
        bi, rows = hnsw_routed_walk(
            q_dev, qf_dev, emb_shards[i], codes_shards[i], adj_shards[i], entry_shards[i],
            pool_shards[i] if pool_take > 0 else None, None, k, ef=ef, steps=steps,
            frontier=frontier, pad_id=per_shard, take=pool_take,
        )
        return bi, torch.where(rows >= 0, rows + mesh.shard_index(i) * per_shard, -1)

    top_bi, rows = merge_partials(mesh, *_shard_search(mesh, q, query_filter, search),
                                  k)
    ce = _sharded_balanced_rerank(mesh, rerank_model, q_ids, rows, top_bi, dtok_shards,
                                  rows_per_shard=per_shard, rerank_cfg=rerank_cfg)
    return rows, top_bi, ce


def make_sharded_fused_hnsw_query(
    mesh, rerank_cfg: bert.BertConfig, *, k: int, ef: int, steps: int, frontier: int,
    per_shard: int, pool_take: int = 0,
):
    """:func:`sharded_fused_hnsw_two_stage` with the mesh and the walk's
    geometry bound (``per_shard`` is the sentinel and the id stride)."""
    return functools.partial(
        sharded_fused_hnsw_two_stage, mesh, rerank_cfg=rerank_cfg, k=k, ef=ef, steps=steps,
        frontier=frontier, per_shard=per_shard, pool_take=pool_take,
    )


@torch.inference_mode()
def sharded_fused_hash_query(
    mesh,
    table: torch.Tensor,
    *args,
    k: int,
    rerank: bool = False,
):
    """The hash stack over a corpus-sharded mesh (JAX
    ``make_sharded_fused_hash_query``): the query bag, kernel 1 on every
    shard and, with ``rerank``, the de-aliased hash rerank of each
    shard's local candidates over its own token store; the merge carries
    the rerank scores with the candidates.  ``args`` are ``[rerank_table,]
    q_ids, q_mask, query_filter, emb_shards, codes_shards[, dtok_shards],
    n_valid``.  Returns (qv, bi, rows[, ce]), the order of
    :func:`fused_hash_query` and :func:`fused_hash_rerank_query`."""
    if rerank:
        rerank_table, q_ids, q_mask, qf, emb_shards, codes_shards, dtok_shards, n_valid = args
    else:
        q_ids, q_mask, qf, emb_shards, codes_shards, n_valid = args
    p = emb_shards[0].shape[0]
    qv = _hash_embed(table, q_ids, q_mask)
    q = _prep_queries(qv, emb_shards[0].dtype)
    ce_parts = []

    def search(i, q_dev, qf_dev):
        base = mesh.shard_index(i) * p
        bi, rows = masked_topk(q_dev, emb_shards[i], codes_shards[i], qf_dev,
                               min(max(n_valid - base, 0), p), k)
        if rerank:
            dev = q_dev.device
            ce_parts.append(_hash_rerank(rerank_table.to(dev), q_ids.to(dev), q_mask.to(dev),
                                         rows, bi, dtok_shards[i]))
        return bi, rows + base

    bi_parts, row_parts = _shard_search(mesh, q, qf, search)
    out = merge_partials(mesh, bi_parts, row_parts, k, *([ce_parts] if rerank else []))
    return (qv, *out)


def make_sharded_fused_hash_query(mesh, *, k: int, rerank: bool = False):
    """:func:`sharded_fused_hash_query` with the mesh, ``k`` and
    ``rerank`` bound."""
    return functools.partial(sharded_fused_hash_query, mesh, k=k, rerank=rerank)
