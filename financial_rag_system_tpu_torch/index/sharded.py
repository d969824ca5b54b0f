"""Mesh-sharded corpus search: per-shard top-k + all-gather merge.

Port of ``financial_rag_system_tpu/index/sharded.py``.  Corpus rows shard
across the ``corpus`` axis of a :class:`parallel.mesh.Mesh` in JAX's
block layout: shard ``s`` owns global rows ``[s * P, (s + 1) * P)``,
``P = capacity / S`` a multiple of the tile.  Each shard keeps its own
contiguous tensors — ``emb (P, D)``, ``codes (2, P)``, ``dtok (P, L)``,
each 16-byte aligned as kernel 1 takes them (a column slice of one
``(2, N)`` tensor would be neither) — on its mesh device.  A search runs
the masked top-k (kernel 1 on the card) on every shard with
``local_valid = clamp(n_valid - base, 0, P)``, offsets the local ids to
global rows, all-gathers the ``(B, k)`` partials in shard order and
merges them with the stable descending sort of ``lax.top_k``: equal
scores go to the lower shard, so the lower global row, and empty slots
stay ``-inf / -1``.

Capacity grows by doubling the rows a shard (the block geometry
changes, so the rows redistribute); persistence is the JAX package's
``sharded_index.npz`` (mesh-shape independent: re-padded on load when
the shard count changed) plus ``store.json``, written by rank 0 after
every process joined the gather.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch

from financial_rag_system_tpu_torch.index.base import SearchMixin
from financial_rag_system_tpu_torch.index.flat import (
    DEFAULT_TOKEN_STORE_MAX,
    _round_up,
    auto_token_width,
    quantize_int8,
)
from financial_rag_system_tpu_torch.index.store import PAD_CODE, DocumentStore
from financial_rag_system_tpu_torch.ops.topk import masked_topk
from financial_rag_system_tpu_torch.parallel.collectives import all_gather, psum
from financial_rag_system_tpu_torch.parallel.mesh import AXIS_CORPUS, Mesh

DEFAULT_TILE = 1024


def merge_partials(mesh: Mesh, scores: list[torch.Tensor], ids: list[torch.Tensor],
                   k: int, *extras: list[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """The replicated global merge of per-shard (B, k) partials with
    global ids: all-gather along the candidates, then the top k by a
    stable descending sort (``lax.top_k``'s ties: the lower shard).
    Slots whose score is not finite come out as -1.  Each of ``extras``
    (per-shard (B, k) values riding with the candidates) is gathered and
    taken at the same positions."""
    all_s = all_gather(mesh, scores, dim=1)
    top_s, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
    top_s, pos = top_s[:, :k], pos[:, :k]
    top_i = torch.gather(all_gather(mesh, ids, dim=1), 1, pos)
    top_i = torch.where(torch.isfinite(top_s), top_i, -1).to(torch.int32)
    return (top_s, top_i,
            *(torch.gather(all_gather(mesh, x, dim=1), 1, pos) for x in extras))


def block(full, lo: int, rows: int, *, fill, dtype: torch.dtype,
          device: torch.device, dim: int = 0) -> torch.Tensor:
    """Rows ``[lo, lo + rows)`` of ``full`` (a tensor or a numpy array)
    along ``dim`` as a new contiguous tensor on ``device``, ``fill`` past
    the end of ``full``."""
    full = torch.as_tensor(full)
    shape = list(full.shape)
    shape[dim] = rows
    out = torch.full(shape, fill, dtype=dtype, device=device)
    have = max(0, min(rows, full.shape[dim] - lo))
    if have:
        out.narrow(dim, 0, have).copy_(full.narrow(dim, lo, have))
    return out


class ShardedFlatIndex(SearchMixin):
    """Exact search over a corpus sharded across the mesh's corpus axis.

    Host-side bookkeeping matches FlatIndex (same DocumentStore
    contract); the device tensors live in ONE tuple ``(emb, codes,
    dtok)`` of per-shard tuples, swapped as a unit, so a concurrent
    reader never pairs a grown emb with an ungrown codes."""

    def __init__(
        self,
        mesh: Mesh,
        dim: int = 384,
        *,
        capacity: int = 1 << 15,
        tile: int = DEFAULT_TILE,
        dtype: torch.dtype = torch.bfloat16,
        token_store_len: int | str | None = None,
        tokenizer=None,
        token_store_max: int | None = None,
    ):
        if dtype not in (torch.bfloat16, torch.int8):
            raise ValueError(f"ShardedFlatIndex stores bf16 or int8 rows, not {dtype}")
        self.mesh = mesh
        self.device = mesh.home
        self.dim = dim
        self.tile = tile
        self.dtype = dtype
        self.quantized = dtype == torch.int8
        self.n_shards = mesh.shape[AXIS_CORPUS]
        per_shard = _round_up(max(capacity // self.n_shards, tile), tile)
        self.capacity = per_shard * self.n_shards
        self.store = DocumentStore()
        # auto mode mirrors FlatIndex: materialize at the measured p99
        # width on the first upsert, widen in 32-token steps
        # (deterministic in the upsert stream, so op-broadcast lockstep
        # holds)
        self._auto_dlen = token_store_len == "auto" and tokenizer is not None
        if token_store_len == "auto":
            token_store_len = None
        self.token_store_len = token_store_len
        self.token_store_max = token_store_max or DEFAULT_TOKEN_STORE_MAX
        self._tok_lengths: list[int] = []
        self.tokenizer = tokenizer
        self._arrays = (
            self._blocks(np.zeros((0, dim), np.float32), per_shard, 0, dtype),
            self._blocks(np.zeros((2, 0), np.int32), per_shard, PAD_CODE, torch.int32, dim=1),
            self._blocks(np.zeros((0, token_store_len), np.int32), per_shard, 0, torch.int32)
            if token_store_len else None,
        )

    def _blocks(self, full, per_shard: int, fill, dtype, dim: int = 0) -> tuple:
        """This process's shards of the global ``full`` at ``per_shard``
        rows a shard."""
        return tuple(
            block(full, self.mesh.shard_index(i) * per_shard, per_shard, fill=fill,
                  dtype=dtype, device=dev, dim=dim)
            for i, dev in enumerate(self.mesh.devices)
        )

    # -- device-array views (see _arrays) ---------------------------------
    @property
    def _emb(self) -> tuple:
        return self._arrays[0]

    @property
    def _codes(self) -> tuple:
        return self._arrays[1]

    @property
    def _doc_tok(self):
        return self._arrays[2]

    @property
    def per_shard(self) -> int:
        return self.capacity // self.n_shards

    def shard_base(self, local: int) -> int:
        """First global row of this process's ``local``-th shard."""
        return self.mesh.shard_index(local) * self.per_shard

    # ------------------------------------------------------------------
    @property
    def n_valid(self) -> int:
        return len(self.store)

    @property
    def token_store_enabled(self) -> bool:
        """See FlatIndex.token_store_enabled."""
        return self._doc_tok is not None or self._auto_dlen

    def gathered(self, part: int, dim: int = 0) -> torch.Tensor:
        """The global (capacity, ...) tensor of ``_arrays[part]`` on the
        home device (a cross-process gather: every process calls it)."""
        return all_gather(self.mesh, list(self._arrays[part]), dim=dim)

    def _grown(self, arrays, needed: int):
        """Grown copies of ``arrays`` (no attribute mutation — the caller
        swaps the full tuple once).  The block geometry changes, so every
        process gathers the global rows and takes its new blocks."""
        per_shard = self.per_shard
        while per_shard * self.n_shards < needed:
            per_shard *= 2
        emb = all_gather(self.mesh, list(arrays[0]))
        codes = all_gather(self.mesh, list(arrays[1]), dim=1)
        dtok = all_gather(self.mesh, list(arrays[2])) if arrays[2] is not None else None
        self.capacity = per_shard * self.n_shards
        return (
            self._blocks(emb, per_shard, 0, self.dtype),
            self._blocks(codes, per_shard, PAD_CODE, torch.int32, dim=1),
            self._blocks(dtok, per_shard, 0, torch.int32) if dtok is not None else None,
        )

    def upsert(
        self,
        ids: Sequence[str],
        vectors: np.ndarray,
        texts: Sequence[str],
        payloads: Sequence[dict[str, Any]],
    ) -> int:
        if not len(ids) == len(vectors) == len(texts) == len(payloads):
            raise ValueError("ids/vectors/texts/payloads length mismatch")
        if not len(ids):
            return 0
        vecs = np.asarray(vectors, np.float32)
        vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12)
        rows, code_rows, new_count = [], [], 0
        for pid, text, payload in zip(ids, texts, payloads):
            row, is_new = self.store.upsert(pid, text, payload)
            new_count += is_new
            rows.append(row)
            code_rows.append(self.store.codes_for(payload))
        arrays = self._arrays
        if len(self.store) > self.capacity:
            arrays = self._grown(arrays, len(self.store))
        emb, codes, dtok = arrays
        tok_rows = None
        if self.tokenizer is not None and (dtok is not None or self._auto_dlen):
            from financial_rag_system_tpu_torch.models.tokenizer import SEP_ID

            tok_lists = [self.tokenizer.tokenize_ids(t) for t in texts]
            if self._auto_dlen:
                dtok = self._autosized_dtok(dtok, [len(t) + 1 for t in tok_lists])
            dlen = self.token_store_len
            tok_rows = np.zeros((len(texts), dlen), np.int32)
            for i, tids in enumerate(tok_lists):
                tids = tids[: dlen - 1] + [SEP_ID]
                tok_rows[i, : len(tids)] = tids
        new_emb = torch.as_tensor(vecs)
        new_emb = quantize_int8(new_emb) if self.quantized else new_emb.to(self.dtype)
        new_codes = torch.as_tensor(np.asarray(code_rows, np.int32).T.copy())
        rows_a = np.asarray(rows, np.int64)
        p = self.per_shard
        # each shard writes the rows it owns, in place
        for i, dev in enumerate(self.mesh.devices):
            base = self.shard_base(i)
            sel = np.nonzero((rows_a >= base) & (rows_a < base + p))[0]
            if not sel.size:
                continue
            local = torch.as_tensor(rows_a[sel] - base, device=dev)
            sel_t = torch.as_tensor(sel)
            emb[i][local] = new_emb[sel_t].to(dev)
            codes[i][:, local] = new_codes[:, sel_t].to(dev)
            if tok_rows is not None:
                dtok[i][local] = torch.as_tensor(tok_rows[sel]).to(dev)
        self._arrays = (emb, codes, dtok)  # one swap
        return new_count

    def _autosized_dtok(self, dtok, lengths: list[int]):
        """Auto token store: returns the (possibly freshly materialized or
        widened) shard tuple WITHOUT touching ``self._arrays`` — the
        caller owns the single swap.  Same policy as
        FlatIndex._autosize_token_store."""
        self._tok_lengths.extend(lengths)
        want = auto_token_width(self._tok_lengths, cap=self.token_store_max)
        cur = self.token_store_len or 0
        if dtok is None:
            self.token_store_len = want
            return self._blocks(np.zeros((0, want), np.int32), self.per_shard, 0, torch.int32)
        if want <= cur:
            return dtok
        new_w = min(_round_up(want, 32), self.token_store_max)
        if new_w <= cur:
            return dtok
        from financial_rag_system_tpu_torch.models.tokenizer import SEP_ID

        self.token_store_len = new_w
        rebuilt = np.zeros((self.n_valid, new_w), np.int32)
        for r in range(self.n_valid):
            tids = self.tokenizer.tokenize_ids(self.store.texts[r])[: new_w - 1] + [SEP_ID]
            rebuilt[r, : len(tids)] = tids
        # every process rebuilds from identical host texts (lockstep)
        return self._blocks(rebuilt, self.per_shard, 0, torch.int32)

    # ------------------------------------------------------------------
    def _home(self, x, dtype=None) -> torch.Tensor:
        """A query-side input (numpy from the control plane, or a tensor)
        on the home device."""
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def search_device(
        self, query_vecs, query_filter, k: int, *, host_codes=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, D) queries x (B, 2) codes -> (B, k) scores / global rows,
        replicated: kernel 1 on every shard, then the merge."""
        emb, codes, _ = self._arrays  # one snapshot
        q = self.prep_queries(self._home(query_vecs, torch.float32))
        qf = self._home(query_filter, torch.int32)
        n_valid = min(self.n_valid, self.capacity)
        p = self.per_shard
        scores, ids = [], []
        for i, dev in enumerate(self.mesh.devices):
            base = self.shard_base(i)
            s, r = masked_topk(q.to(dev), emb[i], codes[i], qf.to(dev),
                               min(max(n_valid - base, 0), p), k)
            scores.append(s)
            # -1 padding (a shard smaller than k) must not alias a real row
            ids.append(torch.where(r >= 0, r + base, -1))
        return merge_partials(self.mesh, scores, ids, k)

    def prep_queries(self, query_vecs: torch.Tensor) -> torch.Tensor:
        """Match queries to the corpus representation (a cast, or the
        rows' int8 quantization)."""
        if self.quantized:
            return quantize_int8(query_vecs)
        return query_vecs.to(self.dtype).contiguous()

    def take_rows(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(R, D) global rows and their (2, R) codes on the home device,
        for exact scoring of a row subset (index/base.py score_rows): each
        shard contributes the rows it owns, zeros elsewhere, and one
        ``psum`` (exact: bf16 and int8 values widen to f32 and int32)
        assembles them."""
        emb, codes, _ = self._arrays
        r = rows.cpu().numpy()
        p = self.per_shard
        e_parts, c_parts = [], []
        for i, dev in enumerate(self.mesh.devices):
            base = self.shard_base(i)
            sel = np.nonzero((r >= base) & (r < base + p))[0]
            wide = torch.int32 if self.quantized else torch.float32
            e = torch.zeros((len(r), self.dim), dtype=wide, device=dev)
            c = torch.zeros((2, len(r)), dtype=torch.int32, device=dev)
            if sel.size:
                sel_t = torch.as_tensor(sel, device=dev)
                local = torch.as_tensor(r[sel] - base, device=dev)
                e[sel_t] = emb[i][local].to(wide)
                c[:, sel_t] = codes[i][:, local]
            e_parts.append(e)
            c_parts.append(c)
        return psum(self.mesh, e_parts).to(self.dtype), psum(self.mesh, c_parts)

    def ticker_codes(self, n: int) -> np.ndarray:
        """(n,) host copy of the ticker codes of global rows [0, n)."""
        return self.gathered(1, dim=1)[0, :n].cpu().numpy()

    def host_rows(self, n: int) -> np.ndarray:
        """Global rows [0, n) as f32 unit vectors on the host (an int8
        index's rows divided by 127), as the native graph builder and the
        k-center pools take them."""
        vecs = self.gathered(0)[:n].float().cpu().numpy()
        return vecs / 127.0 if self.quantized else vecs

    # search()/search_batch() come from SearchMixin.

    # ------------------------------------------------------------------
    def save(self, directory: str) -> None:
        """Checkpoint is mesh-shape independent: arrays land as plain host
        npz and re-place onto whatever mesh loads them.  Under several
        processes every process joins the gather; rank 0 writes."""
        emb = self.gathered(0).float().cpu().numpy()
        codes = self.gathered(1, dim=1).cpu().numpy()
        dtok = self.gathered(2).cpu().numpy() if self._doc_tok is not None else None
        if self.mesh.rank != 0:
            return
        os.makedirs(directory, exist_ok=True)
        extra = {"dtok": dtok} if dtok is not None else {}
        # uncompressed (np.load reads either kind; the JAX package writes
        # it compressed)
        np.savez(
            os.path.join(directory, "sharded_index.npz"),
            emb=emb,
            codes=codes,
            meta=np.asarray(
                [self.dim, self.tile, self.capacity, int(self.quantized),
                 self.token_store_len or 0]
            ),
            **extra,
        )
        self.store.save(os.path.join(directory, "store.json"))

    @staticmethod
    def load(directory: str, mesh: Mesh, *, tokenizer=None) -> "ShardedFlatIndex":
        data = np.load(os.path.join(directory, "sharded_index.npz"))
        meta = [int(x) for x in data["meta"]]
        dim, tile, capacity = meta[:3]
        quantized = bool(meta[3]) if len(meta) > 3 else False
        dlen = meta[4] if len(meta) > 4 else 0
        has_dtok = dlen > 0 and "dtok" in data
        idx = ShardedFlatIndex(
            mesh, dim, capacity=capacity, tile=tile,
            dtype=torch.int8 if quantized else torch.bfloat16,
            token_store_len=dlen if has_dtok else None,
            tokenizer=tokenizer if has_dtok else None,
        )
        # a changed shard count re-pads each shard (block() fills past the
        # saved rows)
        p = idx.per_shard
        idx._arrays = (
            idx._blocks(data["emb"], p, 0, idx.dtype),
            idx._blocks(data["codes"], p, PAD_CODE, torch.int32, dim=1),
            idx._blocks(data["dtok"], p, 0, torch.int32) if has_dtok else None,
        )
        idx.store = DocumentStore.load(os.path.join(directory, "store.json"))
        return idx
