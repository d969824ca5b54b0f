"""Config / flag system.

Env-var driven, mirroring the reference's flag surface (reference
main.py:22-24, database.py:24-34, scheduler.py:14-20, ingest.py:18-19)
while adding the TPU-specific knobs (mesh shape, dtype policy, index
tier).  ``TESTING`` keeps the reference's exact semantics: the control
plane runs for real while heavy compute swaps to deterministic
stand-ins (reference tests.py:8-9, main.py:30-55).
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v not in (None, "") else default


@dataclasses.dataclass(frozen=True)
class Config:
    # --- test / execution mode ------------------------------------------
    testing: bool = False           # reference TESTING flag (tests.py:8)
    force_cpu: bool = False         # run the whole stack on host CPU

    # --- retrieval constants (behavioral invariants, SURVEY.md §7) -------
    embed_dim: int = 384            # BGE-small dim (reference ingest.py:92)
    retrieve_k: int = 15            # ANN fan-out (reference main.py:215)
    default_top_k: int = 5          # final context size (reference main.py:118)
    collection: str = "financial_documents"

    # --- dynamic batching (reference main2.py:50-53) ---------------------
    batch_window_s: float = 0.05
    # > 0: dispatch a batch once the queue has idled this long instead of
    # always sleeping the full window — a lone request pays ~one slice,
    # bursts still fill 32 (serving/batcher.py).  0 = reference fixed
    # window semantics (main2.py:286).
    batch_eager_idle_s: float = 0.005
    max_batch_size: int = 32
    max_concurrent_llm: int = 25
    request_timeout_s: float = 90.0  # reference main2.py:330

    # --- LLM client (reference main.py:271-286) ---------------------------
    llm_timeout_s: float = 12.0
    llm_retries: int = 3
    llm_backoff_min_s: float = 2.0
    llm_backoff_max_s: float = 6.0
    llm_temperature: float = 0.2
    llm_base_url: str = "https://api.groq.com/openai/v1"
    llm_api_key: str = ""
    model_simple: str = "llama-3.1-8b-instant"
    model_complex: str = "llama-3.3-70b-versatile"

    # --- circuit breaker (reference main.py:154-187) ----------------------
    breaker_cooldown_s: float = 60.0
    breaker_state_path: str = "/tmp/frs_tpu_cb_state.json"

    # --- storage ----------------------------------------------------------
    database_url: str = "frs_cache.db"   # sqlite file path
    index_dir: str = "frs_index"         # persisted index checkpoints

    # --- ingestion (reference ingest.py:25, 71-81) -------------------------
    chunk_size: int = 1000
    chunk_overlap: int = 200
    embed_batch_size: int = 64           # ingest.py:58
    upsert_batch_size: int = 256         # ingest.py:171

    # --- scheduler (reference scheduler.py:14-20) --------------------------
    scheduler_tickers: str = "AAPL"
    scheduler_filing_types: str = "10-K,10-Q"
    scheduler_time: str = "00:00"

    # --- TPU runtime --------------------------------------------------------
    mesh_shape: str = ""            # e.g. "data:2,corpus:4"; "" = all devices on corpus
    compute_dtype: str = "bfloat16"
    use_pallas: bool = True         # False => pure-XLA fallback paths
    index_dtype: str = "bfloat16"   # corpus storage: bfloat16 | int8
    corpus_tile: int = 1024         # corpus rows per Pallas grid step
    max_corpus: int = 1 << 15       # initial sharded capacity (grows on demand)
    # device token store width (fused rerank).  0 = AUTO: sized at ingest
    # from the measured p99 wordpiece length, widened if later chunks
    # measure longer (index/flat.py auto_token_width) — a static width
    # silently truncates realistic 1000-char chunks (VERDICT r4 #1)
    token_store_len: int = 0
    token_store_max: int = 384      # ceiling for the auto-sized store

    # --- serving -----------------------------------------------------------
    host: str = "0.0.0.0"
    port: int = 8001
    # multi-process op-broadcast control plane (parallel/control.py)
    control_port: int = 17077

    @staticmethod
    def from_env() -> "Config":
        return Config(
            testing=_env_bool("TESTING") or _env_bool("RAG_TPU_TESTING"),
            force_cpu=_env_bool("RAG_TPU_FORCE_CPU"),
            llm_base_url=os.environ.get(
                "LLM_BASE_URL", "https://api.groq.com/openai/v1"
            ),
            llm_api_key=os.environ.get("GROQ_API_KEY", ""),
            database_url=os.environ.get("DATABASE_URL", "frs_cache.db"),
            index_dir=os.environ.get("INDEX_DIR", "frs_index"),
            scheduler_tickers=os.environ.get("SCHEDULER_TICKERS", "AAPL"),
            scheduler_filing_types=os.environ.get(
                "SCHEDULER_FILING_TYPES", "10-K,10-Q"
            ),
            scheduler_time=os.environ.get("SCHEDULER_TIME", "00:00"),
            mesh_shape=os.environ.get("RAG_TPU_MESH", ""),
            use_pallas=_env_bool("RAG_TPU_USE_PALLAS", True),
            index_dtype=os.environ.get("RAG_TPU_INDEX_DTYPE", "bfloat16"),
            corpus_tile=_env_int("RAG_TPU_CORPUS_TILE", 1024),
            max_corpus=_env_int("RAG_TPU_MAX_CORPUS", 1 << 15),
            token_store_len=_env_int("RAG_TPU_TOKEN_STORE_LEN", 0),
            token_store_max=_env_int("RAG_TPU_TOKEN_STORE_MAX", 384),
            batch_window_s=_env_float("RAG_TPU_BATCH_WINDOW_S", 0.05),
            batch_eager_idle_s=_env_float("RAG_TPU_BATCH_EAGER_IDLE_S", 0.005),
            max_batch_size=_env_int("RAG_TPU_MAX_BATCH", 32),
            port=_env_int("RAG_TPU_PORT", 8001),
            control_port=_env_int("FRS_CONTROL_PORT", 17077),
            breaker_state_path=os.environ.get(
                "RAG_TPU_CB_PATH", "/tmp/frs_tpu_cb_state.json"
            ),
        )


@lru_cache(maxsize=1)
def get_config() -> Config:
    return Config.from_env()


def resolve_host(service: str, default: str = "localhost") -> str:
    """Docker-service DNS probe with localhost fallback.

    Mirrors the reference's discovery helper (main2.py:24-39): inside a
    compose network the service name resolves; outside it falls back.
    """
    import socket

    try:
        socket.gethostbyname(service)
        return service
    except socket.gaierror:
        return default


def get_service_url(service: str, port: int, default_host: str = "localhost") -> str:
    return f"http://{resolve_host(service, default_host)}:{port}"


def default_backend_url() -> str:
    """BACKEND_URL env, else Docker-DNS probe for the backend service.

    The discovery order every client (frontend, load tester, ingestor,
    scheduler) shares — reference main2.py:24-39 / ingest.py:16.
    """
    return os.environ.get("BACKEND_URL") or get_service_url("backend", 8001)


def reset_config() -> None:
    """Re-read env on next get_config() — used by tests."""
    get_config.cache_clear()

