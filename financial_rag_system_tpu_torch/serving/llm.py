"""Async LLM client (OpenAI-compatible protocol) with retry + breaker.

First-party replacement for the reference's ``AsyncOpenAI`` + tenacity
stack (main.py:193-196, 270-302): httpx against any OpenAI-protocol
endpoint (Groq by default), temperature 0.2, 12 s per-attempt timeout,
3 attempts with exponential backoff 2→6 s.  Generation is guarded by
the circuit breaker: a failed call trips it and the caller receives the
degraded answer instead of an exception; while tripped, calls
short-circuit to degraded immediately.

Model tiers follow the router: COMPLEX → the large model, SIMPLE → the
fast one (main.py:286).  TESTING mode returns the reference's canned
"Mock financial analysis response." (main.py:282-283) without network.
"""

from __future__ import annotations

from financial_rag_system_tpu_torch.serving.breaker import DEGRADED_ANSWER, CircuitBreaker
from financial_rag_system_tpu_torch.serving.router import COMPLEX
from financial_rag_system_tpu_torch.utils.config import Config
from financial_rag_system_tpu_torch.utils.retry import retry_async

MOCK_ANSWER = "Mock financial analysis response."

# the reference's exact prompt wording (main.py:396): the context rides
# in the system message, the raw query is the user message — preserved
# verbatim as part of the behavioral surface
SYSTEM_PROMPT_PREFIX = "You are a Wall Street analyst. Use ONLY this context:"


class LLMClient:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self._client: httpx.AsyncClient | None = None

    def _http(self) -> httpx.AsyncClient:
        if self._client is None:
            # imported here: TESTING's MockLLMClient needs no httpx
            import httpx

            self._client = httpx.AsyncClient(
                base_url=self.cfg.llm_base_url,
                headers={"Authorization": f"Bearer {self.cfg.llm_api_key}"},
                timeout=self.cfg.llm_timeout_s,
            )
        return self._client

    def model_for(self, complexity: str) -> str:
        return self.cfg.model_complex if complexity == COMPLEX else self.cfg.model_simple

    async def _chat_once(self, model: str, system: str, user: str) -> str:
        resp = await self._http().post(
            "/chat/completions",
            json={
                "model": model,
                "temperature": self.cfg.llm_temperature,
                "messages": [
                    {"role": "system", "content": system},
                    {"role": "user", "content": user},
                ],
            },
        )
        resp.raise_for_status()
        return resp.json()["choices"][0]["message"]["content"]

    async def chat(self, model: str, system: str, user: str) -> str:
        """Retrying call: 3 attempts, exp backoff 2-6 s, 12 s per attempt."""
        return await retry_async(
            lambda: self._chat_once(model, system, user),
            attempts=self.cfg.llm_retries,
            backoff_min_s=self.cfg.llm_backoff_min_s,
            backoff_max_s=self.cfg.llm_backoff_max_s,
            timeout_s=self.cfg.llm_timeout_s,
        )

    async def aclose(self) -> None:
        if self._client is not None:
            await self._client.aclose()


class MockLLMClient(LLMClient):
    """TESTING-mode client: canned deterministic answer, no network."""

    async def chat(self, model: str, system: str, user: str) -> str:
        return MOCK_ANSWER


async def generate_answer(
    client: LLMClient,
    breaker: CircuitBreaker,
    query: str,
    context: str,
    complexity: str,
) -> tuple[str, str]:
    """Breaker-guarded generation. Returns (answer, provider).

    provider is "Groq (<model>)" on success (reference main.py:298) or
    "System Degraded" when the breaker is open / the call fails
    (reference main.py:280-302).
    """
    if not breaker.is_healthy:
        return DEGRADED_ANSWER, "System Degraded"
    model = client.model_for(complexity)
    system = f"{SYSTEM_PROMPT_PREFIX}\n{context}"
    try:
        answer = await client.chat(model, system, query)
        return answer, f"Groq ({model})"
    except Exception:
        breaker.trip()
        return DEGRADED_ANSWER, "System Degraded"
