"""Async retry with exponential backoff + timeout.

First-party replacement for the reference's tenacity usage
(``retry(stop_after_attempt(3), wait_exponential(2..6))`` +
``asyncio.wait_for(..., 12s)``, reference main.py:271-278).
"""

from __future__ import annotations

import asyncio
import functools
import random
from typing import Any, Awaitable, Callable, TypeVar

T = TypeVar("T")


async def retry_async(
    fn: Callable[[], Awaitable[T]],
    *,
    attempts: int = 3,
    backoff_min_s: float = 2.0,
    backoff_max_s: float = 6.0,
    timeout_s: float | None = None,
    retry_on: tuple[type[BaseException], ...] = (Exception,),
) -> T:
    """Run ``fn`` up to ``attempts`` times with exponential backoff.

    Backoff for attempt i is min(backoff_min * 2**i, backoff_max) with a
    little jitter; each attempt is individually bounded by ``timeout_s``.
    The final failure re-raises.
    """
    last_exc: BaseException | None = None
    for attempt in range(attempts):
        try:
            if timeout_s is not None:
                return await asyncio.wait_for(fn(), timeout=timeout_s)
            return await fn()
        except retry_on as exc:  # noqa: PERF203
            last_exc = exc
            if attempt == attempts - 1:
                break
            delay = min(backoff_min_s * (2**attempt), backoff_max_s)
            await asyncio.sleep(delay * (0.8 + 0.4 * random.random()))
    assert last_exc is not None
    raise last_exc


def with_retry(**kwargs: Any):
    """Decorator form of :func:`retry_async`."""

    def deco(fn: Callable[..., Awaitable[T]]) -> Callable[..., Awaitable[T]]:
        @functools.wraps(fn)
        async def wrapper(*args: Any, **kw: Any) -> T:
            return await retry_async(lambda: fn(*args, **kw), **kwargs)

        return wrapper

    return deco
