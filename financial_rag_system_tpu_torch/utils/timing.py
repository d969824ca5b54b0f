"""Wall-clock timing helpers that are honest about asynchronous launches.

Port of ``financial_rag_system_tpu/utils/timing.py``.  A CUDA call
returns once its kernels are queued, so timing the call alone measures
the launch, not the work.  Each helper fetches a call's outputs to the
host and waits for that call alone, as JAX's ``np.asarray`` of a buffer
does: every CUDA tensor leaf is copied into pinned host memory without
blocking, an event is recorded after the copies, and the fetch waits on
that event.  A plain ``.cpu()`` would wait for every kernel queued on
the stream, the later calls' too.

- :func:`fetched_ms` — latency of one call *including* the host fetch of
  its (small) outputs: what a single request experiences.
- :func:`concurrent_ms` — per-call wall time with the fetches overlapped
  in a thread pool, as the async serving shell overlaps its batches.
- :func:`sustained_ms` — steady-state throughput with ``depth`` calls in
  flight and a rotating fetch: what the serving pipeline experiences
  under load.  Wall clock over many reps.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator

import torch


def _leaves(out: Any) -> Iterator[torch.Tensor]:
    """Every tensor in ``out`` (nested tuples, lists and dicts)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for item in out:
            yield from _leaves(item)
    elif isinstance(out, dict):
        for item in out.values():
            yield from _leaves(item)


def _start_fetch(out: Any) -> tuple[list[torch.Tensor], list]:
    """Queue the copy of every tensor in ``out`` to the host: a CUDA
    tensor's into pinned memory without blocking, a CPU tensor's by
    ``.cpu()``.  Returns the host copies and one event a card, recorded
    on its current stream after the copies."""
    hosts, cards = [], []
    for t in _leaves(out):
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
            if t.device not in cards:
                cards.append(t.device)
        else:
            hosts.append(t.cpu())
    events = []
    for card in cards:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(card))
        events.append(event)
    return hosts, events


def _wait(pending: tuple[list[torch.Tensor], list]) -> None:
    """Wait until :func:`_start_fetch`'s copies have reached the host."""
    for event in pending[1]:
        event.synchronize()


def _fetch(out: Any) -> None:
    """Copy every tensor in ``out`` to the host, waiting for that call's
    work alone."""
    _wait(_start_fetch(out))


def fetched_ms(fn: Callable[[], Any], *, reps: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        _fetch(fn())
    t0 = time.time()
    for _ in range(reps):
        _fetch(fn())
    return (time.time() - t0) / reps * 1e3


def concurrent_ms(
    fn: Callable[[], Any], *, workers: int = 16, reps: int = 48, warmup: int = 2
) -> float:
    """Steady-state per-call wall time with results fetched from a thread
    pool — host round-trip latency overlaps across in-flight calls, which
    is exactly what the async serving shell does with its batches."""
    from concurrent.futures import ThreadPoolExecutor

    for _ in range(warmup):
        _fetch(fn())
    with ThreadPoolExecutor(workers) as ex:
        t0 = time.time()
        futs = [ex.submit(_wait, _start_fetch(fn())) for _ in range(reps)]
        for f in futs:
            f.result()
        return (time.time() - t0) / reps * 1e3


def sustained_ms(
    fn: Callable[[], Any], *, depth: int = 4, reps: int = 40, warmup: int = 2
) -> float:
    for _ in range(warmup):
        _fetch(fn())
    inflight = [_start_fetch(fn()) for _ in range(depth)]
    t0 = time.time()
    for _ in range(reps):
        inflight.append(_start_fetch(fn()))
        _wait(inflight.pop(0))
    for pending in inflight:
        _wait(pending)
    return (time.time() - t0) / (reps + depth) * 1e3
