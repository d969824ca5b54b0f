"""Dynamic request batcher — the core serving scheduling primitive.

Keeps the reference's design constants and algorithm exactly
(main2.py:50-53, 281-295): block on the queue for the first request,
sleep the 50 ms batching window, drain without waiting up to
MAX_BATCH_SIZE=32, run ONE batched compute for the whole set, then
resolve each request's future.

TPU-native difference: the reference batches only the embedding forward
and then does per-request Qdrant HTTP calls; here the single batched
device program does embed AND retrieval (per-query metadata filters ride
into the fused top-k kernel as an int32 array), so a full mixed-ticker
batch costs one tokenize + two kernel launches and zero host round-trips.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from financial_rag_system_tpu_torch.obs.tracing import get_tracer


@dataclass
class _Item:
    query: str
    ticker: str | None
    document_type: str | None
    future: asyncio.Future = field(repr=False)
    enqueued_s: float = field(default_factory=time.time)


# batch_fn(queries, filters) -> list of per-request results
BatchFn = Callable[[list[str], list[tuple[str | None, str | None]]], list[Any]]


class DynamicBatcher:
    def __init__(
        self,
        batch_fn: BatchFn,
        *,
        window_s: float = 0.05,
        max_batch: int = 32,
        max_inflight: int = 8,
        eager_idle_s: float = 0.0,
    ):
        self.batch_fn = batch_fn
        self.window_s = window_s
        self.max_batch = max_batch
        # eager idle dispatch (> 0 enables): after the first request,
        # keep draining up to the full window/32 while traffic flows, but
        # once the queue has stayed empty for one eager_idle_s grace
        # slice, dispatch immediately.  A LONE request then pays ~one
        # slice instead of the whole window (the reference's fixed sleep
        # charges every isolated request 50 ms before any compute —
        # main2.py:286 — which dominates the warm trained /ask); a burst
        # still fills batches because arrivals keep the queue non-empty.
        self.eager_idle_s = eager_idle_s
        self.queue: asyncio.Queue[_Item] = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._closed = False
        # successive batches overlap: the device pipelines their programs
        # and their host fetches overlap across worker threads
        self._inflight = asyncio.Semaphore(max_inflight)
        self._pending: set[asyncio.Task] = set()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for t in list(self._pending):
            t.cancel()
        if self._pending:
            await asyncio.gather(*self._pending, return_exceptions=True)

    @property
    def queue_size(self) -> int:
        return self.queue.qsize()

    # -- client side -------------------------------------------------------

    async def submit(
        self,
        query: str,
        ticker: str | None,
        document_type: str | None = None,
    ) -> Any:
        """Enqueue and await this request's slice of the batched compute."""
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put(_Item(query, ticker, document_type, fut))
        return await fut

    # -- batcher loop --------------------------------------------------------

    async def _run(self) -> None:
        while not self._closed:
            first = await self.queue.get()
            batch = [first]
            if self.eager_idle_s > 0:
                deadline = time.time() + self.window_s
                while len(batch) < self.max_batch and time.time() < deadline:
                    try:
                        batch.append(self.queue.get_nowait())
                        continue  # queue flowing: keep draining
                    except asyncio.QueueEmpty:
                        pass
                    await asyncio.sleep(
                        min(self.eager_idle_s, max(deadline - time.time(), 0))
                    )
                    if self.queue.qsize() == 0:
                        break  # one grace slice with no arrivals: dispatch
            else:
                # reference semantics: fixed window (main2.py:286)
                await asyncio.sleep(self.window_s)
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self.queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
            await self._inflight.acquire()
            task = asyncio.get_running_loop().create_task(self._process(batch))
            self._pending.add(task)
            task.add_done_callback(self._pending.discard)

    async def _process(self, batch: list[_Item]) -> None:
        tracer = get_tracer()
        queries = [it.query for it in batch]
        filters = [(it.ticker, it.document_type) for it in batch]
        t0 = time.time()
        try:
            with tracer.span(
                "Batch_Embedding", kind="TOOL",
                inputs={"batch_size": len(batch)},
            ):
                results = await asyncio.to_thread(self.batch_fn, queries, filters)
        except Exception as exc:  # resolve everyone with the failure
            for it in batch:
                if not it.future.done():
                    it.future.set_exception(exc)
            return
        finally:
            self._inflight.release()
        tracer.log_metric("batch_size", len(batch))
        tracer.log_metric("batch_compute_ms", (time.time() - t0) * 1000)
        for it, res in zip(batch, results):
            if not it.future.done():
                it.future.set_result(res)
