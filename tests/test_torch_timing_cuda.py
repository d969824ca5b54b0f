"""``utils/timing.py`` of the port on the card: a fetch waits for its
own call alone, so calls in flight overlap the host's work with the
card's.

Needs an NVIDIA GPU; skips without one.  Imports neither JAX nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_timing_cuda.py -q
"""

from __future__ import annotations

import time

import pytest
import torch

from financial_rag_system_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda

HOST_S = 0.003  # each call's host work before its launch
DEVICE_MS = 3.0  # each call's device work


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def spin_cycles(ms: float) -> int:
    """The ``torch.cuda._sleep`` cycles that keep the card busy ``ms``."""
    cycles = 1_000_000
    torch.cuda._sleep(cycles)  # first launch out of the timing
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return int(cycles * ms / start.elapsed_time(end))


def test_fetch_copies_every_card_tensor(cuda):
    x = torch.arange(12, device=cuda, dtype=torch.float32).view(3, 4)
    out = {"a": x, "b": [x.t(), (x.to(torch.bfloat16), torch.tensor([7]))]}
    hosts, events = timing._start_fetch(out)
    timing._wait((hosts, events))
    assert len(events) == 1 and len(hosts) == 4
    assert torch.equal(hosts[0], x.cpu()) and torch.equal(hosts[1], x.t().cpu())
    assert torch.equal(hosts[2], x.to(torch.bfloat16).cpu()) and hosts[3].item() == 7


def test_calls_in_flight_overlap_host_and_card(cuda):
    """A call that works ``HOST_S`` on the host, then ``DEVICE_MS`` on the
    card: fetched one by one the two add up; with four in flight the
    host's work hides behind the card's, so each call costs about the
    larger of the two."""
    cycles = spin_cycles(DEVICE_MS)
    out = torch.zeros(4, device=cuda)

    def call():
        time.sleep(HOST_S)
        torch.cuda._sleep(cycles)
        return out + 1

    fetched = timing.fetched_ms(call, reps=20)
    sustained = timing.sustained_ms(call, depth=4, reps=20)
    print(f"[timing] {torch.cuda.get_device_name(0)}: {HOST_S * 1e3:.0f} ms host + "
          f"{DEVICE_MS:.0f} ms card a call: fetched_ms {fetched:.3f}, "
          f"sustained_ms(depth=4) {sustained:.3f}")
    assert fetched >= 0.9 * (HOST_S * 1e3 + DEVICE_MS), fetched
    assert sustained < 0.75 * fetched, (sustained, fetched)
