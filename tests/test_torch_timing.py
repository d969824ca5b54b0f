"""``utils/timing.py`` of the port on the CPU: each helper fetches every
tensor of a call's output (nested tuples, lists and dicts) to the host,
makes the calls JAX's helpers make, and reports at least the call's own
wall time."""

from __future__ import annotations

import time

import jax.numpy as jnp
import pytest
import torch

from financial_rag_system_tpu.utils import timing as jtiming
from financial_rag_system_tpu_torch.utils import timing


class Probe(torch.Tensor):
    """A tensor that counts its copies to the host."""

    fetched = 0

    def cpu(self, *a, **k):
        Probe.fetched += 1
        return super().cpu(*a, **k)


def probe() -> torch.Tensor:
    return torch.zeros(3).as_subclass(Probe)


def test_fetch_walks_nested_outputs():
    Probe.fetched = 0
    out = (probe(), [probe(), {"a": probe(), "b": (probe(), 7)}], {"c": [probe()]}, None, "s")
    timing._fetch(out)
    assert Probe.fetched == 5
    timing._fetch(probe())
    assert Probe.fetched == 6


HELPERS = {
    "fetched_ms": dict(reps=5, warmup=2),
    "concurrent_ms": dict(workers=3, reps=6, warmup=2),
    "sustained_ms": dict(depth=3, reps=5, warmup=2),
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_helpers_make_jax_calls_and_fetch_each_output(name):
    kw = HELPERS[name]
    calls = {"port": 0, "jax": 0}

    def port_fn():
        calls["port"] += 1
        time.sleep(0.002)
        return {"scores": probe(), "rows": (probe(),)}

    def jax_fn():
        calls["jax"] += 1
        time.sleep(0.002)
        return {"scores": jnp.zeros(3), "rows": (jnp.zeros(3),)}

    Probe.fetched = 0
    ms = getattr(timing, name)(port_fn, **kw)
    getattr(jtiming, name)(jax_fn, **kw)
    assert calls["port"] == calls["jax"] > kw["reps"]
    assert Probe.fetched == 2 * calls["port"]  # every output's two tensors, once each
    # at least the timed calls' own sleep, spread over what each divides by
    assert 1.0 <= ms < 1e3
