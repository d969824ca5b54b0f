"""The port's numpy ``jax.random.normal`` against jax itself, on the CPU.

``financial_rag_system_tpu_torch/utils/prng.py`` repeats JAX's threefry
bits, its bits-to-uniform step and XLA's f32 ``erf_inv`` (with XLA's
log1p and log, and its fused multiply-adds) in numpy.  Every value must
equal jax's bit for bit: 0 ulps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from financial_rag_system_tpu.models import embedder as jemb
from financial_rag_system_tpu_torch.models import embedder as temb
from financial_rag_system_tpu_torch.utils import prng


def jax_normal(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


@pytest.mark.parametrize(
    "seed,shape",
    [(0, (3, 5)), (7, (1000,)), (13, (2, 3, 4)), (1, (1,)), (123456, (4097,)),
     (2**31 - 1, (64, 33)), (42, (300001,))],
)
def test_normal_equals_jax_bit_for_bit(seed, shape):
    got = prng.normal(seed, shape)
    want = jax_normal(seed, shape)
    assert got.shape == want.shape and got.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_bits_and_key_are_jax_threefry():
    """The key words and the raw 32-bit draws (jax.random.bits)."""
    for seed in (0, 7, 99991):
        key = jax.random.PRNGKey(seed)
        assert tuple(np.asarray(key)) == prng.prng_key(seed)
        want = np.asarray(jax.random.bits(key, (777,), jnp.uint32))
        assert prng.random_bits(prng.prng_key(seed), 777).tobytes() == want.tobytes()
        # a draw from the middle of the flat shape (the chunked walk)
        assert prng.random_bits(prng.prng_key(seed), 100, 500).tobytes() == want[500:600].tobytes()


def test_seed_outside_jax_default_integers_is_refused():
    with pytest.raises(ValueError, match="seed"):
        prng.prng_key(2**31)


@pytest.mark.parametrize("seed", [7, 13])
def test_hash_tables_equal_jax(seed):
    """The full (30,522, 384) tables of the hash embedder (seed 7) and the
    hash reranker (seed 13), stopword rows times 0.15, bit for bit."""
    tok = temb.Tokenizer()
    stop = tuple(sorted({i for w in temb._STOPWORDS for i in tok.tokenize_ids(w)}))
    assert temb._STOPWORDS == jemb._STOPWORDS and len(stop) > 50
    got = temb._hash_table(tok.vocab.vocab_size, 384, seed, stop)
    want = np.asarray(jemb._hash_table(tok.vocab.vocab_size, 384, seed, list(stop)))
    assert got.shape == (30522, 384) and not got.flags.writeable
    assert got.tobytes() == want.tobytes()
