"""``jax.random.normal`` in numpy, bit for bit with jax on the CPU.

The hash stack's tables (:mod:`models.embedder`, :mod:`models.reranker`)
are the JAX package's ``jax.random.normal(jax.random.PRNGKey(seed),
shape, jnp.float32)``.  A torch generator cannot draw them and the port
imports no jax, so this module repeats JAX's steps in numpy:

1. ``PRNGKey(seed)``: the key words (seed >> 32, seed & 0xFFFFFFFF).
2. The random bits as JAX draws them with ``jax_threefry_partitionable``
   on (the default since jax 0.5): element n of the flat shape is
   ``threefry2x32(key, (n >> 32, n & 0xFFFFFFFF))``, its two output
   words xor-ed.
3. Bits to a uniform in [nextafter(-1, 0), 1): the top 23 bits as the
   mantissa of a float in [1, 2), minus 1, times (hi - lo), plus lo,
   clamped below at lo.
4. ``sqrt(2) * erf_inv(u)`` with XLA's f32 ``erf_inv``: w = -log1p(-u
   u), then M. Giles' two degree-8 polynomials in w - 2.5 (w < 5) or
   sqrt(w) - 3, times u.  log1p is XLA's: a Cephes rational function
   below |x| = sqrt(2) - 1, else log(1 + x) with XLA's Cephes log.

Every step is an f32 operation in XLA's order, and where XLA's CPU
backend contracts a product and a sum into one fused multiply-add, so
does this module (:func:`_fma`).  ``tests/test_torch_prng.py`` holds the
result to ``jax.random.normal`` bit for bit.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 18
_PARITY = np.uint32(0x1BD11BDA)

# XLA's ErfInv for f32 (xla/hlo/builder/lib/math.cc), highest power first
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


# XLA's f32 log (Cephes), and the small-argument rational function of its log1p
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to f32 (the f32 product is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _log(v: np.ndarray) -> np.ndarray:
    """XLA's f32 log of positive normal values: the exponent split off, the
    mantissa moved to [sqrt(1/2), sqrt(2)) - 1, Cephes' polynomial."""
    f32 = np.float32
    bits = np.maximum(v, np.float32(1.1754944e-38)).view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(f32) + f32(1)
    x = ((bits & np.uint32(0x807FFFFF)) | f32(0.5).view(np.uint32)).view(f32)
    small = x < f32(0.707106781186547524)
    e = e - np.where(small, f32(1), f32(0))
    x = (x - f32(1)) + np.where(small, x, f32(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(_fma(y, x3, y1), x3, y2), x3, _LOG_Q1 * e)
    return _fma(_LOG_Q2, e, _fma(f32(-0.5), x2, x) + y)


def _polynomial(x: np.ndarray, coeffs) -> np.ndarray:
    """Horner with fused steps, highest power first."""
    p = np.full_like(x, np.float32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, np.float32(c))
    return p


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's f32 log1p for x > -1."""
    out = np.empty_like(x)
    small = np.abs(x) < np.float32(0.41421356237309504880)
    xs = x[small]
    x2 = xs * xs
    ratio = _polynomial(xs, _LOG1P_NUM) / _polynomial(xs, _LOG1P_DEN)
    out[small] = xs + _fma(np.float32(-0.5), x2, (xs * x2) * ratio)
    out[~small] = _log(x[~small] + np.float32(1))
    return out


def prng_key(seed: int) -> tuple[np.uint32, np.uint32]:
    """``jax.random.PRNGKey(seed)``'s two key words, for a seed that fits
    JAX's default 32-bit integers."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return np.uint32(0), np.uint32(seed)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[np.uint32, np.uint32], x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = _rotl(x1, r)
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(key: tuple[np.uint32, np.uint32], size: int, start: int = 0) -> np.ndarray:
    """32 random bits for each of elements ``start`` .. ``start + size - 1``
    of the flat shape, as JAX's partitionable threefry draws them."""
    n = np.arange(start, start + size, dtype=np.uint64)
    hi = (n >> np.uint64(32)).astype(np.uint32)
    lo = (n & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erf_inv, elementwise on an f32 array with |x| < 1."""
    w = -_log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_W_LT_5[0]), np.float32(_W_GE_5[0]))
    for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
        p = _fma(p, w, np.where(lt, np.float32(a), np.float32(b)))
    return p * x


def normal(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)``."""
    size = int(np.prod(shape, dtype=np.int64))
    key = prng_key(seed)
    out = np.empty(size, np.float32)
    one = np.array(1.0, np.float32)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    hi = np.float32(1.0)
    for start in range(0, size, _CHUNK):  # chunks that stay in cache
        bits = random_bits(key, min(_CHUNK, size - start), start)
        floats = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
        u = np.maximum(lo, floats * (hi - lo) + lo)
        out[start:start + len(u)] = np.float32(np.sqrt(2)) * _erf_inv(u)
    return out.reshape(shape)
