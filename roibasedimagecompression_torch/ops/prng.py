"""Threefry-2x32 random bits, bit-identical to JAX's default PRNG.

The codec's k-means (tier-1 splits and the large-palette path) draws its
k-means++ and random initial centres from `jax.random.PRNGKey(seed)`, so the
encoded bytes depend on those exact bits.  This numpy module reproduces
`PRNGKey`, `split`, `uniform`, `gumbel` and `categorical` under JAX's
partitionable threefry (`jax_threefry_partitionable=True`, the default of
current JAX): a key is a (2,) uint32 array, and a draw of shape S hashes the
64-bit iota over S split into (high, low) 32-bit counters.

The floating-point tail (the gumbel transform) takes its `log` from
`log32`, which is XLA's CPU float32 logarithm step for step, so the noise is
bit-identical too.
"""

from __future__ import annotations

import numpy as np
import torch

from roibasedimagecompression_torch.ops.colors import fma32

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    with np.errstate(over="ignore"):
        a = np.asarray(x0, np.uint32) + ks[0]
        b = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = _rotl(b, r)
                b = a ^ b
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for a seed that fits in 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _iota_2x32(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32 keys."""
    hi, lo = _iota_2x32(num)
    a, b = threefry2x32(key, hi, lo)
    return np.stack([a, b], axis=1)


def subkey_chain(seed: int, n: int) -> np.ndarray:
    """(n, 2) uint32: row i is the sub-key of the i-th step of `key, sub =
    split(key)` from PRNGKey(seed), the key of the i-th k-means++ draw."""
    key = prng_key(seed)
    out = np.empty((n, 2), np.uint32)
    for i in range(n):
        key, out[i] = split(key)
    return out


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32-bit random bits of `shape` (partitionable threefry)."""
    n = int(np.prod(shape))
    hi, lo = _iota_2x32(n)
    a, b = threefry2x32(key, hi, lo)
    return (a ^ b).reshape(shape)


def uniform(key: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    bits = random_bits(key, shape)
    fbits = (bits >> np.uint32(32 - 23)) | np.float32(1.0).view(np.uint32)
    floats = fbits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _hex32(h: str) -> float:
    return float(np.float32(float.fromhex(h)))


def log32(x):
    """XLA's CPU float32 `log`, bit for bit, for positive input: a torch
    tensor on any device, or a numpy array (returned as numpy).

    XLA lowers `log` to its own polynomial (a Cephes `logf`: mantissa in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial split in three, exponent
    times ln 2 in two parts) and LLVM fuses every multiply that feeds one add
    into a fused multiply-add.  torch's and numpy's float32 `log` differ from
    it in the last bit for about a tenth to a quarter of inputs; this follows
    the same operations and roundings (the fused multiply-adds through
    `ops/colors.py fma32`), on the CPU and on the card.  Zero and subnormal
    input gives -inf, as under XLA's flush-to-zero.
    """
    if isinstance(x, np.ndarray) or not torch.is_tensor(x):
        return log32(torch.from_numpy(np.array(x, np.float32, ndmin=1))).numpy().reshape(np.shape(x))
    x = x.float()
    tiny = float(np.finfo(np.float32).tiny)
    bits = torch.clamp(x, min=tiny).view(torch.int32)
    e = ((bits >> 23) - 126).float()
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _hex32("0x1.6a09e6p-1")  # sqrt(1/2)
    e = e - low.float()
    t = (m - 1.0) + torch.where(low, m, torch.zeros((), device=x.device))
    z = t * t
    t3 = z * t
    q0 = fma32(fma32(t, _hex32("0x1.204376p-4"), _hex32("-0x1.d7a370p-4")), t, _hex32("0x1.de4a34p-4"))
    q1 = fma32(fma32(t, _hex32("-0x1.fcba9ep-4"), _hex32("0x1.23d37ep-3")), t, _hex32("-0x1.555ca0p-3"))
    q2 = fma32(fma32(t, _hex32("0x1.999d58p-3"), _hex32("-0x1.fffff8p-3")), t, _hex32("0x1.555554p-2"))
    r = fma32(fma32(q0, t3, q1), t3, q2)
    y = fma32(r, t3, e * _hex32("-0x1.bd0106p-13"))
    out = fma32(_hex32("0x1.630000p-1"), e, fma32(-0.5, z, t) + y)
    return torch.where(x < tiny, torch.full_like(out, float("-inf")), out)


def gumbel(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.gumbel(key, shape, float32) in its default "low" mode."""
    tiny = np.finfo(np.float32).tiny
    u = uniform(key, shape, tiny, 1.0)
    return -log32(-log32(u))


def categorical(key: np.ndarray, logits: np.ndarray) -> int:
    """jax.random.categorical(key, logits) for 1-D float32 logits."""
    logits = np.asarray(logits, np.float32)
    return int(np.argmax(gumbel(key, logits.shape) + logits))
