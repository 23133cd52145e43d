"""JAX's default random numbers on the host: threefry2x32 in numpy.

The port's copy of what the reference draws its RANSAC samples from
(``geotrax_tpu/ops/ransac.py:_sample_indices`` with the keys of
``geotrax_tpu/pipeline/device_pipeline.py``), as JAX 0.9.0 computes it with
its defaults: ``jax_default_prng_impl=threefry2x32``,
``jax_threefry_partitionable=True`` and 32-bit mode. The functions follow
``jax/_src/prng.py`` (``threefry_seed``, ``_threefry2x32_lowering``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py:_uniform``. A key is a (..., 2) uint32 array; every
function takes a batch of keys on the leading axes and returns the same
words JAX returns for each key.

The draws are tiny (a chunk's RANSAC takes 32 x 625 x 4 uniforms) and go to
the card in one copy, so they are made on the host in numpy, with no device
work and no synchronisation.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """The Threefry-2x32 block cipher (20 rounds) of the counter pairs
    (x0, x1) under ``key`` (..., 2); keys broadcast against the counters'
    trailing axes as the caller arranges them."""
    k0 = np.asarray(key[..., 0], np.uint32)
    k1 = np.asarray(key[..., 1], np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):  # uint32 arithmetic wraps, as the cipher means it to
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 — JAX's name
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: the seed is taken modulo
    2**32, so the high word is 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a (2,) key and scalar or (N,)
    data (uint32, as JAX converts it): (2,) or (N, 2) keys."""
    d = np.asarray(data).astype(np.uint32)
    # threefry_2x32(key, threefry_seed(d)): the count pair is (0, d)
    y0, y1 = threefry2x32(np.asarray(key, np.uint32), np.zeros_like(d), d)
    return np.stack([y0, y1], axis=-1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """Partitionable 32-bit random bits of ``shape`` for (..., 2) keys:
    (..., *shape) uint32. The counters are the flat index of each element
    as a 64-bit pair (high, low); the bits are the two output words XORed."""
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise ValueError(f"random_bits: {n} elements need 64-bit counters")
    key = np.asarray(key, np.uint32)
    lead = key.shape[:-1]
    lo = np.arange(n, dtype=np.uint32)
    y0, y1 = threefry2x32(key.reshape(lead + (1, 2)), np.zeros_like(lo), lo)
    return (y0 ^ y1).reshape(lead + tuple(shape))


def uniform(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32, in [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` for (..., 2) keys: (..., num, 2) keys.
    Partitionable threefry splits as it folds in: key ``i`` is the cipher of
    the counter pair (0, i) under ``key`` (``_threefry_split_foldlike``)."""
    key = np.asarray(key, np.uint32)
    i = np.arange(num, dtype=np.uint32)
    y0, y1 = threefry2x32(key[..., None, :], np.zeros_like(i), i)
    return np.stack([y0, y1], axis=-1)
