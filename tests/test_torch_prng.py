"""The port's RANSAC draw against JAX's: the threefry2x32 generator
(``ops/prng.py``) bit for bit against ``jax.random``, and the extract
chunk step's default sampler against the reference's ``_sample_indices``
keyed as the reference keys it (``fold_in(PRNGKey(rng_seed), frame id)``),
at the path's shapes (625 hypotheses of 4 samples over 2000 matches)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from geotrax_tpu.ops import ransac as jr
from geotrax_tpu_torch import cfg as tcfg
from geotrax_tpu_torch.models.detector import OracleDetector
from geotrax_tpu_torch.ops import prng
from geotrax_tpu_torch.ops import ransac as tr
from geotrax_tpu_torch.pipeline.device_pipeline import FusedExtractor
from geotrax_tpu_torch.track import make_tracker

SEEDS = (0, 1, 2 ** 31 - 1, 2 ** 32 - 1)
FIDS = (0, 1, 31, 10 ** 6)
N_MATCHES = 2000
HYPOTHESES, SAMPLE = 625, 4


def words(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_words(seed):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key, words(jax.random.PRNGKey(seed)))
    for fid in FIDS:
        np.testing.assert_array_equal(prng.fold_in(key, fid),
                                      words(jax.random.fold_in(jax.random.PRNGKey(seed), fid)))
    # a vector of frame ids folds each one in
    batch = prng.fold_in(key, np.asarray(FIDS))
    assert batch.shape == (len(FIDS), 2)
    for row, fid in zip(batch, FIDS):
        np.testing.assert_array_equal(row, prng.fold_in(key, fid))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(HYPOTHESES, SAMPLE), (5, 3), (7,)])
def test_uniform_bits_equal_jax(seed, shape):
    """(5, 3) and (7,) have an odd element count."""
    for fid in FIDS:
        ours = prng.uniform(prng.fold_in(prng.PRNGKey(seed), fid), shape)
        ref = np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), fid), shape))
        assert ours.dtype == np.float32 and ours.shape == shape
        np.testing.assert_array_equal(words(ours), words(ref))
        assert ((ours >= 0.0) & (ours < 1.0)).all()
    # a batch of keys draws each key's array
    keys = prng.fold_in(prng.PRNGKey(seed), np.asarray(FIDS))
    np.testing.assert_array_equal(prng.uniform(keys, shape),
                                  np.stack([prng.uniform(k, shape) for k in keys]))


def test_cumsum_in_xla_order():
    """The prefix sum of the inverse CDF is added in the order of the
    reference's ``jnp.cumsum`` on the CPU, bit for bit, at lengths around
    the 16-element blocks and at the path's 2000 and 4000; ``torch.cumsum``
    differs from it on these inputs."""
    rng = np.random.default_rng(0)
    differs = 0
    for n in (1, 5, 16, 17, 255, 256, 257, 2000, 4000):
        x = rng.random((3, n)).astype(np.float32)
        ref = np.asarray(jax.vmap(jnp.cumsum)(jnp.asarray(x)))
        np.testing.assert_array_equal(words(tr.cumsum_xla(torch.from_numpy(x)).numpy()), words(ref))
        differs += not np.array_equal(torch.cumsum(torch.from_numpy(x), -1).numpy(), ref)
    assert differs > 0


@pytest.fixture(scope="module")
def extractor():
    det = OracleDetector(lambda idx: [], device="cpu")
    _, state, step = make_tracker("botsort", tcfg.DEFAULT["tracker"]["botsort"], max_tracks=16,
                                  device="cpu")
    return FusedExtractor(det, tcfg.DEFAULT["stabilo"], step, state, 48, 64, use_gmc=True,
                          chunk=8, rng_seed=3, device="cpu")


def jax_indices(seed, fids, valid):
    """The reference's draw: its weights and ``_sample_indices`` per frame."""
    out = []
    for f, v in zip(fids, valid):
        w = jnp.asarray(v, jnp.float32)
        w = jnp.where(w.sum() > 0, w, jnp.ones_like(w))
        w = w / jnp.maximum(w.sum(), 1.0)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), f)
        out.append(np.asarray(jr._sample_indices(key, HYPOTHESES, SAMPLE, len(v), w)))
    return np.stack(out)


def test_default_sampler_draws_the_references_indices(extractor):
    """A chunk of frame ids whose frames have 0, 1, 5, some and all of
    their 2000 matches valid."""
    rng = np.random.default_rng(1)
    fids = [1, 2, 3, 4, 5, 31, 32, 10 ** 6]
    valid = np.zeros((len(fids), N_MATCHES), bool)
    for row, count in zip(valid, (0, 1, 5, 37, 1500, 1999, N_MATCHES, 731)):
        row[rng.choice(N_MATCHES, count, replace=False)] = True
    weights = tr.sample_weights(torch.from_numpy(valid))
    ours = extractor._draw_indices(fids, weights, HYPOTHESES, SAMPLE)
    assert ours.shape == (len(fids), HYPOTHESES, SAMPLE)
    np.testing.assert_array_equal(ours.numpy(), jax_indices(3, fids, valid))
    # a frame's draw depends on its id only, not on its place in the chunk
    np.testing.assert_array_equal(
        extractor._draw_indices(fids[::-1], weights.flip(0), HYPOTHESES, SAMPLE).numpy(),
        ours.flip(0).numpy())
    # reset re-keys from another seed, as the reference's reset does
    extractor.reset(rng_seed=2 ** 32 - 1)
    try:
        np.testing.assert_array_equal(
            extractor._draw_indices(fids, weights, HYPOTHESES, SAMPLE).numpy(),
            jax_indices(2 ** 32 - 1, fids, valid))
    finally:
        extractor.reset()
    np.testing.assert_array_equal(extractor._draw_indices(fids, weights, HYPOTHESES, SAMPLE), ours)
