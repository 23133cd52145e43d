"""Tests of the port that need a CUDA card: the hand-written kernels have no
CPU mode. Each test skips, with its reason, where ``torch.cuda`` finds no
card. They import neither JAX nor the JAX package, so on the card's machine
(which has no JAX) they run without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from geotrax_tpu_torch.ops import fast
from geotrax_tpu_torch.ops import features


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")


def textured_gray(b, h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(40, 90, (b, h, w)).astype(np.float32)
    for i in range(b):
        for _ in range(max(4, h * w // 2000)):
            y, x = rng.integers(0, max(h - 6, 1)), rng.integers(0, max(w - 6, 1))
            bh, bw = rng.integers(2, 16, 2)
            img[i, y:y + bh, x:x + bw] = rng.integers(120, 255)
    return img


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 1080, 1920), (2, 37, 53), (1, 3, 5)])
@pytest.mark.parametrize("threshold", [20.0, 7.0])
def test_kernel_equals_plain_on_card(shape, threshold):
    _need_card()
    g = torch.from_numpy(textured_gray(*shape, seed=sum(shape))).cuda()
    before = fast.fast_score_map.launches
    out = fast.fast_score_map(g, threshold)
    torch.cuda.synchronize()
    assert fast.fast_score_map.launches == before + 1
    torch.testing.assert_close(out, fast.fast_score_map_torch(g, threshold), rtol=0, atol=0)
    # a single (H,W) image takes the same kernel
    one = fast.fast_score_map(g[0].contiguous(), threshold)
    torch.testing.assert_close(one, out[0], rtol=0, atol=0)


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    g = torch.zeros((2, 32, 48), device="cuda")
    with pytest.raises(TypeError):
        fast.fast_score_map(g.double())
    with pytest.raises(ValueError):
        fast.fast_score_map(g.transpose(1, 2))
    with pytest.raises(ValueError):
        fast.fast_score_map(g[None])


@pytest.mark.gpu
def test_fast_detect_on_card_equals_cpu():
    _need_card()
    gray = torch.from_numpy(textured_gray(4, 120, 160, seed=3))
    mask = torch.ones((120, 160), dtype=torch.bool)
    mask[40:70, 50:90] = False
    cpu = features.fast_detect(gray, 300, mask=mask)
    gpu = features.fast_detect(gray.cuda(), 300, mask=mask.cuda())
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=0)
