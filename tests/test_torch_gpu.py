"""The port's CUDA kernels on the card, each against its plain version.

Marked ``gpu``: without a CUDA device every test skips (a hand-written
kernel has no CPU mode).  This file imports no JAX, so it runs on a
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances are ``tests/test_kernels.py``'s: 2e-5 in f32, 2e-2 in bf16.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops

# (b, s, h, kvh, d, window): the sweep of tests/test_kernels.py, then
# ragged s, GQA, d=16, a window that is not a multiple of the tile and
# the main path's own head layout
CASES = [(2, 256, 4, 4, 64, 0), (1, 512, 2, 2, 128, 0),
         (2, 256, 4, 4, 64, 128), (1, 128, 8, 8, 32, 0),
         (3, 192, 2, 2, 64, 0), (1, 1, 4, 4, 64, 0), (2, 77, 4, 2, 64, 0),
         (1, 1000, 2, 2, 32, 0), (1, 130, 32, 8, 128, 0),
         (2, 50, 4, 1, 16, 0), (1, 200, 2, 2, 64, 37),
         # stablelm-1.6b's heads at a ragged served length and at 2048
         (1, 1762, 32, 32, 64, 0), (1, 2048, 32, 32, 64, 0)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d,window", CASES)
def test_flash_attention_kernel(card, b, s, h, kvh, d, window, dtype):
    gen = torch.Generator(device=card).manual_seed(s * 131 + h * 7 + d)
    q = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
    k = torch.randn(b, s, kvh, d, generator=gen, device=card).to(dtype)
    v = torch.randn(b, s, kvh, d, generator=gen, device=card).to(dtype)
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    want = ops.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_not_causal(card, dtype):
    """causal=False, and fewer keys than queries (index-based masks)."""
    gen = torch.Generator(device=card).manual_seed(1)
    q = torch.randn(2, 100, 4, 32, generator=gen, device=card).to(dtype)
    k = torch.randn(2, 70, 2, 32, generator=gen, device=card).to(dtype)
    v = torch.randn(2, 70, 2, 32, generator=gen, device=card).to(dtype)
    for causal in (False, True):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_flash_attention_kernel_strided_layout(card):
    """q/k/v as column slices of one fused qkv projection: the kernel
    reads them through their strides, without a copy."""
    gen = torch.Generator(device=card).manual_seed(0)
    qkv = torch.randn(2, 96, 3 * 4, 64, generator=gen, device=card)
    q, k, v = qkv.to(torch.bfloat16).split(4, dim=2)
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
