"""The port's CUDA kernels on the card, each against its plain version.

Marked ``gpu``: without a CUDA device every test skips (a hand-written
kernel has no CPU mode).  This file imports no JAX, so it runs on a
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances are ``tests/test_kernels.py``'s: 2e-5 in f32 and 2e-2 in bf16
for flash attention, 1e-4 and 3e-2 for the expert MLP, 5e-4 in f32 for
WKV6 (1e-3 under strong decay).  The quantize kernel's q and scales
equal its plain version's bit for bit.  WKV6 in bf16: the kernel (the
chunked form, its f32 operands split into two bf16 parts) and its plain
version (the recurrence in f32) differ in f32 by less than one bf16 ulp
of y, and y is rounded once to bf16, so they may land a bf16 ulp apart,
which is at most 2^-7 (7.8e-3) of |y|: 8e-3.  The final state is f32 in
both: 5e-4.
"""

import math

import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.moe_mlp import ops as moe_ops
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.quantize.ref import quantize_plain
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

# (b, s, h, kvh, d, window): the sweep of tests/test_kernels.py, then
# ragged s, GQA, d=16, a window that is not a multiple of the tile and
# the main path's own head layout
CASES = [(2, 256, 4, 4, 64, 0), (1, 512, 2, 2, 128, 0),
         (2, 256, 4, 4, 64, 128), (1, 128, 8, 8, 32, 0),
         (3, 192, 2, 2, 64, 0), (1, 1, 4, 4, 64, 0), (2, 77, 4, 2, 64, 0),
         (1, 1000, 2, 2, 32, 0), (1, 130, 32, 8, 128, 0),
         (2, 50, 4, 1, 16, 0), (1, 200, 2, 2, 64, 37),
         # stablelm-1.6b's heads at a ragged served length and at 2048
         (1, 1762, 32, 32, 64, 0), (1, 2048, 32, 32, 64, 0),
         # s on both sides of the bf16 kernel's 128-row q and KV tiles
         (1, 127, 4, 4, 64, 0), (1, 128, 4, 2, 64, 0), (1, 129, 4, 4, 64, 0),
         (2, 191, 4, 2, 64, 0), (1, 255, 4, 4, 128, 0), (1, 257, 4, 4, 64, 0),
         # windows that end inside a KV tile
         (1, 513, 4, 2, 64, 200), (1, 300, 2, 2, 128, 100),
         # olmoe-1b-7b's heads at its longest profiled prompt and at 2048
         (1, 1953, 16, 16, 128, 0), (1, 2048, 16, 16, 128, 0),
         # GQA 32/8 at d=128 across a tile edge, d=16 and d=32
         (1, 257, 32, 8, 128, 0), (1, 257, 4, 2, 16, 0),
         (2, 129, 4, 4, 32, 0), (1, 300, 4, 1, 16, 64)]
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
@pytest.mark.parametrize("s", [1, 127, 129, 255, 1000, 1762, 2047])
def test_flash_attention_kernel_jamba_heads(card, s, dtype):
    """jamba-v0.1-52b's attention layer: GQA 32/8 at d=128, causal, no
    window, at ragged prompt lengths on both sides of the 128-row tiles
    and up to the serve run's longest."""
    gen = torch.Generator(device=card).manual_seed(s)
    q = torch.randn(1, s, 32, 128, generator=gen, device=card).to(dtype)
    k, v = (torch.randn(1, s, 8, 128, generator=gen, device=card).to(dtype)
            for _ in range(2))
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,prefix", [(1, 0), (129, 0), (415, 0), (2048, 0),
                                      (129, 256), (415, 256), (2048, 256),
                                      (300, 100), (255, 128)])
def test_flash_attention_kernel_qwen2_vl_heads(card, s, prefix, dtype):
    """qwen2-vl-7b's attention: GQA 28/4 (seven query heads a kv head) at
    d=128, causal, at ragged lengths and 2048, plain and with a vision
    prefix (keys below ``prefix`` visible to every row; 256 exceeds 129).
    q, k and v are strided views of one tensor built by ``torch.cat``, as
    the merged vision-and-text sequence's projections may be."""
    gen = torch.Generator(device=card).manual_seed(s + prefix)
    x = torch.cat([torch.randn(1, min(prefix, s), 36, 128, generator=gen,
                               device=card),
                   torch.randn(1, s - min(prefix, s), 36, 128, generator=gen,
                               device=card)], dim=1).to(dtype)
    q, k, v = x.split([28, 4, 4], dim=2)
    assert s == 1 or not q.is_contiguous()
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, prefix=prefix)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    want = ops.flash_attention_plain(q, k, v, prefix=prefix)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,s_kv", [(127, 129), (129, 127), (128, 255),
                                    (191, 257), (257, 128), (1, 200)])
def test_flash_attention_kernel_tile_edges(card, s, s_kv, dtype):
    """s and s_kv on both sides of the 128-row tiles, with s_kv != s,
    causal and not."""
    gen = torch.Generator(device=card).manual_seed(s * 1000 + s_kv)
    q = torch.randn(1, s, 4, 64, generator=gen, device=card).to(dtype)
    k = torch.randn(1, s_kv, 2, 64, generator=gen, device=card).to(dtype)
    v = torch.randn(1, s_kv, 2, 64, generator=gen, device=card).to(dtype)
    for causal in (False, True):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1500, 416, 129, 1])
def test_flash_attention_kernel_whisper_not_causal(card, s, dtype):
    """whisper-small's launches: 12 heads of 64, not causal over its 1500
    encoder frames, from the encoder's 1500 queries and from cross
    attention's prompt rows (1500 = 11 x 128 + 92 ends inside a tile)."""
    gen = torch.Generator(device=card).manual_seed(s)
    q = torch.randn(1, s, 12, 64, generator=gen, device=card).to(dtype)
    k, v = (torch.randn(1, 1500, 12, 64, generator=gen, device=card)
            .to(dtype) for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_window_past_s_kv(card, dtype):
    """Causal with a window and s > s_kv.  Through the wrapper: s=160,
    s_kv=130, window=32, where every row sees a key, against the plain
    version; s=400, s_kv=100 refused.  The kernel itself at s=400, s_kv=100,
    window=32 over 2 x 32 heads (more q tiles than blocks, so blocks take
    a tile with no KV tile and then one with): rows with keys match the
    plain version, the others are 0."""
    gen = torch.Generator(device=card).manual_seed(7)

    def qkv(b, s, s_kv, h, kvh, d):
        return (torch.randn(b, s, h, d, generator=gen, device=card).to(dtype),
                torch.randn(b, s_kv, kvh, d, generator=gen,
                            device=card).to(dtype),
                torch.randn(b, s_kv, kvh, d, generator=gen,
                            device=card).to(dtype))

    q, k, v = qkv(1, 160, 130, 4, 2, 64)
    got = ops.flash_attention(q, k, v, causal=True, window=32)
    want = ops.flash_attention_plain(q, k, v, causal=True, window=32)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for d in (64, 128):
        q, k, v = qkv(2, 400, 100, 32, 8, d)
        with pytest.raises(ValueError, match="without a visible key"):
            ops.flash_attention(q, k, v, causal=True, window=32)
        got = ops._launch(q, k, v, True, 32, 0)
        want = ops.flash_attention_plain(q, k, v, causal=True, window=32)
        torch.cuda.synchronize()
        seen = 100 + 32 - 1  # rows 0 .. 130 see a key
        torch.testing.assert_close(got[:, :seen].float(),
                                   want[:, :seen].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert bool((got[:, seen:] == 0).all())


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


# (g, e, c, d, f): the moe_mlp sweep of tests/test_kernels.py, the ragged
# capacities of tests/test_torch_moe_mlp.py, and olmoe-1b-7b's widths
# (D=2048, F=1024, E=64) at the capacities its prefill (C=25, 276, 320)
# and decode (G=4, C=1) give
MOE_CASES = [(2, 4, 128, 64, 256), (1, 2, 64, 128, 512), (2, 2, 128, 32, 128),
             (1, 4, 1, 64, 256), (4, 4, 1, 32, 128), (1, 4, 25, 64, 256),
             (2, 3, 25, 128, 128), (1, 64, 25, 2048, 1024),
             (1, 64, 276, 2048, 1024), (1, 64, 320, 2048, 1024),
             (4, 64, 1, 2048, 1024),
             # decode steps folded into one row tile per expert, at olmoe's
             # widths and at a narrow one; G C = 65 and 129 cross the
             # 64- and 128-row tiles
             (8, 64, 1, 2048, 1024), (3, 64, 5, 2048, 1024),
             (2, 64, 17, 2048, 1024), (8, 4, 1, 64, 256), (3, 4, 5, 64, 256),
             (2, 4, 17, 64, 256), (5, 4, 13, 96, 384), (3, 2, 43, 32, 128)]
MOE_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _moe_inputs(card, g, e, c, d, f, dtype):
    gen = torch.Generator(device=card).manual_seed(g * 7 + c * 13 + d)
    x = torch.randn(g, e, c, d, generator=gen, device=card).to(dtype)
    wi, wg = (torch.randn(e, d, f, generator=gen, device=card)
              .div_(d ** 0.5).to(dtype) for _ in range(2))
    wo = torch.randn(e, f, d, generator=gen, device=card).div_(f ** 0.5)
    return x, wi, wg, wo.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,e,c,d,f", MOE_CASES)
def test_moe_mlp_kernel(card, g, e, c, d, f, dtype):
    x, wi, wg, wo = _moe_inputs(card, g, e, c, d, f, dtype)
    n0 = moe_ops.expert_mlp.launches
    got = moe_ops.expert_mlp(x, wi, wg, wo)
    torch.cuda.synchronize()
    assert moe_ops.expert_mlp.launches == n0 + 1
    want = moe_ops.expert_mlp_plain(x, wi, wg, wo)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=MOE_TOL[dtype], rtol=MOE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 40])
def test_moe_mlp_kernel_large_d_ff(card, c, dtype):
    """jamba-v0.1-52b's d_ff (14336) does not fit a block's shared memory
    whole: the split schedule, 14 tiles of 1024 summed in f32."""
    x, wi, wg, wo = _moe_inputs(card, 1, 2, c, 256, 14336, dtype)
    got = moe_ops.expert_mlp(x, wi, wg, wo)
    want = moe_ops.expert_mlp_plain(x, wi, wg, wo)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=MOE_TOL[dtype], rtol=MOE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 64])
def test_moe_mlp_kernel_keeps_h_in_f32(card, c):
    """In bf16 the kernel's outputs differ from the plain version's (f32
    h) in fewer places than they would with h rounded to bf16 before the
    down projection."""
    args = _moe_inputs(card, 1, 8, c, 256, 512, torch.bfloat16)
    got = moe_ops.expert_mlp(*args)
    want = moe_ops.expert_mlp_plain(*args)
    x, wi, wg, wo = (t.float() for t in args)
    h = torch.einsum("gecd,edf->gecf", x, wi)
    h = h * torch.sigmoid(h) * torch.einsum("gecd,edf->gecf", x, wg)
    rounded = torch.einsum("gecf,efd->gecd", h.bfloat16().float(), wo)
    share = (got != want).float().mean()
    assert share < (rounded.bfloat16() != want).float().mean()


# (b, s, h, n, chunk): the sweep of tests/test_kernels.py, then ragged s
# and rwkv6-7b's heads at a served length
WKV_CASES = [(2, 128, 2, 64, 64), (1, 256, 4, 32, 32), (2, 64, 1, 16, 16),
             (1, 96, 2, 32, 32), (1, 1, 2, 64, 32), (2, 77, 2, 16, 32),
             (1, 1036, 2, 64, 64), (1, 300, 64, 64, 32)]
WKV_TOL = {torch.float32: 5e-4, torch.bfloat16: 8e-3}


def _wkv_inputs(card, b, s, h, n, dtype, w0=-1.0, seed=0, w0_hi=None):
    """lw = -exp(w0 + 0.5 N(0, 1)); with ``w0_hi``, w0 is drawn per
    channel on [w0, w0_hi], as chip_smoke.py and the model feed it."""
    gen = torch.Generator(device=card).manual_seed(seed + s * 7 + h + n)
    r, k, v = (torch.randn(b, s, h, n, generator=gen, device=card).to(dtype)
               for _ in range(3))
    if w0_hi is not None:
        w0 = torch.empty(h, n, device=card).uniform_(w0, w0_hi,
                                                     generator=gen)
    lw = -torch.exp(w0 + 0.5 * torch.randn(b, s, h, n, generator=gen,
                                           device=card))
    u = 0.5 * torch.randn(h, n, generator=gen, device=card)
    state0 = torch.randn(b, h, n, n, generator=gen, device=card)
    return r, k, v, lw, u, state0


@pytest.mark.gpu
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,n,chunk", WKV_CASES)
def test_wkv6_kernel(card, b, s, h, n, chunk, dtype, with_state):
    r, k, v, lw, u, state0 = _wkv_inputs(card, b, s, h, n, dtype)
    state0 = state0 if with_state else None
    n0 = wkv_ops.wkv6.launches
    y, st = wkv_ops.wkv6_state(r, k, v, lw, u, state0, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_ops.wkv6.launches == n0 + 1
    y_want, st_want = wkv_ops.wkv6_state_plain(r, k, v, lw, u, state0)
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_want.float(),
                               atol=WKV_TOL[dtype], rtol=WKV_TOL[dtype])
    torch.testing.assert_close(st, st_want, atol=5e-4, rtol=5e-4)


@pytest.mark.gpu
def test_wkv6_kernel_strong_and_slow_decay(card):
    """w = 1e-3 (tests/test_kernels.py's strong decay) stays finite; w
    close to 1 (w0 = -6) carries the state over all 2048 tokens."""
    r, k, v, _, _, _ = _wkv_inputs(card, 1, 128, 1, 32, torch.float32)
    w = torch.full_like(r, 1e-3)
    u = torch.zeros(1, 32, device=card)
    y = wkv_ops.wkv6(r, k, v, w, u, chunk=64)
    y_want, _ = wkv_ops.wkv6_state_plain(r, k, v, torch.log(w), u)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, y_want, atol=1e-3, rtol=1e-3)
    r, k, v, lw, u, state0 = _wkv_inputs(card, 1, 2048, 2, 64, torch.float32,
                                         w0=-6.0)
    y, st = wkv_ops.wkv6_state(r, k, v, lw, u, state0, chunk=32)
    y_want, st_want = wkv_ops.wkv6_state_plain(r, k, v, lw, u, state0)
    torch.testing.assert_close(y, y_want, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(st, st_want, atol=5e-4, rtol=5e-4)


def _wkv_check(card, r, k, v, lw, u, state0, chunk):
    """One launch against the plain version: y within WKV_TOL of 1 + |y|,
    the final state within 5e-4 of 1 + |S|, both finite."""
    n0 = wkv_ops.wkv6.launches
    y, st = wkv_ops.wkv6_state(r, k, v, lw, u, state0, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_ops.wkv6.launches == n0 + 1
    y_want, st_want = wkv_ops.wkv6_state_plain(r, k, v, lw, u, state0)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    tol = WKV_TOL[r.dtype]
    torch.testing.assert_close(y.float(), y_want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, st_want, atol=5e-4, rtol=5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_strong_decay_from_a_state(card, dtype, chunk):
    """w = 1e-3 (lw ~ -6.9 a token) over several chunks and sub-chunks
    from a random state: the decays' products underflow within a few
    tokens, and nothing overflows."""
    r, k, v, _, u, state0 = _wkv_inputs(card, 1, 200, 2, 64, dtype)
    lw = torch.full(r.shape, math.log(1e-3), device=card)
    _wkv_check(card, r, k, v, lw, u, state0, chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("extra", [-1, 1, 33])
def test_wkv6_kernel_chunk_edges(card, dtype, chunk, extra):
    """chip_smoke.py's draw of lw (w0 per channel on [-6, 1], down to ~-7
    a token) at s = L - 1, L + 1 and 2 L + 1 for L = 16 (the bf16 kernel's
    sub-chunk) and 32 (its chunk), passed as the chunk, from a random
    state."""
    s = chunk + extra if extra != 33 else 2 * chunk + 1
    r, k, v, lw, u, state0 = _wkv_inputs(card, 1, s, 2, 64, dtype, w0=-6.0,
                                         w0_hi=1.0, seed=chunk)
    _wkv_check(card, r, k, v, lw, u, state0, chunk)


@pytest.mark.gpu
def test_wkv6_kernel_slow_decay_bf16(card):
    """w0 = -6 (decays of ~0.9975 a token) in bf16: the state adds up over
    all 2048 tokens and 64 chunks from a random state."""
    r, k, v, lw, u, state0 = _wkv_inputs(card, 1, 2048, 2, 64,
                                         torch.bfloat16, w0=-6.0)
    _wkv_check(card, r, k, v, lw, u, state0, 32)


def _quantize_exact(x):
    n0 = q_ops.quantize.launches
    q, s = q_ops.quantize_blocks(x)
    torch.cuda.synchronize()
    assert q_ops.quantize.launches == n0 + 1
    qp, sp = quantize_plain(x)
    assert torch.equal(q, qp)
    assert torch.equal(s.view(torch.int32), sp.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("n", [256, 1000, 4096, 65536, 3 * 256 + 5])
def test_quantize_kernel(card, n, block):
    """tests/test_kernels.py's sweep plus a ragged nb, through the padding
    wrapper, bit for bit."""
    gen = torch.Generator(device=card).manual_seed(n + block)
    x = torch.randn(n, generator=gen, device=card) * 3.0
    q, s, pad = q_ops.quantize(x, block=block)
    qp, sp = quantize_plain(torch.nn.functional.pad(x, (0, pad))
                            .reshape(-1, block))
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [128, 256])
def test_quantize_kernel_edge_rows(card, block):
    """Exact half-quanta, an all-zero row, absmax 1e-30 and 1e30, many
    rows (grid stride) and a NaN row."""
    gen = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(4099, block, generator=gen, device=card)
    k = torch.arange(block - 2, device=card, dtype=torch.float32)
    x[0, :-2] = (k - (block // 2 - 1) + 0.5) * 0.5   # x / scale = k + 0.5
    x[0, -2:] = torch.tensor([63.5, 0.0])            # scale 0.5
    x[1] = 0.0
    x[2] *= 1e-30
    x[3] *= 1e30
    _quantize_exact(x)
    q, s = q_ops.quantize_blocks(x)
    assert float(s[1]) == torch.tensor(1e-12).item() and not q[1].any()
    x[4, 3] = float("nan")
    q, s = q_ops.quantize_blocks(x)
    assert torch.isnan(s[4]) and torch.isnan(quantize_plain(x)[1][4])


@pytest.mark.gpu
def test_train_step_on_the_card(card):
    """Two steps of a smoke stablelm with grad_compress on the card: one
    quantize launch per parameter leaf per step, no forward-only kernel,
    and the same losses as the CPU run from the same state (bf16 compute:
    GEMMs sum in other orders, so 2e-2)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.models.common import leaves, map_leaves
    from repro_torch.train import (TrainOptions, batch_to, build_train_step,
                                   init_train_state)
    cfg = smoke(get_config("stablelm-1.6b"))
    model = build_model(cfg)
    opts = TrainOptions(warmup=1, total_steps=4, grad_compress=True)
    cpu = init_train_state(model, 0, opts, "cpu")
    gpu = {k: map_leaves(lambda t: t.detach().to(card), v)
           for k, v in cpu.items()}
    map_leaves(lambda p: p.requires_grad_(True), gpu["params"])
    step = build_train_step(model, opts)
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", 32, 4, "train"), seed=0)
    n_leaves = len(list(leaves(cpu["params"])))
    counts = (q_ops.quantize, ops.flash_attention, moe_ops.expert_mlp,
              wkv_ops.wkv6)
    for i in range(2):
        b = pipe.batch(i)
        before = [c.launches for c in counts]
        gpu, mg = step(gpu, batch_to(b, card))
        torch.cuda.synchronize()
        after = [c.launches for c in counts]
        assert after[0] - before[0] == n_leaves == 15
        assert after[1:] == before[1:]
        cpu, mc = step(cpu, batch_to(b, "cpu"))
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(mg[k]) - float(mc[k])) <= 2e-2 * abs(float(mc[k]))


@pytest.mark.gpu
def test_smoke_jamba_serves_through_the_kernels(card, monkeypatch):
    """smoke(jamba-v0.1-52b) in bf16 on the card: a prefill launches the
    flash kernel once (the attention position) and moe_mlp four times
    (the odd positions), each decode step moe_mlp four times and flash
    never; the prefill and two decode steps agree with the same model
    with both wrappers replaced by their plain versions, within 2e-2 of
    the largest logit (the two sum in other orders, which flips bf16
    roundings by an ulp)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import build_model, layers, moe
    model = build_model(smoke(get_config("jamba-v0.1-52b")))
    params = model.load(model.init(0, "cpu"), card)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 256, (2, 42), generator=gen).to(card)

    def run():
        n0 = (ops.flash_attention.launches, moe_ops.expert_mlp.launches)
        logits, cache = model.prefill(params, {"tokens": toks[:, :40]},
                                      seq_capacity=64)
        out = [logits]
        for i in range(2):
            step, cache = model.decode(params, {"tokens": toks[:, 40 + i:
                                                                41 + i]},
                                       cache, 40 + i)
            out.append(step)
        torch.cuda.synchronize()
        return out, (ops.flash_attention.launches - n0[0],
                     moe_ops.expert_mlp.launches - n0[1])

    got, launched = run()
    assert launched == (1, 4 * 3)
    monkeypatch.setattr(layers, "flash_attention", ops.flash_attention_plain)
    monkeypatch.setattr(moe, "expert_mlp", moe_ops.expert_mlp_plain)
    want, launched = run()
    assert launched == (0, 0)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.gpu
def test_qwen2_vl_prefill_through_the_kernel(card, monkeypatch):
    """qwen2-vl-7b at full width cut to 2 of its 28 layers, in bf16: a
    prefill of 256 vision and 159 text tokens launches the flash kernel
    once a layer and agrees with the same model with the plain version
    in the kernel's place, within 2e-2 of the largest logit, with the
    same argmax; a decode step launches nothing."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, layers
    cfg = dataclasses.replace(get_config("qwen2-vl-7b"), n_layers=2)
    model = build_model(cfg)
    params = model.load(model.init(0, card), card)
    gen = torch.Generator(device=card).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 159),
                                     generator=gen, device=card),
             "vision_embeds": 0.1 * torch.randn(1, cfg.n_vis, cfg.d_model,
                                                generator=gen, device=card)}

    def run():
        n0 = ops.flash_attention.launches
        logits, cache = model.prefill(params, batch, seq_capacity=512)
        launched = ops.flash_attention.launches - n0
        step, _ = model.decode(params, {"tokens": batch["tokens"][:, :1]},
                               cache, 415)
        torch.cuda.synchronize()
        assert ops.flash_attention.launches - n0 == launched
        return logits[0, -1].float(), launched

    got, launched = run()
    assert launched == cfg.n_layers
    monkeypatch.setattr(layers, "flash_attention", ops.flash_attention_plain)
    want, launched = run()
    assert launched == 0
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    assert int(got.argmax()) == int(want.argmax())


@pytest.mark.gpu
def test_smoke_whisper_serves_through_the_kernel(card):
    """smoke(whisper-small) in bf16: a prefill on the card launches the
    flash kernel once per encoder layer and twice per decoder layer (self
    and cross attention), a decode step never; the card's prefill and
    decode logits lie within 2e-2 of the largest of the CPU's (the plain
    path; the two sum in other orders).  The server on the card serves
    requests with frames, 10 launches a request, and each request's first
    token is the CPU prefill's argmax wherever the CPU's top-2 gap
    exceeds twice that tolerance (each logit may move by it)."""
    import numpy as np
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import build_model
    from repro_torch.serve import BatchServer, Request
    cfg = smoke(get_config("whisper-small"))
    model = build_model(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 256, (2, 20), generator=gen),
             "enc_embeds": 0.1 * torch.randn(2, cfg.enc_seq, cfg.d_model,
                                             generator=gen)}

    def run(dev):
        p = model.load(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        n0 = ops.flash_attention.launches
        logits, cache = model.prefill(p, b, seq_capacity=32)
        launched = ops.flash_attention.launches - n0
        step, _ = model.decode(p, {"tokens": b["tokens"][:, :1]}, cache, 20)
        assert ops.flash_attention.launches - n0 == launched
        return [logits.float().cpu(), step.float().cpu()], launched

    got, launched_card = run(card)
    assert launched_card == cfg.enc_layers + 2 * cfg.n_layers
    want, launched = run(torch.device("cpu"))
    assert launched == 0
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 2e-2 * float(w.abs().max())
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, n),
             (rng.standard_normal((cfg.enc_seq, cfg.d_model)) * 0.1
              ).astype(np.float32)) for n in (5, 9, 3)]
    srv = BatchServer(model, params, slots=2, seq_capacity=32, device=card)
    n0 = ops.flash_attention.launches
    done = srv.serve([Request(rid=i, prompt=p, max_new_tokens=4,
                              extras={"enc_embeds": e})
                      for i, (p, e) in enumerate(reqs)])
    assert ops.flash_attention.launches - n0 == 3 * launched_card
    cpu = model.load(params, "cpu")
    for r in done:
        assert len(r.output) == 4
        p, e = reqs[r.rid]
        lg, _ = model.prefill(cpu, {"tokens": torch.as_tensor(p)[None],
                                    "enc_embeds": torch.as_tensor(e)[None]})
        top2 = torch.topk(lg[0, -1].float(), 2).values
        if float(top2[0] - top2[1]) > 4e-2 * float(lg.float().abs().max()):
            assert r.output[0] == int(lg[0, -1].float().argmax())


@pytest.mark.gpu
def test_dry_run_on_the_card_launches_and_allocates_nothing(card):
    """DryRunBackend on fake CUDA tensors, on the card: a smoke olmoe
    prefill reaches the flash and moe_mlp ops once per layer, a smoke
    train step with grad_compress the quantize op once per leaf; no
    launch is counted and the card's allocated memory does not move."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.fidelity import (DryRunBackend, StepProgram,
                                           TensorSpec, eval_shape, specs_of)
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.serve.step import build_prefill_step
    from repro_torch.train import (TrainOptions, batch_to, build_train_step,
                                   init_train_state)
    model = build_model(smoke(get_config("olmoe-1b-7b")))
    opts = TrainOptions(grad_compress=True)
    pipe = SyntheticPipeline(model.cfg, ShapeConfig("t", 32, 4, "train"))
    progs = [
        (StepProgram("prefill", build_prefill_step(model),
                     (eval_shape(lambda: model.load(model.init(0, "cpu"),
                                                    "cpu")),
                      {"tokens": TensorSpec((2, 64), torch.int64)}),
                     device=card),
         {"flash_attention": 4, "expert_mlp": 4}),
        (StepProgram("train", build_train_step(model, opts),
                     (eval_shape(lambda: init_train_state(model, 0, opts,
                                                          "cpu")),
                      specs_of(batch_to(pipe.batch(0), "cpu"))),
                     device=card),
         {"quantize_blocks": 15})]          # one per parameter leaf
    counts = (q_ops.quantize, ops.flash_attention, moe_ops.expert_mlp,
              wkv_ops.wkv6)
    for prog, want in progs:
        torch.cuda.synchronize()
        mem0, n0 = torch.cuda.memory_allocated(), [c.launches for c in counts]
        rep = DryRunBackend().run(prog)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == mem0
        assert [c.launches for c in counts] == n0
        assert rep.detail["kernels"] == want
        assert rep.flops > 0 and rep.bytes_accessed > 0
