"""The CUDA kernels against their plain PyTorch versions on the card,
at shapes the main path does not reach (a pyramid deeper than one tile,
rows narrower than a tile, real input, an AGC window too large for
shared memory).  They need a CUDA device and skip elsewhere; run them
on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which the card's
machine does not have and these tests do not use).
"""

import numpy as np
import pytest
import torch

from phantomsdr_tpu_torch.ops.agc import AGCState, make_agc_params
from phantomsdr_tpu_torch.ops.cuda import agc, pll, waterfall

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


@pytest.mark.parametrize("r,levels,real", [
    (1 << 12, 3, False), (1 << 12, 13, False), (1 << 14, 5, False),
    (1 << 9, 10, False), (1 << 13, 14, True), (1 << 20, 11, False),
])
def test_waterfall_kernel_matches_plain(dev, r, levels, real):
    g = torch.Generator(device=dev).manual_seed(r + levels)
    width = r + 1 if real else r
    spec = (torch.randn(5, width, dtype=torch.complex64, device=dev,
                        generator=g)
            * 10 ** (torch.rand(5, width, device=dev, generator=g) * 6 - 6))
    spec[1, :9] = 0
    rows = torch.tensor([4, 1, 1, 0], dtype=torch.int32, device=dev)
    kw = dict(fft_result_size=r, base_idx=0 if real else r // 2 + 1,
              levels=levels, size_log2=int(np.log2(r)))
    before = waterfall.KERNEL.launches
    got = waterfall.waterfall_rows(spec, rows, **kw)
    want = waterfall.waterfall_rows_plain(spec, rows, **kw)
    assert waterfall.KERNEL.launches == before + 1
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3


def test_pll_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    c, n = 7, 3000
    t = torch.arange(n, device=dev, dtype=torch.float32)
    car = torch.polar(torch.ones(c, n, device=dev),
                      0.003 * t + torch.rand(c, 1, device=dev, generator=g))
    base = (car * (1 + 0.5 * torch.sin(0.05 * t))).contiguous()
    carrier = (car + 0.05 * torch.randn(c, n, dtype=torch.complex64,
                                        device=dev, generator=g)).contiguous()
    p0 = torch.rand(c, device=dev, generator=g) * 6
    f0 = torch.zeros(c, device=dev)
    got = pll.am_sync_detect(carrier, base, p0, f0)
    want = pll.am_sync_detect_plain(carrier, base, p0, f0)
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * float(
        base.abs().max())
    assert torch.allclose(got[2], want[2], atol=1e-6)


@pytest.mark.parametrize("sr,b,half", [(2000, 4, 22), (12000, 36, 180),
                                       (192000, 2, 1000)])
def test_agc_kernel_matches_plain(dev, sr, b, half):
    """(192000: the window is 38400 samples, past shared memory, so the
    kernel runs on its device scratch buffer.)"""
    g = torch.Generator(device=dev).manual_seed(sr)
    params = make_agc_params(sr)
    w = params.window
    c = 8
    x = torch.randn(c, b * half, device=dev, generator=g) * 0.05
    x[:, ::41] *= 9
    state = AGCState(
        tail=torch.randn(c, w - 1, device=dev, generator=g) * 0.05,
        gain=torch.rand(c, device=dev, generator=g) * 4,
        seen=torch.tensor([0, 1, w // 3, w - 2, w - 1, w, w, 0],
                          dtype=torch.int32, device=dev))
    out_k = torch.empty(b, c, half, dtype=torch.int16, device=dev)
    out_p = torch.empty_like(out_k)
    st_k = agc.agc_int16(state, x, params, out_k)
    st_p = agc.agc_int16_plain(state, x, params, out_p)
    assert int((out_k.int() - out_p.int()).abs().max()) <= 1
    assert torch.equal(st_k.tail, st_p.tail)
    assert torch.equal(st_k.seen, st_p.seen)
    assert torch.allclose(st_k.gain, st_p.gain, rtol=1e-5)


def test_kernel_wrapper_rejects_wrong_index_dtype(dev):
    spec = torch.zeros(2, 64, dtype=torch.complex64, device=dev)
    rows = torch.zeros(1, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        waterfall.waterfall_rows(spec, rows, fft_result_size=64, base_idx=0,
                                 levels=2, size_log2=6)
