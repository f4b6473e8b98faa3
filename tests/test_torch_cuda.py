"""The CUDA kernels against their plain PyTorch versions on the card,
at shapes the main path does not reach (a pyramid deeper than one
chunk, rows narrower than a chunk, other rolls, misaligned input and
output rows, real input, AGC windows and lengths at the edges of its
128-sample blocks and 1024-sample chunks; the WBFM kernels at odd
lengths and with masked rows, K-PILOT's sine over every float32 of the
wrapped phase's range and its rare wraps; the noise processors at
other orders, blocks and frame counts).  They need a
CUDA device and skip elsewhere; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which the card's
machine does not have and these tests do not use).
"""

import numpy as np
import pytest
import torch

from phantomsdr_tpu_torch.ops.agc import AGCState, agc_process, make_agc_params
from phantomsdr_tpu_torch.ops.channelizer import float_to_int16
from phantomsdr_tpu_torch.ops.cuda import (
    agc, anr, deemph, nb, nr, pilot, pll, waterfall,
)
from phantomsdr_tpu_torch.ops.deemph import deemph_alpha
from phantomsdr_tpu_torch.ops.nb import fir_fresh
from phantomsdr_tpu_torch.ops.nr import make_nr_params
from phantomsdr_tpu_torch.ops.polyphase import design_lowpass, fir
from phantomsdr_tpu_torch.ops.stereo import make_stereo_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


ROWS = (4, 1, 1, 0)


@pytest.mark.parametrize("r,levels,real,base_idx,extra,rows", [
    (1 << 12, 3, False, None, 0, ROWS), (1 << 12, 13, False, None, 0, ROWS),
    (1 << 14, 5, False, None, 0, ROWS), (1 << 9, 10, False, None, 0, ROWS),
    (1 << 13, 14, True, None, 0, ROWS), (1 << 20, 11, False, None, 0, ROWS),
    # an arbitrary odd roll, and one past R: the wrap falls inside a
    # lane's 8 bins
    (1 << 14, 12, False, 12345, 0, ROWS),
    (1 << 12, 11, False, 3 * (1 << 12) + 5, 0, ROWS),
    # rows wider than R, by an odd count: rows alternate between 8- and
    # 16-byte alignment
    (1 << 12, 8, False, None, 37, ROWS),
    # real rows of R + 1 bins (odd row stride) through the chunk path
    (1 << 12, 12, True, None, 0, ROWS),
    # P odd (output rows misaligned) with every level in one chunk;
    # pyramids that end inside the block stage and after level 1
    (1 << 11, 12, False, None, 0, ROWS), (1 << 12, 10, False, None, 0, ROWS),
    (1 << 12, 2, False, None, 0, ROWS),
    # deeper than one chunk: a second pass over 32 per-chunk sums a row
    (1 << 16, 17, False, None, 0, ROWS),
    # one row due three times
    (1 << 12, 12, False, None, 0, (2, 2, 2)),
])
def test_waterfall_kernel_matches_plain(dev, r, levels, real, base_idx, extra,
                                        rows):
    """The kernel keeps the plain version's arithmetic and pair order, so
    the two are equal byte for byte."""
    g = torch.Generator(device=dev).manual_seed(r + levels)
    width = r + 1 if real else r + extra
    spec = (torch.randn(5, width, dtype=torch.complex64, device=dev,
                        generator=g)
            * 10 ** (torch.rand(5, width, device=dev, generator=g) * 6 - 6))
    spec[1, :9] = 0
    rows = torch.tensor(rows, dtype=torch.int32, device=dev)
    if base_idx is None:
        base_idx = 0 if real else r // 2 + 1
    kw = dict(fft_result_size=r, base_idx=base_idx, levels=levels,
              size_log2=int(np.log2(r)))
    before = waterfall.KERNEL.launches
    got = waterfall.waterfall_rows(spec, rows, **kw)
    want = waterfall.waterfall_rows_plain(spec, rows, **kw)
    assert waterfall.KERNEL.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,n,phase0,freq0", [
    (7, 3000, "rand", 0.0),
    # phase0 at 0 and just below 2*pi: the wrap's edges
    (7, 3000, 0.0, 0.0), (7, 3000, 2 * np.pi - 1e-6, 0.0),
    # freq0 7.0: phase + freq passes 2*pi, so the subtraction wraps;
    # 13.0 >= 4*pi: the fmodf branch runs
    (7, 3000, "rand", 7.0), (7, 3000, "rand", 13.0),
    # more blocks than SMs; odd and short rows
    (300, 1000, "rand", 0.0), (5, 3001, "rand", 0.0), (3, 100, "rand", 0.0),
    # past one chain launch's 16384 samples: two launches carry the loop
    (3, 17385, "rand", 0.0),
])
def test_pll_kernel_matches_plain(dev, c, n, phase0, freq0):
    """(L = 3001, 17385: not a multiple of the chain's four-sample
    groups.)"""
    g = torch.Generator(device=dev).manual_seed(3)
    t = torch.arange(n, device=dev, dtype=torch.float32)
    car = torch.polar(torch.ones(c, n, device=dev),
                      0.003 * t + torch.rand(c, 1, device=dev, generator=g))
    base = (car * (1 + 0.5 * torch.sin(0.05 * t))).contiguous()
    carrier = (car + 0.05 * torch.randn(c, n, dtype=torch.complex64,
                                        device=dev, generator=g)).contiguous()
    p0 = (torch.rand(c, device=dev, generator=g) * 6 if phase0 == "rand"
          else torch.full((c,), phase0, dtype=torch.float32, device=dev))
    f0 = torch.full((c,), freq0, dtype=torch.float32, device=dev)
    before = pll.KERNEL.launches
    got = pll.am_sync_detect(carrier, base, p0, f0)
    want = pll.am_sync_detect_plain(carrier, base, p0, f0)
    assert pll.KERNEL.launches == before + 1
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * float(
        base.abs().max())
    assert torch.allclose(got[1], want[1], atol=1e-5)
    assert torch.allclose(got[2], want[2], atol=1e-6)


# warm-up points t0 = W-1-seen (clamped to [0, L]), where the kernel's
# chain starts: at 0, inside its first 1024-sample chunk on and off its
# four-sample groups (3, 511, 1023 leave a scalar head), at the start of
# the second chunk (1024), past it (1025), two samples before the end of
# an L = 1539 row (1537) and at L (or as far as a seen >= 0 allows)
EDGES = (0, 3, 511, 1023, 1024, 1025, 1537, None)


@pytest.mark.parametrize("sr,b,half,seen", [
    (2000, 4, 22, "mixed"), (12000, 36, 180, "mixed"),
    (192000, 2, 1000, "mixed"),
    (12000, 36, 180, "warm_up_edges"), (192000, 2, 1000, "warm_up_edges"),
    # L = 1539, not a multiple of four or of the chunk
    (12000, 9, 171, "warm_up_edges"),
    # windows of 20 (inside one 128-sample block of the window max) and
    # 200 samples (two or three blocks)
    (100, 5, 13, "mixed"), (1000, 3, 37, "mixed"),
])
def test_agc_kernel_matches_plain(dev, sr, b, half, seen):
    """(192000: a window of 38,400 samples, formed chunk by chunk from
    a table of block maxes in shared memory.)"""
    g = torch.Generator(device=dev).manual_seed(sr)
    params = make_agc_params(sr)
    w = params.window
    c = 8
    n = b * half
    x = torch.randn(c, n, device=dev, generator=g) * 0.05
    x[:, ::41] *= 9
    seen_v = ([0, 1, w // 3, w - 2, w - 1, w, w, 0] if seen == "mixed"
              else [max(w - 1 - n, 0) if t0 is None else w - 1 - t0
                    for t0 in EDGES])
    state = AGCState(
        tail=torch.randn(c, w - 1, device=dev, generator=g) * 0.05,
        gain=torch.rand(c, device=dev, generator=g) * 4,
        seen=torch.tensor(seen_v, dtype=torch.int32, device=dev))
    out_k = torch.empty(b, c, half, dtype=torch.int16, device=dev)
    out_p = torch.empty_like(out_k)
    before = agc.KERNEL.launches
    st_k = agc.agc_int16(state, x, params, out_k)
    st_p = agc.agc_int16_plain(state, x, params, out_p)
    assert agc.KERNEL.launches == before + 1
    assert int((out_k.int() - out_p.int()).abs().max()) <= 1
    assert torch.equal(st_k.tail, st_p.tail)
    assert torch.equal(st_k.seen, st_p.seen)
    assert torch.allclose(st_k.gain, st_p.gain, rtol=1e-5)


@pytest.mark.parametrize("n", [1001, 6480])
def test_pll_chain_probe_runs_the_kernels_loop(dev, n):
    """On a carrier that repeats four samples (the probe keeps four in
    registers; L % 4 <= 1, as its tail reuses the first), the probe and
    the kernel end on the same phase and frequency bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n)
    c = 5
    four = torch.polar(torch.ones(c, 4, device=dev),
                       torch.rand(c, 4, device=dev, generator=g) * 0.2)
    carrier = four.repeat(1, -(-n // 4))[:, :n].contiguous()
    p0 = torch.rand(c, device=dev, generator=g) * 6
    f0 = torch.zeros(c, device=dev)
    phase, freq = pll.chain_probe(carrier, p0, f0)
    _, k_phase, k_freq = pll.am_sync_detect(carrier, carrier, p0, f0)
    assert torch.equal(phase, k_phase) and torch.equal(freq, k_freq)


@pytest.mark.parametrize("n", [1001, 6480])
def test_agc_chain_probe_runs_the_kernels_loop(dev, n):
    """The probe's gain after L steps over desired = |x[:, :4]| repeated
    (L % 4 <= 1, as its tail reuses the first) equals the kernel's
    recursion done in numpy float32."""
    g = torch.Generator(device=dev).manual_seed(n)
    params = make_agc_params(12000)
    c = 8
    x = torch.randn(c, n, device=dev, generator=g)
    gain0 = torch.rand(c, device=dev, generator=g) * 4
    got = agc.chain_probe(x, gain0, params).cpu().numpy()
    d = np.abs(x[:, :4].cpu().numpy())
    att = np.float32(params.attack_coeff)
    rel = np.float32(params.release_coeff)
    gain = gain0.cpu().numpy()
    for t in range(n):
        dt = d[:, t % 4 if t < n - n % 4 else 0]
        gain = np.where(dt < gain, gain - att * (gain - dt),
                        gain + rel * (dt - gain)).astype(np.float32)
    assert np.array_equal(got, gain)


def test_kernel_wrapper_rejects_wrong_index_dtype(dev):
    spec = torch.zeros(2, 64, dtype=torch.complex64, device=dev)
    rows = torch.zeros(1, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        waterfall.waterfall_rows(spec, rows, fft_result_size=64, base_idx=0,
                                 levels=2, size_log2=6)


def mpx_rows(c, n, dev, seed):
    """[C, n] FM multiplex-like rows (pilot, DSB, noise) at other levels,
    and a pilot bandpassed from them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(n, device=dev, dtype=torch.float32) / 192000
    th = 2 * np.pi * 19000.0 * t + torch.rand(c, 1, device=dev, generator=g)
    x = (0.3 * torch.sin(2 * np.pi * 800 * t) + 0.09 * torch.cos(th)
         + 0.2 * torch.sin(2 * np.pi * 1300 * t) * torch.cos(2 * th)
         + 0.02 * torch.randn(c, n, device=dev, generator=g))
    x = x * (1 + torch.arange(c, device=dev)[:, None] % 3)
    p = make_stereo_params(192000)
    y = fir(torch.cat([torch.zeros(c, p.taps.shape[0] - 1, device=dev), x],
                      1), p.taps)
    return x.contiguous(), y.contiguous(), p.f_nom


@pytest.mark.parametrize("c,n,mixes", [
    (5, 3001, "both"), (4, 40272, "stereo"), (3, 32768, "rds"),
    # odd, not a whole number of the chain's 32-sample register ring;
    # short rows (under one ring)
    (3, 33771, "both"), (7, 5, "both"), (2, 1000, "none"),
])
def test_pilot_kernel_matches_plain(dev, c, n, mixes):
    """Over two calls that carry phase and freq: ph, L/R and I/Q within
    1e-5 * max|x| (the K-PLL bound: only sin/cos may round otherwise),
    carries equal; FM-masked rows pass mono."""
    x, y, f_nom = mpx_rows(c, 2 * n, dev, n)
    fm = torch.arange(c, device=dev) % 3 != 1
    tol = 1e-5 * float(x.abs().max())
    kc = pc = (torch.zeros(c, device=dev), torch.zeros(c, device=dev))
    for k in range(2):
        xs, ys = x[:, k * n:(k + 1) * n].contiguous(), y[:, k * n:(k + 1) * n].contiguous()
        kw = dict(xs=xs if mixes in ("both", "stereo") else None,
                  fm_mask=fm, xr=xs if mixes in ("both", "rds") else None)
        before = pilot.KERNEL.launches
        got = pilot.pilot_mix(*kc, f_nom, ys, **kw)
        want = pilot.pilot_mix_plain(*pc, f_nom, ys, **kw)
        assert pilot.KERNEL.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert float((got[2] - want[2]).abs().max()) <= tol
        for g_, w_ in zip(got[3:], want[3:]):
            assert (g_ is None) == (w_ is None)
            if g_ is not None:
                assert g_.shape == (2 * c, n)
                assert float((g_ - w_).abs().max()) <= tol
        if got[3] is not None:
            mono = ~fm
            assert torch.equal(got[3][0::2][mono], xs[mono])
            assert torch.equal(got[3][1::2][mono], xs[mono])
        kc, pc = got[:2], want[:2]


@pytest.mark.parametrize("n,body", [(1001, 0), (40272, 0), (1001, 1),
                                    (40272, 1)])
def test_pilot_chain_probe_runs_the_kernels_loop(dev, n, body):
    """On a pilot that repeats four samples (L % 4 <= 1, as the probe's
    tail reuses the first), the probe and the kernel end on the same
    phase and frequency bit for bit, with both of the probe's loop
    bodies (the kernel's, the earlier design's libdevice sinf): the two
    compute the same values."""
    g = torch.Generator(device=dev).manual_seed(n)
    c = 5
    four = torch.randn(c, 4, device=dev, generator=g) * 0.1
    y = four.repeat(1, -(-n // 4))[:, :n].contiguous()
    p0 = torch.rand(c, device=dev, generator=g) * 6
    f0 = torch.zeros(c, device=dev)
    f_nom = make_stereo_params(192000).f_nom
    phase, freq = pilot.chain_probe(y, p0, f0, f_nom, body)
    k_phase, k_freq, _, _, _ = pilot.pilot_mix(p0, f0, f_nom, y)
    assert torch.equal(phase, k_phase) and torch.equal(freq, k_freq)


def test_pilot_sine_equals_sinf_on_every_wrapped_phase(dev):
    """The kernel's sine (csrc/wrapped_sin.cuh) equals libdevice sinf in
    every bit on every float32 in [-0, 2*pi], 2*pi as the kernel's
    float32 (0x40c90fdb): 1,086,918,621 values."""
    top = int(np.float32(2 * np.pi).view(np.uint32))
    assert top == 0x40C90FDB
    checked, differ = pilot.sin_check(dev)
    assert checked == top + 2
    assert differ == 0


def test_pilot_kernel_phase0_anywhere_and_the_fmod_wrap(dev):
    """Over two chained calls of 40,000 samples (past the old 32,768-
    sample piece): phase0 outside [0, 2*pi] (-20, 100) takes sinf once
    before the loop; a pilot spike of 1e7 drives freq past 4*pi, so every
    later step wraps through fmodf, on the first sample (phase0 1) and in
    the middle of a row.  Carries equal to pilot_track_plain, ph within
    the K-PLL bound."""
    c, n = 4, 40000
    x, y, f_nom = mpx_rows(c, 2 * n, dev, 5)
    y[2, 0] = 1e7
    y[3, 20000] = -1e7
    tol = 1e-5 * float(x.abs().max())
    kc = pc = (torch.tensor([-20.0, 100.0, 1.0, 3.0], device=dev),
               torch.zeros(c, device=dev))
    for k in range(2):
        ys = y[:, k * n:(k + 1) * n].contiguous()
        got = pilot.pilot_mix(*kc, f_nom, ys)
        want = pilot.pilot_mix_plain(*pc, f_nom, ys)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert float((got[2] - want[2]).abs().max()) <= tol
        kc, pc = got[:2], want[:2]
    # freq past 4*pi: (ph + f_nom) + freq leaves (-2pi, 4pi) at every step
    assert (kc[1][2:].abs() > 4 * np.pi).all()
    assert ((kc[0] >= 0) & (kc[0] <= 2 * np.pi)).all()


def test_agc_refuses_a_table_past_shared_memory(dev):
    """A stream so long that K-AGC's table of block maxes passes shared
    memory (W = 38,400, L = 800,000: 236 KB) raises; nothing falls back
    to the plain version, and the launch is not counted."""
    params = make_agc_params(192000)
    w = params.window
    x = torch.zeros(1, 800000, device=dev)
    state = AGCState(tail=torch.zeros(1, w - 1, device=dev),
                     gain=torch.zeros(1, device=dev),
                     seen=torch.zeros(1, dtype=torch.int32, device=dev))
    before = agc.FLOAT_KERNEL.launches
    with pytest.raises(RuntimeError, match="agc_float_launch failed"):
        agc.agc_float(state, x, params)
    assert agc.FLOAT_KERNEL.launches == before


def test_agc_takes_the_longest_stream_the_config_allows(dev):
    """At W = 38,400 the kernel launches on agc.max_stream(W) samples
    (the cap the config holds hop_batch to) and refuses one more: the
    cap is the kernel's own."""
    params = make_agc_params(192000)
    w = params.window
    n = agc.max_stream(w)
    state = AGCState(tail=torch.zeros(1, w - 1, device=dev),
                     gain=torch.zeros(1, device=dev),
                     seen=torch.zeros(1, dtype=torch.int32, device=dev))
    x = torch.randn(1, n + 1, device=dev) * 0.1
    st, out = agc.agc_float(state, x[:, :n].contiguous(), params)
    assert out.shape == (1, n) and bool(torch.isfinite(out).all())
    assert int(st.seen[0]) == w
    with pytest.raises(RuntimeError, match="agc_float_launch failed"):
        agc.agc_float(state, x, params)


@pytest.mark.parametrize("rows,n", [(256, 40272), (6, 8192), (6, 8193),
                                    (5, 31), (3, 100000), (4, 1)])
def test_deemph_kernel_matches_plain(dev, rows, n):
    """Over two calls that carry y[-1]: |diff| <= 2e-5 * max|x| (the
    chunk carries round otherwise, tests/test_deemph.py's bound); masked
    rows pass through bit for bit with their carry kept."""
    g = torch.Generator(device=dev).manual_seed(rows * n)
    a = deemph_alpha(192000, 75.0)
    x = torch.randn(rows, 2 * n, device=dev, generator=g) * 3
    mask = torch.arange(rows, device=dev) % 4 != 2
    tol = 2e-5 * float(x.abs().max())
    ky = py = torch.randn(rows, device=dev, generator=g)
    for k in range(2):
        xs = x[:, k * n:(k + 1) * n].contiguous()
        before = deemph.KERNEL.launches
        got_c, got = deemph.deemph_process(ky, a, xs, mask)
        want_c, want = deemph.deemph_process_plain(py, a, xs, mask)
        assert deemph.KERNEL.launches == before + 1
        assert float((got - want).abs().max()) <= tol
        assert float((got_c - want_c).abs().max()) <= tol
        assert torch.equal(got[~mask], xs[~mask])
        assert torch.equal(got_c[~mask], ky[~mask])
        ky, py = got_c, want_c


# (sample rate, L): the windows W = sr / 5 of the WBFM (38,400) and nr
# (2400) paths, W below the 1024-sample chunk (20 inside one 128-sample
# block, 400), at it (1024), one past (W - 1 a multiple of the chunk:
# 1025), W - 1 a multiple of the block and of two chunks (129, 2049),
# L below a chunk (500, 700)
@pytest.mark.parametrize("sr,n", [(192000, 40272), (192000, 1001),
                                  (12000, 6480), (12000, 1539),
                                  (192000, 700), (100, 1500), (2000, 500),
                                  (5120, 3000), (5125, 3000), (645, 1029),
                                  (10245, 2100)])
def test_agc_float_kernel_matches_plain(dev, sr, n):
    """K-AGC's float mode against agc_process (rtol 1e-6, as
    tests/test_torch_agc.py), across warm-up states (seen 0, W - 2 and W
    among them)."""
    g = torch.Generator(device=dev).manual_seed(sr + n)
    params = make_agc_params(sr)
    w = params.window
    c = 8
    x = torch.randn(c, n, device=dev, generator=g) * 0.05
    x[:, ::41] *= 9
    state = AGCState(
        tail=torch.randn(c, w - 1, device=dev, generator=g) * 0.05,
        gain=torch.rand(c, device=dev, generator=g) * 4,
        seen=torch.tensor([0, 1, w // 3, w - 2, w - 1, w, w, 0],
                          dtype=torch.int32, device=dev))
    before = agc.FLOAT_KERNEL.launches
    st_k, y_k = agc.agc_float(state, x, params)
    st_p, y_p = agc_process(state, x, params)
    assert agc.FLOAT_KERNEL.launches == before + 1
    torch.testing.assert_close(y_k, y_p, rtol=1e-6, atol=1e-7)
    assert torch.equal(st_k.tail, st_p.tail)
    assert torch.equal(st_k.seen, st_p.seen)
    torch.testing.assert_close(st_k.gain, st_p.gain, rtol=1e-6, atol=0)


@pytest.mark.parametrize("sr,b,half", [(12000, 36, 180), (192000, 8, 5034)])
def test_agc_int16_is_the_float_mode_rounded(dev, sr, b, half):
    """The default int16 output is the float mode's output through
    float_to_int16, bit for bit: one chain, two ways to store it."""
    g = torch.Generator(device=dev).manual_seed(b)
    params = make_agc_params(sr)
    w = params.window
    c = 4
    x = torch.randn(c, b * half, device=dev, generator=g) * 0.05
    state = AGCState(tail=torch.randn(c, w - 1, device=dev, generator=g),
                     gain=torch.rand(c, device=dev, generator=g),
                     seen=torch.tensor([0, w // 2, w, w], dtype=torch.int32,
                                       device=dev))
    out = torch.empty(b, c, half, dtype=torch.int16, device=dev)
    st16 = agc.agc_int16(state, x, params, out)
    stf, y = agc.agc_float(state, x, params)
    assert torch.equal(out, float_to_int16(y).reshape(c, b, half)
                       .permute(1, 0, 2))
    assert torch.equal(st16.gain, stf.gain)


def test_fir_on_the_card_is_full_float32(dev):
    """The pilot bandpass through conv1d on the card against float64
    numpy within 1e-6 of the output's scale: cuDNN's TF32 (a 10-bit
    mantissa) is off."""
    g = torch.Generator(device=dev).manual_seed(5)
    taps = make_stereo_params(192000).taps
    x = torch.randn(64, 20000, device=dev, generator=g)
    got = fir(x, taps).cpu().numpy().astype(np.float64)
    xn = x.cpu().numpy().astype(np.float64)
    want = np.stack([np.convolve(r, taps.astype(np.float64), "valid")
                     for r in xn])
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-6, err
    lp = design_lowpass(397, 2 * 3200 / 192000)
    got = fir(x, lp, 32).cpu().numpy().astype(np.float64)
    want = np.stack([np.convolve(r, lp.astype(np.float64), "valid")[::32]
                     for r in xn])
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


# ------------------------------------------------------ noise processors

def nr_inputs(c, f, n, dev, seed, quiet=None):
    """Powers (exponential, with bursts and zero bins) and carries for
    K-NR, channels at every stage of the startup: fresh, accumulating,
    the 20th frame, running.  ``quiet``: every third channel is an idle
    slot from a reset (stage and carries 0) whose powers are 0
    ("silent") or subnormal ("subnormal"): xt_safe is then 1e-30."""
    g = torch.Generator(device=dev).manual_seed(seed)
    # exponential powers: -log of a uniform in (0, 1], never inf
    x_pow = ((1 - torch.rand(n, c, f, device=dev, generator=g)).log().neg()
             * 1e6
             * (1 + 50 * (torch.rand(n, c, f, device=dev, generator=g)
                          < 0.05)))
    x_pow[:, :, 0] = 0.0
    stage = (torch.arange(c, device=dev, dtype=torch.int32) * 7) % 22
    carries = (stage,) + tuple(
        torch.rand(c, f, device=dev, generator=g) * s
        for s in (1e6, 1e6, 0.5, 3.0))
    if quiet:
        x_pow[:, ::3] = 0.0 if quiet == "silent" else (
            1e-40 * torch.rand(n, len(range(0, c, 3)), f, device=dev, generator=g))
        for t in carries:
            t[::3] = 0
    return x_pow.contiguous(), carries


NR_CASES = [(128, 180, 36, None), (5, 257, 7, None), (3, 5034, 8, None),
            (1, 1, 25, None), (128, 180, 36, "silent"),
            (128, 180, 36, "subnormal"), (5, 257, 7, "silent"),
            (40, 33, 9, "subnormal")]


@pytest.mark.parametrize("c,f,n,quiet", NR_CASES)
def test_nr_kernel_matches_plain(dev, c, f, n, quiet):
    """Over two calls that carry the state: the gains and float carries
    within rtol 1e-5 (the same float32 operations in the same order;
    expf may round otherwise), stage and running flags equal."""
    x_pow, carries = nr_inputs(c, f, 2 * n, dev, c * f, quiet)
    p = make_nr_params(max(f, 2))
    kc = pc = carries
    for k in range(2):
        xp = x_pow[k * n:(k + 1) * n].contiguous()
        before = nr.KERNEL.launches
        kc, kg, kr = nr.gain_frames(kc, p.alpha, p.xih1r, p.pfac, xp)
        pc, pg, pr = nr.gain_frames_plain(pc, p.alpha, p.xih1r, p.pfac, xp)
        assert nr.KERNEL.launches == before + 1
        assert torch.equal(kr, pr) and torch.equal(kc[0], pc[0])
        torch.testing.assert_close(kg, pg, rtol=1e-5, atol=0)
        for a, b in zip(kc[1:], pc[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("c,f,n,quiet", NR_CASES)
def test_nr_kernel_equals_parent(dev, c, f, n, quiet):
    """The kernel keeps every float32 operation of the parent's design
    in its order, its written-out divisions and square root rounding as
    __fdiv_rn and __fsqrt_rn do: over two chained calls, gains, running
    flags and carries equal to the parent kernel's bit for bit."""
    from phantomsdr_tpu_torch.ops.cuda.build import P, stream_and_device

    fn = parent_lib(dev, "nr").nr_launch
    fn.argtypes = nr.KERNEL.argtypes
    x_pow, kc = nr_inputs(c, f, 2 * n, dev, c * f + 1, quiet)
    p = make_nr_params(max(f, 2))
    for k in range(2):
        xp = x_pow[k * n:(k + 1) * n].contiguous()
        pg, pr = torch.empty_like(xp), torch.empty((n, c), dtype=torch.bool, device=dev)
        pc = tuple(torch.empty_like(t) for t in kc)
        stream, d = stream_and_device(xp)
        assert fn(*(P(t.data_ptr()) for t in (xp, *kc, pg, pr, *pc)), n, c, f,
                  *nr._consts(p.alpha, p.xih1r, p.pfac), d, P(stream)) == 0
        kc, kg, kr = nr.gain_frames(kc, p.alpha, p.xih1r, p.pfac, xp)
        torch.cuda.synchronize()
        assert torch.equal(kg, pg) and torch.equal(kr, pr)
        for a, b in zip(kc, pc):
            assert torch.equal(a, b)


def test_nr_fast_divisions_and_sqrt_equal_ieee(dev):
    """The kernel's written-out division, reciprocal and square root give
    __fdiv_rn's and __fsqrt_rn's bits on every input they accept: the
    division over every pair of exponent fields (65,536 operand pairs
    each: the edge mantissas 0, 1, 2^23 - 2 and 2^23 - 1 of both
    operands, zero numerators, hashed mantissas and signs), the square
    root and the reciprocal over every float32."""
    got = nr.fast_check(1 << 16)
    checked, fast, differ = got["div"]
    assert checked == 1 << 32 and differ == 0
    assert fast > checked // 4          # the accepted range is most of it
    checked, fast, differ = got["sqrt_rcp"]
    assert checked == 1 << 32 and differ == 0 and fast > 0


def test_nr_chain_probe_runs_the_kernels_loop(dev):
    """On powers that repeat frame after frame, the probe's carries (the
    first frame's power held in a register) equal the kernel's."""
    x_pow, carries = nr_inputs(16, 180, 1, dev, 3)
    x_pow = x_pow.expand(36, 16, 180).contiguous()
    p = make_nr_params(180)
    got = nr.chain_probe(carries, p.alpha, p.xih1r, p.pfac, x_pow)
    want, _, _ = nr.gain_frames(carries, p.alpha, p.xih1r, p.pfac, x_pow)
    for a, b in zip(got, want[1:]):
        assert torch.equal(a, b)


def anr_state(c, taps, delay, dev, seed, reset_every=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    hist = torch.randn(c, taps + delay, device=dev, generator=g) * 1000
    w = torch.randn(c, taps, device=dev, generator=g) * 0.01
    lidx = torch.full((c,), 120.0, device=dev)
    ngamma = torch.full((c,), 0.001, device=dev)
    if reset_every:
        z = torch.arange(c, device=dev) % reset_every == 0
        hist[z], w[z], lidx[z], ngamma[z] = 0, 0, 0, 0
    return hist, w, lidx, ngamma


ANR_CASES = [
    (128, 6480, False, 1e-4, 64, 8, 256), (128, 6480, True, 1e-4, 64, 8, 256),
    (6, 1000, True, 1e-4, 64, 8, 256), (4, 3000, False, 8e-3, 64, 8, 256),
    (3, 2500, False, 1e-4, 128, 128, 256), (5, 700, True, 1e-3, 16, 2, 256),
    # the kernel's edges: taps not a multiple of its group of 8 loads
    # (17) and 128 with delay 1; delay 128 with taps 64; blocks of one
    # sample; a row longer than the staged ring (history + two segments
    # of 2048) with a remainder block
    (4, 1000, False, 1e-4, 17, 8, 256), (3, 2000, True, 1e-4, 128, 1, 256),
    (3, 1500, False, 1e-4, 64, 128, 256), (2, 300, False, 1e-4, 16, 2, 1),
    (3, 40272, False, 1e-4, 64, 8, 256),
]


@pytest.mark.parametrize("c,t,notch,two_mu,taps,delay,block", ANR_CASES)
def test_anr_kernel_matches_plain(dev, c, t, notch, two_mu, taps, delay, block):
    """Over two calls that carry the state (rows of a reset among
    them, lidx 0: the leak automaton unarmed): outputs and carries
    within 1e-4 * max|x|, the sums of the taps-long products adding in
    another order."""
    g = torch.Generator(device=dev).manual_seed(t + taps)
    tt = torch.arange(2 * t, device=dev) / 12000.0
    x = (3000 * torch.sin(2 * np.pi * 800 * tt)[None]
         + 1000 * torch.randn(c, 2 * t, device=dev, generator=g))
    bsz = max(1, min(block, t, int(0.5 / two_mu)))
    tol = 1e-4 * float(x.abs().max())
    kc = pc = anr_state(c, taps, delay, dev, t, reset_every=3)
    for k in range(2):
        xs = x[:, k * t:(k + 1) * t].contiguous()
        before = anr.KERNEL.launches
        kc, ko = anr.lms_blocks(*kc, xs, taps, delay, two_mu, 0.1, notch, bsz)
        pc, po = anr.lms_blocks_plain(*pc, xs, taps, delay, two_mu, 0.1,
                                      notch, bsz)
        assert anr.KERNEL.launches == before + 1
        assert float((ko - po).abs().max()) <= tol
        for a, b in zip(kc, pc):
            assert float((a - b).abs().max()) <= tol


def parent_lib(dev, source: str):
    """The parent checkout's csrc/<source>.cu built into
    build/torch_kernels/ (the C interface is the package's).  The parent
    is PARENT_CSRC, by default build/archive/parent/phantomsdr_tpu_torch/
    csrc, unpacked there with ``git archive``; without it the test
    skips."""
    import ctypes
    import hashlib
    import os
    import subprocess
    from pathlib import Path

    from phantomsdr_tpu_torch.ops.cuda.build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    root = Path(__file__).resolve().parents[1]
    where = Path(os.environ.get("PARENT_CSRC", root / "build/archive/parent"
                                "/phantomsdr_tpu_torch/csrc"))
    cu = where / f"{source}.cu"
    if not cu.exists():
        pytest.skip(f"no parent kernel source at {where} (PARENT_CSRC)")
    text = cu.read_bytes() + b"".join(h.read_bytes() for h in sorted(where.glob("*.cuh")))
    out = BUILD_DIR / f"libparent_{source}-{hashlib.sha256(text).hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(where), "-o", str(out), str(cu)],
                       check=True, capture_output=True)
    return ctypes.CDLL(str(out))


@pytest.mark.parametrize("c,t,notch,two_mu,taps,delay,block", ANR_CASES)
def test_anr_kernel_equals_parent(dev, c, t, notch, two_mu, taps, delay, block):
    """The kernel keeps every float32 operation of the parent's design
    in its order: over two chained calls, outputs and carries equal to
    the parent kernel's bit for bit."""
    from phantomsdr_tpu_torch.ops.cuda.build import P, stream_and_device

    fn = parent_lib(dev, "anr").anr_launch
    fn.argtypes = anr.KERNEL.argtypes
    g = torch.Generator(device=dev).manual_seed(t + taps)
    x = 1000 * torch.randn(c, 2 * t, device=dev, generator=g)
    bsz = max(1, min(block, t, int(0.5 / two_mu)))
    kc = anr_state(c, taps, delay, dev, t, reset_every=3)
    for k in range(2):
        xs = x[:, k * t:(k + 1) * t].contiguous()
        pout = torch.empty_like(xs)
        pnew = tuple(torch.empty_like(v) for v in kc)
        stream, d = stream_and_device(xs)
        assert fn(*(P(v.data_ptr()) for v in (xs, *kc, pout, *pnew)), c, t, taps,
                  delay, bsz, int(notch), float(np.float32(two_mu)),
                  float(np.float32(0.1)), d, P(stream)) == 0
        kc, ko = anr.lms_blocks(*kc, xs, taps, delay, two_mu, 0.1, notch, bsz)
        torch.cuda.synchronize()
        assert torch.equal(ko, pout)
        for a, b in zip(kc, pnew):
            assert torch.equal(a, b)


def test_anr_chain_probe_runs_the_kernels_loop(dev):
    """On a stream that repeats its first block, the probe (which keeps
    the first block staged) ends on the kernel's carries bit for bit."""
    g = torch.Generator(device=dev).manual_seed(11)
    c, bsz, blocks = 8, 256, 25
    first = torch.randn(c, bsz, device=dev, generator=g) * 1000
    x = first.repeat(1, blocks).contiguous()
    state = anr_state(c, 64, 8, dev, 12)
    got = anr.chain_probe(*state, x, 64, 8, 1e-4, 0.1, False, bsz)
    want, _ = anr.lms_blocks(*state, x, 64, 8, 1e-4, 0.1, False, bsz)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def nb_frame(c, t, dev, seed, clicks=8):
    """[C, t] voice-like rows with clicks a few samples wide at random
    places (some close together)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    tt = torch.arange(t, device=dev) / 12000.0
    x = (3000 * torch.sin(2 * np.pi * 500 * tt)[None]
         * (1 + torch.arange(c, device=dev)[:, None] % 3)
         + 250 * torch.randn(c, t, device=dev, generator=g))
    for _ in range(clicks):
        at = torch.randint(0, t - 4, (c,), device=dev, generator=g)
        for k in range(3):
            x[torch.arange(c, device=dev), at + k] += 20000
    return x


@pytest.mark.parametrize("c,t,order,samples", [
    (128, 6480, 32, 11), (6, 2000, 40, 21), (5, 1500, 1, 3),
    (4, 3000, 16, 201), (3, 40272, 32, 11),
])
def test_nb_kernel_matches_plain(dev, c, t, order, samples):
    """Two chained calls of the blanker: launch 1 against the plain LPC
    fit (coefficients of order 1 within 1e-3, the lags adding in another
    order), launch 2 against the plain search and repairs on the same
    inputs: impulse counts and positions equal, the repaired buffer
    within 1e-5 * max|x|; the whole nb_process counts both launches."""
    from phantomsdr_tpu_torch.ops.nb import (
        init_nb_state, make_nb_params, nb_process,
    )

    p = make_nb_params(5.0, order, samples)
    il, lo = p.impulse_len, order + (p.impulse_len - 1) // 2
    x = nb_frame(c, 2 * t, dev, t + order)
    tol = 1e-5 * float(x.abs().max())
    state = init_nb_state(c, p, dev)
    for k in range(2):
        xs = x[:, k * t:(k + 1) * t].contiguous()
        wb = torch.cat([state.tail, xs], 1).contiguous()
        before = (nb.LPC_KERNEL.launches, nb.REPAIR_KERNEL.launches)
        got = nb.lpc_coeffs(wb, t, order, il)
        for a, b in zip(got, nb.lpc_coeffs_plain(wb, t, order, il)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
        lpcs, cf, cb = got
        temp = fir_fresh(lpcs, fir_fresh(lpcs.flip(1), wb[:, lo:lo + t]))
        temp = temp.contiguous()
        wbf, kcount, kpos, kthr = nb.repair(wb, temp, lpcs, cf, cb, 5.0,
                                            order, il)
        pwbf, pcount, ppos, pthr = nb.repair_plain(wb, temp, lpcs, cf, cb,
                                                   5.0, order, il)
        assert (nb.LPC_KERNEL.launches, nb.REPAIR_KERNEL.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(kcount, pcount) and torch.equal(kpos, ppos)
        torch.testing.assert_close(kthr, pthr, rtol=1e-5, atol=0)
        assert float((wbf - pwbf).abs().max()) <= tol
        new, out = nb_process(state, p, xs)
        assert nb.REPAIR_KERNEL.launches == before[1] + 2
        assert new.tail.shape == state.tail.shape and out.shape == xs.shape
        state = state._replace(tail=wbf[:, t:].contiguous())
    assert int(kcount.max()) > 0


def nb_edge_frame(c, t, dev, kind, pl):
    """[C, t] rows for the blanker's edges: ``packed``, 25 one-sample
    clicks of random sign PL + 1 apart from sample 400 on (the search
    fills its 20 slots PL + 1 apart, their repair windows overlapping;
    random signs, or the LPC fit predicts the comb away); ``none``, the
    tone and noise alone; ``short``, two clicks in a frame of a few
    hundred samples."""
    g = torch.Generator(device=dev).manual_seed(t + len(kind))
    if kind == "short":
        return nb_frame(c, t, dev, t, clicks=2)
    tt = torch.arange(t, device=dev) / 12000.0
    x = (3000 * torch.sin(2 * np.pi * 500 * tt)[None]
         + 250 * torch.randn(c, t, device=dev, generator=g))
    if kind == "packed":
        sign = torch.randint(0, 2, (c, 25), device=dev, generator=g) * 2 - 1
        x[:, 400:400 + 25 * (pl + 1):pl + 1] += 20000 * sign
    return x


@pytest.mark.parametrize("kind,c,t,order,samples", [
    ("packed", 4, 3000, 32, 11), ("packed", 3, 6480, 40, 201),
    ("packed", 3, 2500, 1, 3), ("none", 4, 6480, 32, 11),
    ("short", 4, 300, 32, 11), ("short", 3, 120, 8, 5),
])
def test_nb_kernel_edges_match_plain(dev, kind, c, t, order, samples):
    """Both launches against the plain versions on the same inputs at
    the repair chain's edges: counts and positions equal (a channel with
    20 slots PL + 1 apart for the packed clicks; none without impulses,
    at a threshold of 12 residual sigmas, past the tail of tone and
    noise), the repaired buffer within 1e-5 * max|x|, the LPC fit within
    1e-3."""
    from phantomsdr_tpu_torch.ops.nb import init_nb_state, make_nb_params

    thresh = 12.0 if kind == "none" else 5.0
    p = make_nb_params(thresh, order, samples)
    il, lo = p.impulse_len, order + (p.impulse_len - 1) // 2
    x = nb_edge_frame(c, t, dev, kind, (il - 1) // 2)
    wb = torch.cat([init_nb_state(c, p, dev).tail, x], 1).contiguous()
    got = nb.lpc_coeffs(wb, t, order, il)
    for a, b in zip(got, nb.lpc_coeffs_plain(wb, t, order, il)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    lpcs, cf, cb = got
    temp = fir_fresh(lpcs, fir_fresh(lpcs.flip(1), wb[:, lo:lo + t])).contiguous()
    wbf, kcount, kpos, kthr = nb.repair(wb, temp, lpcs, cf, cb, thresh, order, il)
    pwbf, pcount, ppos, pthr = nb.repair_plain(wb, temp, lpcs, cf, cb, thresh, order, il)
    torch.cuda.synchronize()
    assert torch.equal(kcount, pcount) and torch.equal(kpos, ppos)
    torch.testing.assert_close(kthr, pthr, rtol=1e-5, atol=0)
    assert float((wbf - pwbf).abs().max()) <= 1e-5 * float(x.abs().max())
    if kind == "packed":
        full = kcount == nb.N_IMPULSE_COUNT
        assert bool(full.any())
        gaps = (kpos[full, 1:] - kpos[full, :-1]).min()
        assert int(gaps) == (il - 1) // 2 + 1 < il
    elif kind == "none":
        assert int(kcount.max()) == 0 and torch.equal(wbf, wb)


NB_PARENT_CASES = [
    ("clicks", 128, 6480, 32, 11), ("clicks", 6, 2000, 40, 21), ("clicks", 5, 1500, 1, 3),
    ("clicks", 4, 3000, 16, 201), ("clicks", 3, 40272, 32, 11),
    ("packed", 4, 3000, 32, 11), ("packed", 3, 6480, 40, 201), ("none", 4, 6480, 32, 11),
    ("short", 4, 300, 32, 11), ("short", 3, 120, 8, 5),
]


@pytest.mark.parametrize("kind,c,t,order,samples", NB_PARENT_CASES)
def test_nb_kernels_equal_parent(dev, kind, c, t, order, samples):
    """Both launches keep every float32 operation of the parent's design
    in its order: lpcs, the prediction matrices, the repaired buffer,
    counts, positions and thresholds equal to the parent kernels' bit for
    bit on the same inputs (and the repair probe's buffer likewise)."""
    from phantomsdr_tpu_torch.ops.cuda.build import P, stream_and_device
    from phantomsdr_tpu_torch.ops.nb import make_nb_params

    lib = parent_lib(dev, "nb")
    fl, fr, fp = lib.nb_lpc_launch, lib.nb_repair_launch, lib.nb_repair_chain_probe_launch
    fl.argtypes = nb.LPC_KERNEL.argtypes
    fr.argtypes = nb.REPAIR_KERNEL.argtypes
    fp.argtypes = nb.REPAIR_KERNEL.probe_argtypes
    p = make_nb_params(5.0, order, samples)
    il, pl = p.impulse_len, (p.impulse_len - 1) // 2
    lo = order + pl
    x = (nb_frame(c, t, dev, t + order) if kind == "clicks"
         else nb_edge_frame(c, t, dev, kind, pl))
    g = torch.Generator(device=dev).manual_seed(order)
    tail = 1000 * torch.randn(c, 2 * order + 2 * pl, device=dev, generator=g)
    wb = torch.cat([tail, x], 1).contiguous()
    wlen = wb.shape[1]
    stream, d = stream_and_device(wb)
    got = nb.lpc_coeffs(wb, t, order, il)
    want = tuple(torch.empty_like(v) for v in got)
    assert fl(*(P(v.data_ptr()) for v in (wb, *want)), c, wlen, t, order, il, d,
              P(stream)) == 0
    lpcs, cf, cb = got
    temp = fir_fresh(lpcs, fir_fresh(lpcs.flip(1), wb[:, lo:lo + t])).contiguous()
    rep = nb.repair(wb, temp, lpcs, cf, cb, 5.0, order, il)
    prep = (torch.empty_like(wb), torch.empty_like(rep[1]), torch.empty_like(rep[2]),
            torch.empty_like(rep[3]))
    assert fr(*(P(v.data_ptr()) for v in (wb, temp, lpcs, cf, cb, *prep)), c, wlen, t,
              order, il, float(np.float32(5.0)), d, P(stream)) == 0
    torch.cuda.synchronize()
    for a, b in zip(got + rep, want + prep):
        assert torch.equal(a, b)
    if pl + 19 * (pl + 1) + 2 * order + il <= wlen:
        probe = nb.repair_chain_probe(wb, temp, lpcs, cf, cb, order, il)
        pprobe = wb.clone()
        assert fp(*(P(v.data_ptr()) for v in (wb, cf, cb, pprobe, temp)), c, wlen, t,
                  order, il, d, P(stream)) == 0
        torch.cuda.synchronize()
        assert torch.equal(probe, pprobe)


def test_nb_lpc_kernel_matches_plain(dev):
    """Launch 1 alone: lpcs and the prediction matrices against the
    plain Levinson and recursions (atol 1e-4 on coefficients of order 1:
    the lags add in another order)."""
    x = nb_frame(16, 6554, dev, 5)
    got = nb.lpc_coeffs(x, 6480, 32, 11)
    want = nb.lpc_coeffs_plain(x, 6480, 32, 11)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


def test_nb_repair_chain_probe_runs(dev):
    """The probe repairs 20 windows PL + 1 apart and leaves the rest."""
    c, t, order, il = 4, 2000, 32, 11
    wb = nb_frame(c, t + 2 * order + 10, dev, 8)
    lpcs, cf, cb = nb.lpc_coeffs(wb, t, order, il)
    temp = torch.zeros(c, t, device=dev)
    out = nb.repair_chain_probe(wb, temp, lpcs, cf, cb, order, il)
    changed = (out != wb).any(0).nonzero().flatten()
    assert torch.isfinite(out).all()
    assert int(changed.min()) >= order + 5 and int(changed.max()) < (
        order + 5 + 19 * 6 + il)


def test_failed_launch_raises_without_fallback(dev):
    """A CUDA tensor whose launch the kernel refuses (K-ANR with a delay
    line too long for its 227 KB of shared memory) raises; nothing falls
    back to the plain version, and the launch is not counted."""
    c, taps, delay = 2, 20000, 8
    state = anr_state(c, taps, delay, dev, 1)
    x = torch.zeros(c, 512, device=dev)
    before = anr.KERNEL.launches
    with pytest.raises(RuntimeError, match="anr_launch failed"):
        anr.lms_blocks(*state, x, taps, delay, 1e-4, 0.1, False, 256)
    assert anr.KERNEL.launches == before


@pytest.mark.parametrize("cards", [1, 4])
def test_mesh_step_matches_single_device(dev, cards):
    """The mesh (4 shards: on one card, or on four where there are
    four) against the single-device step on the card over three chained
    'views' steps, both from the stream's first hop as halo: int16
    audio within 4, power rtol 2e-4, waterfall rows within one step on
    < 0.1% of bytes; the mesh launches the path's kernels."""
    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.ops.quantize import pyramid_level_offsets
    from phantomsdr_tpu_torch.parallel import (
        ShardedHopPipeline, make_mesh, unpack_outputs_sharded,
    )
    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, WaterfallViews, channels_from_numpy,
    )

    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    n = 4
    mesh = make_mesh(n, "cuda") if cards > 1 else make_mesh(
        devices=[dev] * n)
    cfg = config_from_dict({
        "input": {"sps": 192000, "frequency": 7000000, "fft_size": 4096,
                  "signal": "iq", "audio_sps": 12000, "waterfall_size": 512,
                  "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 8, "max_channels": 16}})
    sp, pipe = ShardedHopPipeline(cfg, mesh), HopPipeline(cfg, device=dev)
    c = cfg.max_channels
    l = np.linspace(10, cfg.fft_result_size - 300, c).astype(np.int32)
    cols = (l, l + 100, l + 50, np.arange(c) % 4, np.ones(c, bool))
    t1, t4 = channels_from_numpy(*cols, device=dev), sp.channels_from_numpy(
        *cols)
    offs = pyramid_level_offsets(cfg.fft_result_size, cfg.downsample_levels)
    views = WaterfallViews(
        start=torch.tensor([offs[0] + 100, offs[2]], dtype=torch.int32,
                           device=dev),
        length=torch.tensor([512, 300], dtype=torch.int32, device=dev))
    wph = pipe.wire_per_hop
    blk = cfg.hop_batch * wph
    g = torch.Generator(device=dev).manual_seed(9)
    stream = (torch.randn(4 * blk + wph, device=dev, generator=g)
              * 4000).to(torch.int16)
    st1 = pipe.init_state()
    st4 = sp.init_state()._replace(halo=stream[:wph].clone())
    for k in (waterfall.KERNEL, pll.KERNEL, agc.KERNEL):
        k.launches = 0
    for s in range(3):
        frame0 = s * cfg.hop_batch
        idx, counts = sp.due_layout(frame0)
        st4, o4 = sp.step(st4, sp.shard_raw(stream[wph + s * blk:
                                                   wph + (s + 1) * blk]),
                          t4, views, "views", due_idx=idx)
        st1, o1 = pipe.step(st1, stream[s * blk:(s + 1) * blk + wph], t1,
                            views, "views",
                            due_idx=pipe.default_due_idx(frame0))
        packed = np.concatenate([p.cpu().numpy() for p in o4.packed])
        a4, p4, w4, _ = unpack_outputs_sharded(
            packed, n, cfg.hop_batch, c, cfg.audio_fft_size // 2, 2,
            sp.view_cap, sp.due_cap_local)
        a1 = o1.audio.cpu().numpy()
        assert np.abs(a1.astype(int) - a4.astype(int)).max() <= 4
        np.testing.assert_allclose(p4, o1.avg_power.cpu().numpy(),
                                   rtol=2e-4, atol=1e-12)
        w1 = o1.wf.cpu().numpy()[:sum(counts)].astype(int)
        d = np.abs(w4[sp.due_row_selector(counts)].astype(int) - w1)
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
    # a launch of each a step: the single device's, and each shard's
    # (every shard has an AM row)
    assert (waterfall.KERNEL.launches, pll.KERNEL.launches,
            agc.KERNEL.launches) == (3 * (n + 1),) * 3


def test_multihost_cluster_over_nccl(dev, tmp_path):
    """Two processes with a card each (CUDA_VISIBLE_DEVICES) form a
    cluster over NCCL through tools/torch_multihost_dryrun.py: rows over
    the TCP link, the halo and the gathers over NCCL, each follower's
    retune upstream; each host's audio within 4 of the single device
    on the card, the waterfall replicas identical."""
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    tool = Path(__file__).resolve().parent.parent / "tools" \
        / "torch_multihost_dryrun.py"
    res = subprocess.run(
        [sys.executable, str(tool), "--device", "cuda", "--out",
         str(tmp_path), "--timeout", "150"], capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "TORCH_MULTIHOST_DRYRUN_OK" in res.stdout, res.stdout
    assert res.stdout.count("over nccl") == 2, res.stdout


def test_multihost_cli_over_nccl(dev, tmp_path):
    """Two processes of ``python -m phantomsdr_tpu_torch --device cuda
    --coordinator ...`` with a card each (CUDA_VISIBLE_DEVICES) serve a
    cluster over NCCL through the CLI and MultihostDriver: an AM
    listener on the follower's own slot and a waterfall client there
    receive packets, neither process reports a device error, both
    printed the NCCL choice, and SIGTERM ends both."""
    import asyncio
    import json

    from tests.test_torch_multihost_faults import (
        logs, spawn_cluster, stop, wait_metrics,
    )

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    procs, ports, hop, metrics = spawn_cluster(tmp_path, 2, device="cuda")
    try:
        for which in range(2):
            wait_metrics(procs, metrics, lambda m: m["frames"] >= 3 * hop,
                         180, tmp_path, which=which)

        async def listen(port):
            import aiohttp

            got = {"audio": 0, "waterfall": 0}
            async with aiohttp.ClientSession() as s:
                url = f"http://127.0.0.1:{port}"
                async with s.ws_connect(url + "/audio",
                                        max_msg_size=1 << 22) as ws, \
                        s.ws_connect(url + "/waterfall",
                                     max_msg_size=1 << 22) as wf:
                    mid = json.loads((await ws.receive()).data)[
                        "fft_result_size"] // 2
                    await ws.send_str(json.dumps(
                        {"cmd": "window", "l": mid - 32, "m": mid,
                         "r": mid + 32}))
                    await ws.send_str(json.dumps(
                        {"cmd": "demodulation", "demodulation": "AM"}))
                    for name, sock, want in (("audio", ws, 3),
                                             ("waterfall", wf, 2)):
                        while got[name] < want:
                            msg = await sock.receive(timeout=60)
                            if msg.type == aiohttp.WSMsgType.BINARY:
                                got[name] += 1
            return got

        got = asyncio.run(listen(ports[1]))
        assert got == {"audio": 3, "waterfall": 2}, got
        for which in range(2):
            assert metrics(which)["device_errors"] == 0, metrics(which)
        assert logs(tmp_path, 2).count("backend nccl") == 2, \
            logs(tmp_path, 2)
    finally:
        slow = stop(procs)
    assert not slow, f"processes {slow} outlived SIGTERM by 10 s"
