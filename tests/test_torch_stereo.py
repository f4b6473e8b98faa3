"""PyTorch port vs the JAX package: WBFM stereo (ops/stereo.py) -- the
bandpass, the delay line, the pilot PLL (the plain version of kernel
K-PILOT) and the demix -- over chained blocks, on CPU; and the port's
own separation.

Tolerance: |diff| <= 1e-5 * max|x| on L/R, ph and the carries (the
bound K-PLL is held to, tests/test_torch_channelizer.py): both run the
same float32 recursion in the same order, and only sin/cos may round
differently (an ulp), an error the stable loop pulls back instead of
accumulating.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.ops import stereo as jst

from phantomsdr_tpu_torch.ops import stereo as st

FS = 192000


def mpx(n, fs=FS, fl=800.0, fr=1300.0, amp=1.0, start=0):
    """Standard FM MPX (tests/test_stereo.py): mono + 9% pilot + DSB L-R
    on the 38 kHz subcarrier."""
    t = np.arange(start, start + n) / fs
    L, R = np.sin(2 * np.pi * fl * t), np.sin(2 * np.pi * fr * t)
    th = 2 * np.pi * 19000.0 * t
    x = (0.45 * (L + R) / 2 + 0.09 * np.cos(th)
         + 0.45 * (L - R) / 2 * np.cos(2 * th))
    return (amp * x).astype(np.float32)


def rows(n, start=0):
    """Four channels: three FM MPX at other levels (one with noise), and
    one non-FM row."""
    rng = np.random.default_rng(start)
    x = np.stack([mpx(n, start=start), mpx(n, amp=3.0, start=start),
                  mpx(n, amp=0.5, start=start)
                  + 0.01 * rng.standard_normal(n).astype(np.float32),
                  mpx(n, amp=2.0, start=start)])
    return x, np.array([True, True, True, False])


def test_params_equal_jax():
    for fs in (192000, 128000):
        p, jp = st.make_stereo_params(fs), jst.make_stereo_params(fs)
        np.testing.assert_array_equal(p.taps, jp.taps)
        assert (p.delay, p.f_nom) == (jp.delay, jp.f_nom)


def test_pilot_track_matches_jax_across_blocks():
    p = st.make_stereo_params(FS)
    blk, c = 3000, 4
    x, _ = rows(3 * blk)
    tol = 1e-5 * float(np.abs(x).max())
    y = st.fir(torch.from_numpy(np.concatenate(
        [np.zeros((c, p.taps.shape[0] - 1), np.float32), x], 1)), p.taps)
    jphase = jfreq = jnp.zeros(c)
    phase = freq = torch.zeros(c)
    for k in range(3):
        yb = y[:, k * blk:(k + 1) * blk].contiguous()
        jphase, jfreq, jph = jst.pilot_track(jphase, jfreq, p.f_nom,
                                             jnp.asarray(yb.numpy()))
        phase, freq, ph = st.pilot_track(phase, freq, p.f_nom, yb)
        np.testing.assert_allclose(ph.numpy(), np.asarray(jph), atol=tol,
                                   rtol=0)
        np.testing.assert_allclose(phase.numpy(), np.asarray(jphase),
                                   atol=tol, rtol=0)
        np.testing.assert_allclose(freq.numpy(), np.asarray(jfreq),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("blk", [4096, 1001])
def test_stereo_decode_matches_jax_across_blocks(blk):
    p = st.make_stereo_params(FS)
    c = 4
    x, fm = rows(3 * blk)
    tol = 1e-5 * float(np.abs(x).max())
    js = jst.init_stereo_state(c, p)
    ts = st.init_stereo_state(c, p)
    for k in range(3):
        xb = x[:, k * blk:(k + 1) * blk]
        js, jl, jr = jst.stereo_decode(js, p, jnp.asarray(xb),
                                       jnp.asarray(fm))
        ts, lr = st.stereo_decode(ts, p, torch.from_numpy(xb),
                                  torch.from_numpy(fm))
        assert lr.shape == (2 * c, blk)
        np.testing.assert_allclose(lr[0::2].numpy(), np.asarray(jl),
                                   atol=tol, rtol=0)
        np.testing.assert_allclose(lr[1::2].numpy(), np.asarray(jr),
                                   atol=tol, rtol=0)
        for name in ("bp_tail", "mono_tail"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
        for name in ("phase", "freq"):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=tol, rtol=0)
        # the non-FM row is mono in both ears: the delayed MPX
        np.testing.assert_array_equal(lr[6].numpy(), lr[7].numpy())


def tone_amp(x, f, fs):
    n = x.size
    return float(np.abs(np.sum(x * np.exp(-2j * np.pi * f * np.arange(n)
                                          / fs))) * 2 / n)


def test_port_separation_after_lock():
    """After lock the 800 Hz L tone lands in L and the 1300 Hz R tone in
    R, each > 30 dB above its leak into the other ear
    (tests/test_stereo.py's bar; at 128 kS/s to keep the plain loop
    short, measured over 0.2 s, a whole number of cycles of both)."""
    fs = 128000
    p = st.make_stereo_params(fs)
    n, tail = 40960, 25600
    x = mpx(n, fs=fs)[None]
    _, lr = st.stereo_decode(st.init_stereo_state(1, p), p,
                             torch.from_numpy(x), torch.tensor([True]))
    left, right = lr[0, -tail:].numpy(), lr[1, -tail:].numpy()
    l_want, l_leak = tone_amp(left, 800, fs), tone_amp(left, 1300, fs)
    r_want, r_leak = tone_amp(right, 1300, fs), tone_amp(right, 800, fs)
    assert abs(l_want - 0.45) < 0.02 and abs(r_want - 0.45) < 0.02
    assert l_leak < 0.45 * 10 ** (-30 / 20)
    assert r_leak < 0.45 * 10 ** (-30 / 20)


def test_stereo_demix_is_the_kernels_mix():
    """stereo_demix (plain) against JAX's on the same phase."""
    rng = np.random.default_rng(3)
    xd = rng.standard_normal((3, 500)).astype(np.float32)
    ph = (rng.random((3, 500)) * 6.28).astype(np.float32)
    fm = np.array([True, False, True])
    jl, jr = jst.stereo_demix(jnp.asarray(xd), jnp.asarray(ph),
                              jnp.asarray(fm))
    lr = st.stereo_demix(torch.from_numpy(xd), torch.from_numpy(ph),
                         torch.from_numpy(fm))
    np.testing.assert_allclose(lr[0::2].numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(lr[1::2].numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_array_equal(lr[2].numpy(), xd[1])


def test_pilot_chain_probe_needs_a_card():
    """The chain probe is a measuring aid of the kernel alone: it has no
    plain version and refuses CPU tensors."""
    from phantomsdr_tpu_torch.ops.cuda import pilot

    with pytest.raises(ValueError, match="CUDA"):
        pilot.chain_probe(torch.zeros(2, 8), torch.zeros(2), torch.zeros(2),
                          0.6)
