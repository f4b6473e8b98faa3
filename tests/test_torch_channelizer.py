"""PyTorch port vs the JAX package: channel bin gathers, batched
demodulation (USB/LSB/AM/FM, PLL and envelope AM) and the AM carrier
PLL (the plain version of kernel K-PLL), on CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from phantomsdr_tpu.ops import channelizer as jch
from phantomsdr_tpu.pipeline import channels_from_numpy as jtable

from phantomsdr_tpu_torch.ops import channelizer as ch
from phantomsdr_tpu_torch.ops.cuda import pll
from phantomsdr_tpu_torch.ops.cuda.pll import am_sync_detect_plain
from phantomsdr_tpu_torch.pipeline import channels_from_numpy

A = 256                      # audio_fft_size of the _small_cfg geometry
N = 4096

# The PLL's own bound: both sides run the same float32 recursion, but
# their sin/cos/atan2 differ by a few ulps (~1e-7 rad) per sample.  The
# loop is a stable 2nd-order PLL (bandwidth 1e-3): a perturbation of the
# phase is pulled back within ~1/sqrt(bw) ~ 32 samples instead of
# accumulating, so the audio differs by a few ulps of its scale; the
# noise-only carrier case below (the loop never locks) is the hardest
# and passes with a wide margin.
PLL_RTOL = 1e-5


def layout(is_real):
    """Channel rows: mid-spectrum, full audio width, one crossing DC (IQ)
    or the top edge (real), an inactive row."""
    r = N // 2 if is_real else N
    rows = [(900, 1100, 1000), (301, 301 + A, 301 + A // 2),
            (r - 60, r - 60 + 120, r), (1500, 1580, 1540)]
    l, rr, m = (np.array(v, np.int32) for v in zip(*rows))
    return r, l, rr, m


def spectra(seed, b, is_real):
    rng = np.random.default_rng(seed)
    w = N // 2 + 1 if is_real else N
    return ((rng.standard_normal((b, w)) + 1j * rng.standard_normal((b, w)))
            * 0.01).astype(np.complex64)


def tables(l, r, m, mode, active, am_env):
    kw = dict(l=l, r=r, m_idx=m, mode=mode, active=active, am_env=am_env)
    return jtable(**kw), channels_from_numpy(**kw)


@pytest.mark.parametrize("is_real", [False, True])
def test_gather_channel_bins_wraps_by_index(is_real):
    """Bins gathered straight from the spectrum (DC wrap by index) equal
    the JAX gathers from the extended spectrum, value for value."""
    r, l, rr, m = layout(is_real)
    c = len(l)
    mode = np.array([ch.MODE_USB, ch.MODE_LSB, ch.MODE_AM, ch.MODE_FM])
    jt, tt = tables(l, rr, m, mode, np.ones(c, bool), None)
    base = 0 if is_real else N // 2 + 1
    spec = spectra(1, 3, is_real)
    ext = jch.extend_spectrum(jnp.asarray(spec), is_real, r, A)
    np.testing.assert_array_equal(
        ch.extend_spectrum(torch.from_numpy(spec), is_real, r, A).numpy(),
        np.asarray(ext))
    want = jch.gather_channel_bins(ext, jt, audio_fft_size=A,
                                   fft_result_size=r, base_idx=base)
    got = ch.gather_channel_bins(torch.from_numpy(spec), tt,
                                 audio_fft_size=A, fft_result_size=r,
                                 base_idx=base, is_real=is_real)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2e-4, atol=1e-12)


def run_both(is_real, mode, am_sync, am_env, active, frame0, steps=3,
             b=4, seed=0):
    r, l, rr, m = layout(is_real)
    c = len(l)
    jt, tt = tables(l, rr, m, mode, active, am_env)
    base = 0 if is_real else N // 2 + 1
    kw = dict(audio_fft_size=A, fft_result_size=r, base_idx=base,
              is_real=is_real, am_sync=am_sync, carrier_cutoff=10)
    js = jch.init_channel_state(c, A)
    ts = ch.init_channel_state(c, A)
    out = []
    for s in range(steps):
        spec = spectra(seed + s, b, is_real)
        ext = jch.extend_spectrum(jnp.asarray(spec), is_real, r, A)
        js, ja, jp = jch.demodulate_batch(ext, jt, js, jnp.int32(frame0),
                                          **kw)
        ts, ta, tp = ch.demodulate_batch(torch.from_numpy(spec), tt, ts,
                                         frame0, **kw)
        out.append((np.asarray(ja), ta.numpy(), np.asarray(jp), tp.numpy()))
        frame0 += b
    return out, js, ts


def assert_audio(out):
    for ja, ta, jp, tp in out:
        scale = max(np.abs(ja).max(), 1e-3)
        np.testing.assert_allclose(ta, ja, atol=2e-4 * scale + 1e-5, rtol=0)
        np.testing.assert_allclose(tp, jp, rtol=2e-4, atol=1e-12)


@pytest.mark.parametrize("mode", [ch.MODE_USB, ch.MODE_LSB, ch.MODE_AM,
                                  ch.MODE_FM])
@pytest.mark.parametrize("is_real", [False, True])
@pytest.mark.parametrize("frame0", [0, 5])
def test_demodulate_batch_matches_jax(mode, is_real, frame0):
    c = 4
    out, js, ts = run_both(is_real, np.full(c, mode), True,
                           np.zeros(c, bool), np.array([1, 1, 1, 0], bool),
                           frame0)
    assert_audio(out)
    for f in ("ssb_prev", "cplx_prev", "fm_prev", "carrier_prev"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-5)


def test_am_sync_mixed_envelope_and_pll_rows():
    """am_sync on, AM rows split between the PLL and the per-client
    envelope opt-out; the PLL carries advance like JAX's."""
    c = 4
    out, js, ts = run_both(False, np.full(c, ch.MODE_AM), True,
                           np.array([0, 1, 0, 1], bool), np.ones(c, bool), 1)
    assert_audio(out)
    np.testing.assert_allclose(ts.pll_freq.numpy(), np.asarray(js.pll_freq),
                               atol=1e-7)
    assert np.abs(ts.pll_phase.numpy()).max() > 0


def test_pll_stage_skipped_without_an_am_listener():
    """No active AM listener wants the PLL: the stage does not run and
    its carries stay stale (not reset), as under JAX's lax.cond."""
    c = 4
    mode = np.array([ch.MODE_AM, ch.MODE_USB, ch.MODE_FM, ch.MODE_AM])
    active = np.array([1, 1, 1, 0], bool)
    am_env = np.array([1, 0, 0, 0], bool)      # the active AM row opts out
    r, l, rr, m = layout(False)
    _, tt = tables(l, rr, m, mode, active, am_env)
    assert not tt.need_pll
    out, js, ts = run_both(False, mode, True, am_env, active, 0)
    assert_audio(out)
    st = ch.init_channel_state(c, A)
    stale = st._replace(pll_phase=torch.full((c,), 1.25),
                        pll_freq=torch.full((c,), 0.01),
                        carrier_prev=torch.ones((c, A // 2),
                                                dtype=torch.complex64))
    new, _, _ = ch.demodulate_batch(
        torch.from_numpy(spectra(3, 4, False)), tt, stale, 0,
        audio_fft_size=A, fft_result_size=N, base_idx=N // 2 + 1,
        is_real=False, am_sync=True, carrier_cutoff=10)
    for f in ("pll_phase", "pll_freq", "carrier_prev"):
        assert torch.equal(getattr(new, f), getattr(stale, f))


@pytest.mark.parametrize("carrier_kind", ["locked", "noise"])
def test_am_sync_detect_matches_jax(carrier_kind):
    rng = np.random.default_rng(11)
    c, n = 6, 2048
    t = np.arange(n)
    car = np.exp(1j * ((rng.random((c, 1)) - 0.5) * 0.02 * t
                       + rng.random((c, 1)) * 6))
    base = (car * (1 + 0.5 * np.sin(0.1 * t))[None]).astype(np.complex64)
    if carrier_kind == "locked":
        carrier = car + 0.01 * (rng.standard_normal((c, n))
                                + 1j * rng.standard_normal((c, n)))
    else:
        carrier = 0.3 * (rng.standard_normal((c, n))
                         + 1j * rng.standard_normal((c, n)))
    carrier = carrier.astype(np.complex64)
    p0 = rng.uniform(0, 6, c).astype(np.float32)
    f0 = rng.uniform(-0.01, 0.01, c).astype(np.float32)
    ja, jp, jf = (np.asarray(v) for v in jch.am_sync_detect(
        jnp.asarray(carrier), jnp.asarray(base), jnp.asarray(p0),
        jnp.asarray(f0)))
    ta, tp, tf = (v.numpy() for v in am_sync_detect_plain(
        *(torch.from_numpy(v) for v in (carrier, base, p0, f0))))
    scale = np.abs(base).max()
    np.testing.assert_allclose(ta, ja, atol=PLL_RTOL * scale, rtol=0)
    # phases compared on the circle (the wrap may land on either side)
    dphi = np.angle(np.exp(1j * (tp.astype(np.float64) - jp)))
    assert np.abs(dphi).max() < 1e-4
    np.testing.assert_allclose(tf, jf, atol=1e-6)
    assert ((tp >= 0) & (tp < 2 * np.pi + 1e-6)).all()     # wrapped


def test_pll_phase_wrap_follows_jnp_mod():
    """A phase that would grow without bound stays in [0, 2*pi)."""
    c, n = 2, 4096
    carrier = np.exp(1j * 0.3 * np.arange(n))[None].repeat(c, 0).astype(
        np.complex64)
    a, phase, _ = am_sync_detect_plain(
        torch.from_numpy(carrier), torch.from_numpy(carrier),
        torch.zeros(c), torch.zeros(c))
    assert ((phase >= 0) & (phase < 2 * np.pi)).all()
    assert torch.isfinite(a).all()


def test_pll_wrap_shortcut_equals_fmod():
    """csrc/pll.cu wraps x = phase + freq in (-2pi, 4pi) by one subtract
    or add of float32 2pi instead of fmodf + the sign fix; the two agree
    bit for bit there (Sterbenz), and differ at both excluded ends."""
    two_pi = np.float32(2 * np.pi)
    rng = np.random.default_rng(5)
    edges = np.array([
        np.nextafter(-two_pi, np.float32(0)), -0.0, 0.0, -1e-30,
        np.nextafter(two_pi, np.float32(0)), two_pi,
        np.nextafter(2 * two_pi, np.float32(0))], dtype=np.float32)
    x = np.concatenate([
        rng.uniform(-2 * np.pi, 4 * np.pi, 200_000).astype(np.float32),
        edges])
    x = x[(x > -two_pi) & (x < 2 * two_pi)]
    with np.errstate(invalid="ignore"):
        ref = np.fmod(x, two_pi)
    ref = np.where(ref < 0, ref + two_pi, ref)
    short = np.where(x >= two_pi, x - two_pi, np.where(x < 0, x + two_pi, x))
    assert ref.dtype == short.dtype == np.float32
    assert np.array_equal(ref.view(np.int32), short.view(np.int32))
    # the ends the shortcut leaves to fmodf: fmodf gives -0 and 0 there
    for end in (-two_pi, 2 * two_pi):
        r = np.fmod(end, two_pi)
        r = r + two_pi if r < 0 else r
        s = end - two_pi if end >= two_pi else (end + two_pi if end < 0 else end)
        assert r.view(np.int32) != np.float32(s).view(np.int32)


def test_pll_chain_probe_needs_a_card():
    """The chain probe is a measuring aid with no plain version."""
    c = torch.zeros((2, 8), dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA"):
        pll.chain_probe(c, torch.zeros(2), torch.zeros(2))
