"""The numerical ground of K-PLL's chain (phantomsdr_tpu_torch/csrc/pll.cu).

The kernel takes the phase detector as the identity
arg(c * exp(-i*phase)) = wrap(arg(c) - phase): theta = arg(c) comes from
atan2 of the carrier alone, and the chain computes err = theta - phase,
wrapped once by 2*pi into [-pi, pi].  Samples whose carrier is zero or not
finite, an err that does not land inside +-(pi - 1e-4), and a loop
frequency of 0.5 rad a sample or more take the plain detector (atan2 of
the carrier mixed down by the NCO).  Here that chain is
modelled in NumPy float32, operation for operation, and run against the
plain recursion of sdrbench's reference over one iq35 step of 6,480
samples, on a locked carrier, a carrier drifting 0.003 rad a sample and
noise alone: it has to stay within the card test's tolerances
(tests/test_torch_cuda.py: output 1e-5 of its scale, phase 1e-5, freq
1e-6).  The kernel's rounds predict 32 samples and keep those the rule
confirms; the two predictions that decide whether rows of zeros and rows
far from lock commit whole rounds are checked here too."""

import numpy as np
import pytest

from sdrbench.reference.dsp import PLL_ALPHA, PLL_BETA, TWO_PI, pll

F32 = np.float32
PI = F32(TWO_PI / F32(2))             # exact: a power-of-two scaling
EDGE = F32(PI - F32(1e-4))            # as the kernel's make_loop forms it
FREQ_EDGE = F32(0.5)
N = 6480                              # one iq35 step: 36 hops of 180


def identity_chain(car: np.ndarray, base: np.ndarray, phase: np.ndarray,
                   freq: np.ndarray):
    """K-PLL's chain: car, base [K, L] complex64; returns (out [K, L] f32,
    phase, freq, samples that took the plain detector)."""
    cr, ci = (np.ascontiguousarray(x.T) for x in (car.real, car.imag))
    br, bi = (np.ascontiguousarray(x.T) for x in (base.real, base.imag))
    with np.errstate(invalid="ignore"):
        other = (((cr == 0) & (ci == 0)) | ~np.isfinite(cr)
                 | ~np.isfinite(ci))
        theta = np.where(other, F32(np.nan), np.arctan2(ci, cr))
    out = np.empty_like(cr)
    phase, freq = phase.astype(F32), freq.astype(F32)
    mixed = 0
    for i in range(cr.shape[0]):
        cs, sn = np.cos(phase), np.sin(phase)
        err = theta[i] - phase
        err = np.where(err < -PI, err + TWO_PI, err)
        take = ~((np.abs(err) < EDGE) & (np.abs(freq) < FREQ_EDGE))
        if take.any():
            mixed += int(take.sum())
            err = np.where(take, np.arctan2(ci[i] * cs - cr[i] * sn,
                                            cr[i] * cs + ci[i] * sn), err)
        freq = freq + PLL_ALPHA * err
        phase = phase + PLL_BETA * err
        phase = np.fmod(phase + freq, TWO_PI)
        phase = np.where(phase < 0, phase + TWO_PI, phase)
        out[i] = br[i] * cs + bi[i] * sn
    return out.T, phase, freq, mixed


def carriers(kind: str, k: int, seed: int):
    rng = np.random.default_rng(seed)
    t = np.arange(N)
    ph0 = rng.uniform(0, 2 * np.pi, (k, 1))
    noise = rng.standard_normal((k, N)) + 1j * rng.standard_normal((k, N))
    if kind == "locked":
        car = np.exp(1j * ph0) + 0.05 * noise
    elif kind == "drifting":
        car = np.exp(1j * (0.003 * t + ph0)) + 0.05 * noise
    else:
        car = noise
    base = np.exp(1j * (0.003 * t + ph0)) * (1 + 0.5 * np.sin(0.05 * t))
    phase0 = rng.uniform(0, 6, k).astype(F32)
    return (car.astype(np.complex64), base.astype(np.complex64), phase0,
            np.zeros(k, F32))


@pytest.mark.parametrize("kind", ["locked", "drifting", "noise"])
def test_identity_chain_tracks_the_plain_recursion(kind):
    car, base, phase0, freq0 = carriers(kind, 32, seed=20 + len(kind))
    want_out, want_phase, want_freq = pll(car, base, phase0, freq0)
    out, phase, freq, mixed = identity_chain(car, base, phase0, freq0)
    assert np.abs(out - want_out).max() <= 1e-5 * np.abs(base).max()
    assert np.abs(phase - want_phase).max() <= 1e-5
    assert np.abs(freq - want_freq).max() <= 1e-6
    # a carrier the loop holds never comes near +-pi; noise alone rarely
    if kind == "noise":
        assert mixed < 1e-3 * car.size
    else:
        assert mixed == 0


def test_identity_chain_hands_edge_samples_to_the_plain_detector():
    """Signed zeros, NaN and an err a few ulp from +-pi give the plain
    recursion's step bit for bit: both sides run its detector there, from
    the same phase."""
    car, base, phase0, freq0 = carriers("locked", 4, seed=7)
    x = car.view(np.float32).reshape(4, N, 2)
    x[0, 0] = (-0.0, 0.0)
    x[1, 0] = (-0.0, -0.0)
    x[2, 0, 0] = np.nan
    ulp = float(np.spacing(F32(np.pi)))
    a = float(phase0[3]) + np.pi + 2 * ulp
    x[3, 0] = (np.cos(a), np.sin(a))
    want = pll(car[:, :1], base[:, :1], phase0, freq0)
    got = identity_chain(car[:, :1], base[:, :1], phase0, freq0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == 4


@pytest.mark.parametrize("freq0", [7.0, 13.0])
def test_identity_chain_far_from_lock_is_the_plain_recursion(freq0):
    """A loop frequency of 0.5 rad a sample or more holds no carrier;
    there the chain runs the plain detector, so a row that starts at
    freq0 (and stays far from lock) matches bit for bit."""
    car, base, phase0, _ = carriers("drifting", 8, seed=9)
    freq0 = np.full(8, freq0, F32)
    want = pll(car, base, phase0, freq0)
    got = identity_chain(car, base, phase0, freq0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[3] == car.size


# the float32 bounds of sincosf's signs that the kernel's zero_or reads
PI_F = np.uint32(0x40490fdb).view(F32)
HALF_PI_F = np.uint32(0x3fc90fdb).view(F32)
THREE_HALF_PI_F = np.uint32(0x4096cbe4).view(F32)


def zero_or(sx: int, sy: int, phase: np.float32) -> np.float32:
    """The kernel's err for a zero carrier sample from the signs alone:
    re = x*cs + y*sn and im = y*cs - x*sn are signed zeros."""
    s = int(np.signbit(phase)) | int(phase >= PI_F)
    k = int(phase >= HALF_PI_F) & int(phase < THREE_HALF_PI_F)
    re_neg = (sx ^ k) & (sy ^ s)
    im_neg = (sy ^ k) & (sx ^ s ^ 1)
    mag = int(PI.view(np.uint32)) if re_neg else 0
    return np.uint32(mag | (im_neg << 31)).view(F32)


def test_zero_samples_take_the_mixed_detector_from_the_quadrant():
    """A channel slot without a listener feeds the PLL zeros; the kernel
    predicts their mixed-detector err from the phase's quadrant, which is
    atan2 of the mixed signed zeros, bit for bit, over [0, 2pi) and at
    the float32 neighbours of the quadrant bounds."""
    rng = np.random.default_rng(20)
    edges = [np.uint32(b).view(F32) for b in (
        0x3fc90fda, 0x3fc90fdb, 0x40490fda, 0x40490fdb, 0x4096cbe3,
        0x4096cbe4, 0x40c90fda)]
    phases = np.concatenate([rng.uniform(0, TWO_PI, 4000).astype(F32),
                             np.array(edges + [0.0, -0.0], F32)])
    cs, sn = np.cos(phases), np.sin(phases)
    for sx in (0, 1):
        for sy in (0, 1):
            x, y = F32(-0.0 if sx else 0.0), F32(-0.0 if sy else 0.0)
            want = np.arctan2(y * cs - x * sn, x * cs + y * sn)
            got = np.array([zero_or(sx, sy, p) for p in phases], F32)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def wrap_pred(x: np.float32, k0: float) -> np.float32:
    """The kernel's prediction wrap: x - k*2pi by fmaf (modelled exactly
    in float64: k*2pi and the difference need fewer than 53 bits here),
    k = k0 corrected by one where the first remainder leaves [0, 2pi)."""
    fma = lambda k: F32(float(x) - k * float(TWO_PI))
    r = fma(k0)
    k = k0 + (1.0 if r >= TWO_PI else 0.0) - (1.0 if r < 0 else 0.0)
    return fma(k)


@pytest.mark.parametrize("freq", [0.0, 0.3, -0.4, 3.0, -9.0, 40.0])
def test_prediction_wrap_is_the_loops_wrap(freq):
    """Over the phases a round can reach from its loop frequency -- x =
    phase + beta*err + freq with phase in [0, 2pi) -- the prediction's
    wrap, k0 = floor(freq / 2pi) (0 at |freq| < 5.5), gives the loop's
    fmod and sign rule bit for bit, so a row far from lock commits a
    whole round as often as one on the identity."""
    rng = np.random.default_rng(int(abs(freq) * 10) + 1)
    k0 = float(np.floor(F32(freq) / TWO_PI)) if abs(freq) >= 5.5 else 0.0
    x = (rng.uniform(-0.3, float(TWO_PI) + 0.3, 4000)
         + rng.uniform(-0.15, 0.15, 4000) + freq).astype(F32)
    for xi in x:
        want = np.fmod(xi, TWO_PI)
        want = F32(want + TWO_PI) if want < 0 else want
        assert wrap_pred(xi, k0).view(np.uint32) == F32(want).view(np.uint32)
