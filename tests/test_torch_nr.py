"""PyTorch port vs the JAX package: spectral noise reduction
(``ops/nr.py``; its frame recursion is kernel K-NR on the card, the
plain version here).  Same numpy inputs through both, over chained calls
that carry the state, with 5 channels (tests/test_nr.py's recipes).

Tolerances are the JAX package's own bar against its oracle: the
int16-domain output within 1 (one step of the rounding grid) on under
0.5% of samples, the carries within rtol 1e-4 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.ops import nr as jnr
from phantomsdr_tpu_torch.ops import nr as tnr
from phantomsdr_tpu_torch.ops.cuda import nr as knr

F = 180
FS = 12000
C = 5


def noisy_tones(nfr: int, seed=0, tone_from=1.2) -> np.ndarray:
    """[C, nfr*F]: noise first (the 20-frame init learns noise), then a
    tone per channel (700 Hz + 60 Hz a channel) at rising levels."""
    rng = np.random.default_rng(seed)
    t = np.arange(nfr * F) / FS
    gate = (t > tone_from).astype(float)
    rows = [(2000 + 1000 * c) * np.sin(2 * np.pi * (700 + 60 * c) * t) * gate
            + 1500 * rng.standard_normal(nfr * F) for c in range(C)]
    return np.round(np.stack(rows)).astype(np.float32)


def run_both(sig, frames_per_call, jstate=None, tstate=None):
    jp, tp = jnr.make_nr_params(F), tnr.make_nr_params(F)
    js = jstate if jstate is not None else jnr.init_nr_state(C, F)
    ts = tstate if tstate is not None else tnr.init_nr_state(C, F)
    jo, to = [], []
    step = frames_per_call * F
    for i in range(0, sig.shape[1], step):
        blk = sig[:, i:i + step]
        js, jy = jnr.nr_process(js, jp, jnp.asarray(blk), frames_per_call)
        ts, ty = tnr.nr_process(ts, tp, torch.from_numpy(blk),
                                frames_per_call)
        jo.append(np.asarray(jy))
        to.append(ty.numpy())
    return js, ts, np.concatenate(jo, 1), np.concatenate(to, 1)


def assert_output_close(jo, to):
    d = np.abs(jo - to)
    assert d.max() <= 1.0
    assert (d > 0).mean() < 0.005


def assert_state_close(js, ts):
    for name in jnr.NRState._fields:
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("frames_per_call", [6, 36])
def test_nr_process_matches_jax_over_chained_calls(frames_per_call):
    sig = noisy_tones(72)
    js, ts, jo, to = run_both(sig, frames_per_call)
    assert_output_close(jo, to)
    assert_state_close(js, ts)
    assert int(ts.stage[0]) == jnr.INIT_FRAMES + 1


def test_nr_reset_rows_rearm_like_jax():
    """A zeroed row mid-stream (the pipeline's full reset) starts its
    20-frame accumulation again, next to rows that keep running."""
    sig = noisy_tones(48, seed=1)
    js, ts, _, _ = run_both(sig[:, :24 * F], 6)
    keep = np.array([True, False, True, True, False])
    js = jax.tree.map(lambda x: jnp.where(
        jnp.asarray(keep).reshape((-1,) + (1,) * (x.ndim - 1)), x, 0), js)
    ts = tnr.NRState(*(torch.where(torch.from_numpy(keep).reshape(
        (-1,) + (1,) * (x.dim() - 1)), x, 0) for x in ts))
    js, ts, jo, to = run_both(sig[:, 24 * F:], 6, js, ts)
    assert_output_close(jo, to)
    assert_state_close(js, ts)
    assert int(ts.stage[1]) == 21 and int(ts.stage[0]) == 21


def test_nr_silent_rows_stay_finite_like_jax():
    sig = noisy_tones(30, seed=2)
    sig[1] = 0.0
    js, ts, jo, to = run_both(sig, 6)
    assert np.isfinite(to).all() and not to[1].any()
    assert_output_close(jo, to)


def jax_gain_scan(st, p, x_pow):
    def body(s, xp):
        s2, g, run = jnr._gain_frame(p, s, xp)
        return s2, (g, run[:, 0])
    return jax.lax.scan(body, st, jnp.asarray(x_pow))


@pytest.mark.parametrize("stages", [(0, 0, 0, 0, 0), (0, 10, 19, 20, 21),
                                    (18, 19, 20, 21, 21)])
def test_gain_frames_match_jax_scan(stages):
    """The K-NR recursion's plain version against JAX's frame scan over
    _gain_frame, from fresh, accumulating and running channels: the
    fresh overrides, the clamp at INIT_FRAMES + 1 and the 20th frame
    that both accumulates and runs."""
    rng = np.random.default_rng(sum(stages))
    n = 8
    x_pow = (rng.exponential(1e6, (n, C, F))
             * (1 + 50 * (rng.random((n, C, F)) < 0.05))).astype(np.float32)
    x_pow[:, :, 0] = 0.0                       # the 1e-30 guards
    carries = [np.abs(rng.standard_normal((C, F))).astype(np.float32) * s
               for s in (1e6, 1e6, 0.5, 3.0)]
    jst = jnr.init_nr_state(C, F)._replace(
        stage=jnp.asarray(stages, jnp.int32),
        **{k: jnp.asarray(v) for k, v in zip(("nest", "xt", "pslp",
                                               "hk_old"), carries)})
    jp = jnr.make_nr_params(F)
    jst, (jg, jrun) = jax_gain_scan(jst, jp, x_pow)
    tcar, tg, trun = knr.gain_frames(
        (torch.tensor(stages, dtype=torch.int32),
         *(torch.from_numpy(v) for v in carries)),
        jp.alpha, jp.xih1r, jp.pfac, torch.from_numpy(x_pow))
    np.testing.assert_array_equal(trun.numpy(), np.asarray(jrun))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5)
    np.testing.assert_array_equal(tcar[0].numpy(), np.asarray(jst.stage))
    for name, got in zip(("nest", "xt", "pslp", "hk_old"), tcar[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jst, name)),
                                   rtol=1e-5, err_msg=name)


# the kinds of rows edge_inputs makes: powers of noise, silence (exact
# zeros: the 1e-30 guards alone keep the divisions finite), subnormal
# powers (xt_safe is 1e-30) and huge ones (exp underflows to 0, the
# a-posteriori SNR clamps at 1000)
ROW_KINDS = ("noise", "silent", "subnormal", "huge")


def edge_inputs(f, n, seed):
    """x_pow [n, C, f] and carries for 22 * 4 channels: every starting
    stage 0-21 with each row kind (channel c has stage c % 22 and kind
    ROW_KINDS[c // 22])."""
    rng = np.random.default_rng(seed)
    c = 22 * len(ROW_KINDS)
    expo = rng.exponential(1.0, (n, c, f))
    scale = np.repeat([1e6, 0.0, 1e-40, 1e35], 22)[None, :, None]
    x_pow = (expo * scale).astype(np.float32)
    stages = (np.arange(c) % 22).astype(np.int32)
    carries = [np.abs(rng.standard_normal((c, f))).astype(np.float32) * s
               for s in (1e6, 1e6, 0.5, 3.0)]
    return x_pow, stages, carries


@pytest.mark.parametrize("f,n", [(1, 40), (33, 1), (33, 40), (257, 40)])
def test_gain_frames_match_jax_scan_at_the_kernels_edges(f, n):
    """The plain version against JAX's frame scan where the kernel's
    tiling and range tests have their edges: bins a channel that leave
    warps straddling channels (1, 33, 257), one frame and more frames
    than any register ring holds, every starting stage, and silent,
    subnormal and huge powers.  Gains within rtol 1e-5; the carries too,
    with an absolute floor of the smallest normal float32 (XLA on the CPU
    flushes subnormal results to zero, PyTorch and the card keep them)."""
    x_pow, stages, carries = edge_inputs(f, n, f * 100 + n)
    c = stages.shape[0]
    jst = jnr.init_nr_state(c, f)._replace(
        stage=jnp.asarray(stages),
        **{k: jnp.asarray(v) for k, v in zip(("nest", "xt", "pslp",
                                               "hk_old"), carries)})
    jp = jnr.make_nr_params(max(f, 2))
    jst, (jg, jrun) = jax_gain_scan(jst, jp, x_pow)
    tcar, tg, trun = knr.gain_frames(
        (torch.from_numpy(stages), *(torch.from_numpy(v) for v in carries)),
        jp.alpha, jp.xih1r, jp.pfac, torch.from_numpy(x_pow))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(trun.numpy(), np.asarray(jrun))
    np.testing.assert_array_equal(tcar[0].numpy(), np.asarray(jst.stage))
    assert np.isfinite(tg.numpy()).all()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5)
    for name, got in zip(("nest", "xt", "pslp", "hk_old"), tcar[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jst, name)),
                                   rtol=1e-5, atol=tiny, err_msg=name)


def test_smooth_gains_matches_jax():
    rng = np.random.default_rng(7)
    g = rng.uniform(0.001, 1.0, (6, C, F)).astype(np.float32)
    x_pow = rng.exponential(1e4, (6, C, F)).astype(np.float32)
    # rows with every smoothing width, and frames that do not run
    g[:, :, 1:] *= np.linspace(0.05, 1.0, C)[None, :, None]
    running = rng.random((6, C)) < 0.8
    want = jnr._smooth_gains(jnp.asarray(g), jnp.asarray(x_pow),
                             jnp.asarray(running)[..., None])
    got = tnr.smooth_gains(torch.from_numpy(g), torch.from_numpy(x_pow),
                           torch.from_numpy(running))
    # a moving average is the difference of two cumulative sums of up to
    # F gains, so it carries their rounding (F * 2^-24 ~ 1e-5) as an
    # absolute error; the two cumsums add in different orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=F * 2.0 ** -24)


def test_nr_params_match_jax():
    jp, tp = jnr.make_nr_params(F, 1.5, 0.9, 25.0), tnr.make_nr_params(
        F, 1.5, 0.9, 25.0)
    np.testing.assert_array_equal(tp.window, jp.window)
    assert tp[1:] == jp[1:]
