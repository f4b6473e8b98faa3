"""PyTorch port vs the JAX package: the Wild noise blanker
(``ops/nb.py``; its LPC fit, impulse search and repairs are kernel K-NB
on the card, the plain versions here).  Same numpy inputs through both,
over chained calls (the working-buffer tail carried), 6 channels, with
tests/test_nr.py's recipes: seed 0 with impulses at 700/1900/2500/4100/
5200, seed 4 with a 40-sample burst at 900:940 and a pair 20 apart.

Detection is a threshold, so the impulse counts and positions must be
equal; the output and the carried tail within 1e-5 * max|x|, the JAX
package's bar against its oracle.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.ops import nb as jnb
from phantomsdr_tpu_torch.ops import nb as tnb
from phantomsdr_tpu_torch.ops.cuda import nb as knb

FS = 12000
T = 2000


def impulses() -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(3 * T) / FS
    sig = 4000 * np.sin(2 * np.pi * 600 * t) + 300 * rng.standard_normal(3 * T)
    for p in (700, 1900, 2500, 4100, 5200):
        sig[p] += 25000
    return sig


def burst() -> np.ndarray:
    rng = np.random.default_rng(4)
    t = np.arange(2 * T) / FS
    sig = 3000 * np.sin(2 * np.pi * 500 * t) + 250 * rng.standard_normal(2 * T)
    sig[900:940] += 20000 * rng.choice([-1.0, 1.0], 40)
    sig[2600] += 25000
    sig[2620] -= 25000
    return sig


def channels(sig: np.ndarray) -> np.ndarray:
    """6 rows of one recipe: as made, shifted, scaled, with the impulses
    moved near a frame edge, and a silent row."""
    rows = [sig, np.roll(sig, 37), 0.5 * sig, np.roll(sig, -650),
            np.roll(sig, T // 2 + 3), np.zeros_like(sig)]
    return np.stack(rows).astype(np.float32)


# the JAX package's functions, compiled once per shape (op by op they
# take tens of seconds here)
jax_nb_process = jax.jit(jnb.nb_process, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def jax_residual(state, params, x):
    """The LPC fit and residual nb_process thresholds, with the JAX
    package's own _levinson and _fir_fresh (nb.py:104-124)."""
    t = x.shape[1]
    order, il = params.taps, params.impulse_len
    pl = (il - 1) // 2
    wb = jnp.concatenate([state.tail, x], axis=1)
    base = wb[:, order + pl: order + pl + t]
    r = jnp.stack([jnp.sum(base[:, :t - i] * base[:, i:t], axis=1)
                   for i in range(order + 1)], axis=1)
    lpcs = jnb._levinson(r, order)
    return lpcs, jnb._fir_fresh(lpcs, jnb._fir_fresh(lpcs[:, ::-1], base))


def jax_search(state, params, x):
    """The JAX package's detection on the frame nb_process sees
    (nb.py:104-161): count [C] and positions [C, 20] of the greedy
    rule."""
    c, t = x.shape
    order, il = params.taps, params.impulse_len
    pl = (il - 1) // 2
    lpcs, temp = jax_residual(state, params, jnp.asarray(x))
    temp = np.asarray(temp)
    mean = temp.mean(axis=1, keepdims=True)
    sigma2 = ((temp - mean) ** 2).sum(axis=1) / np.float32(t - 1)
    lpc_power = (np.asarray(lpcs)[:, :order] ** 2).sum(axis=1)
    thr = np.float32(params.thresh) * np.sqrt(sigma2 * lpc_power)
    count = np.zeros(c, np.int32)
    positions = np.zeros((c, knb.N_IMPULSE_COUNT), np.int32)
    for ch in range(c):
        nxt = order + pl
        for pos in np.nonzero(np.abs(temp[ch]) > thr[ch])[0]:
            if pos >= nxt and count[ch] < knb.N_IMPULSE_COUNT:
                positions[ch, count[ch]] = pos - order
                count[ch] += 1
                nxt = pos + pl + 1
    return count, positions


def run_both(x, frame, params=(5.0, 32, 11)):
    jp, tp = jnb.make_nb_params(*params), tnb.make_nb_params(*params)
    c = x.shape[0]
    js, ts = jnb.init_nb_state(c, jp), tnb.init_nb_state(c, tp)
    scale = np.abs(x).max()
    counts, outs = [], []
    for i in range(0, x.shape[1], frame):
        blk = x[:, i:i + frame]
        want_count, want_pos = jax_search(js, jp, blk)
        js, jy = jax_nb_process(js, jp, jnp.asarray(blk))
        ts, ty, count, positions, _, _ = tnb.nb_process_detail(
            ts, tp, torch.from_numpy(blk))
        np.testing.assert_array_equal(count.numpy(), want_count)
        np.testing.assert_array_equal(positions.numpy(), want_pos)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(ts.tail.numpy(), np.asarray(js.tail),
                                   rtol=0, atol=1e-5 * scale)
        counts.append(count.numpy())
        outs.append(ty.numpy())
    return np.stack(counts), np.concatenate(outs, 1)


def test_nb_matches_jax_on_separate_impulses():
    x = channels(impulses())
    counts, out = run_both(x, T)
    assert counts[:, :5].sum() > 0 and not counts[:, 5].any()
    # every injected impulse of row 0 repaired to near the signal
    for p in (700, 1900, 2500, 4100, 5200):
        assert abs(out[0, p]) < 6000 < abs(x[0, p])


def test_nb_matches_jax_on_a_burst():
    """Detections at the minimum skip-ahead gap, overlapping repair
    windows, forward bases that hold earlier repairs."""
    x = channels(burst())
    counts, out = run_both(x, T)
    assert counts[0].max() >= 5
    assert np.abs(out[0, 900:940]).max() < np.abs(x[0, 900:940]).max() / 2


@pytest.mark.parametrize("params,frame", [((4.0, 16, 5), 1500),
                                          ((6.0, 24, 21), 2000),
                                          ((5.0, 1, 3), 1000)])
def test_nb_matches_jax_at_other_settings(params, frame):
    """Other orders, repair lengths and frame lengths (nb_taps 1..40,
    nb_samples 3..201)."""
    x = channels(burst())[:, :3000]
    run_both(x, frame, params)


def test_nb_caps_at_20_impulses_like_jax():
    """30 clicks at random gaps of 12-40 samples in one frame: the
    search stops at 20 slots, the rest pass."""
    sig = burst()
    rng = np.random.default_rng(12)
    at = 200 + np.cumsum(rng.integers(12, 41, 30))
    sig[at] += 22000 * rng.choice([-1.0, 1.0], 30)
    counts, _ = run_both(channels(sig), T)
    assert counts[0, 0] == knb.N_IMPULSE_COUNT


def test_lpc_coefficients_predict_like_the_recursion():
    """coef_f / coef_b_rev against the il-step LPC predictions run
    sample by sample in float64 from the same lpcs (NB.c:218-243)."""
    order, il = 12, 9
    pl = (il - 1) // 2
    rng = np.random.default_rng(3)
    wb = rng.standard_normal((3, 400 + 2 * order + 2 * pl)).astype(np.float32)
    lpcs, cf, cb = knb.lpc_coeffs(torch.from_numpy(wb), 400, order, il)
    a = lpcs.double().numpy()
    basis = rng.standard_normal((3, order))
    for ch in range(3):
        fwd, bwd = list(basis[ch]), list(basis[ch])
        f_pred, b_pred = [], []
        for _ in range(il):
            v = -sum(a[ch, k] * fwd[-k] for k in range(1, order + 1))
            fwd.append(v)
            f_pred.append(v)
            v = -sum(a[ch, k] * bwd[k - 1] for k in range(1, order + 1))
            bwd.insert(0, v)
            b_pred.insert(0, v)
        np.testing.assert_allclose(cf[ch].double().numpy() @ basis[ch],
                                   f_pred, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(cb[ch].double().numpy() @ basis[ch],
                                   b_pred, rtol=1e-4, atol=1e-4)


def test_fir_fresh_matches_jax():
    rng = np.random.default_rng(9)
    coeffs = rng.standard_normal((4, 33)).astype(np.float32)
    x = rng.standard_normal((4, 500)).astype(np.float32)
    want = np.asarray(jnb._fir_fresh(jnp.asarray(coeffs), jnp.asarray(x)))
    got = tnb.fir_fresh(torch.from_numpy(coeffs), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_nb_params_and_state_match_jax():
    assert tnb.make_nb_params(5.0, 32, 10) == jnb.make_nb_params(5.0, 32, 10)
    p = tnb.make_nb_params()
    assert tnb.init_nb_state(3, p).tail.shape == (3, 2 * 32 + 2 * 5)
    assert tnb.init_nb_state(3, None).tail.shape == (3, 0)


def span_mirror(wb, temp, lpcs, coef_f, coef_b_rev, thresh, order, il):
    """K-NB's repair launch (csrc/nb.cu) in torch, channel by channel,
    with its index arithmetic: slot j's span wb[p_j .. p_j + 2*order +
    il) sits in a compact buffer at off_j, off_j = off_{j-1} + min(p_j -
    p_{j-1}, span), twice (original and current samples); the backward
    predictions read the original, the chain reads orig + (current -
    orig) and writes the current; the repaired buffer takes a sample
    from the current samples of the latest span that starts at or
    before it, if the span reaches it, else from wb.  Unwritten places
    are NaN, so a read of one shows.  (wbf, count, positions)."""
    c, wlen = wb.shape
    pl = knb.half_len(il)
    span = 2 * order + il
    thr = knb.threshold_plain(temp, lpcs, thresh, order)
    count, positions = knb.search_plain(temp, thr, order, pl)
    wfw, wbw = knb.crossfade(il, wb.device)
    wbf = wb.clone()
    for ch in range(c):
        pos = positions[ch, :int(count[ch])].tolist()
        if not pos:
            continue
        offs = [0]
        for j in range(1, len(pos)):
            offs.append(offs[-1] + min(pos[j] - pos[j - 1], span))
        orig_c = torch.full((offs[-1] + span,), float("nan"))
        for p, off in zip(pos, offs):
            orig_c[off:off + span] = wb[ch, p:p + span]
        cur_c = orig_c.clone()
        for p, off in zip(pos, offs):
            bp = (coef_b_rev[ch] * orig_c[off + order + il:off + span]).sum(1)
            basis = orig_c[off:off + order] + (cur_c[off:off + order]
                                               - orig_c[off:off + order])
            fp = (coef_f[ch] * basis).sum(1)
            cur_c[off + order:off + order + il] = wfw * fp + wbw * bp
        n = torch.arange(wlen)
        pos_t, offs_t = torch.tensor(pos), torch.tensor(offs)
        j = torch.searchsorted(pos_t, n, right=True) - 1
        jc = j.clamp(min=0)
        inside = (j >= 0) & (n < pos_t[jc] + span)
        idx = torch.where(inside, offs_t[jc] + n - pos_t[jc], 0)
        wbf[ch] = torch.where(inside, cur_c[idx], wb[ch])
    return wbf, count, positions


@pytest.mark.parametrize("recipe,params", [("burst", (5.0, 32, 11)),
                                           ("impulses", (5.0, 32, 11)),
                                           ("burst", (4.0, 16, 5)),
                                           ("burst", (5.0, 1, 3))])
def test_nb_span_mirror_matches_jax(recipe, params):
    """The kernel's compact spans against the JAX package's nb_process
    over chained frames: the burst packs detections PL + 1 apart (spans
    and repair windows overlap, forward bases hold earlier repairs),
    the separate impulses leave spans apart; counts and positions
    equal, output and tail within 1e-5 * max|x|, no read of an
    unstaged place."""
    x = channels(burst() if recipe == "burst" else impulses())
    jp, tp = jnb.make_nb_params(*params), tnb.make_nb_params(*params)
    order, il = tp.taps, tp.impulse_len
    lo = order + knb.half_len(il)
    js, tail = jnb.init_nb_state(x.shape[0], jp), tnb.init_nb_state(x.shape[0], tp).tail
    scale = np.abs(x).max()
    overlapped = False
    for i in range(0, x.shape[1], T):
        blk = x[:, i:i + T]
        t = blk.shape[1]
        want_count, want_pos = jax_search(js, jp, blk)
        js, jy = jax_nb_process(js, jp, jnp.asarray(blk))
        wb = torch.cat([tail, torch.from_numpy(blk)], 1)
        lpcs, cf, cb = knb.lpc_coeffs_plain(wb, t, order, il)
        temp = tnb.fir_fresh(lpcs, tnb.fir_fresh(lpcs.flip(1), wb[:, lo:lo + t]))
        wbf, count, positions = span_mirror(wb, temp, lpcs, cf, cb, tp.thresh, order, il)
        assert torch.isfinite(wbf).all()
        np.testing.assert_array_equal(count.numpy(), want_count)
        np.testing.assert_array_equal(positions.numpy(), want_pos)
        np.testing.assert_allclose(wbf[:, lo:lo + t].numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(wbf[:, t:].numpy(), np.asarray(js.tail), rtol=0,
                                   atol=1e-5 * scale)
        gaps = np.diff(want_pos, axis=1)[np.arange(19)[None] < want_count[:, None] - 1]
        overlapped |= bool((gaps < il).any())
        tail = wbf[:, t:]
    assert overlapped == (recipe == "burst")
