"""PyTorch port vs the JAX package: LMS noise reduction and auto-notch
(``ops/anr.py``; its chain of LMS blocks is kernel K-ANR on the card,
the plain version here).  Same numpy inputs through both, over chained
calls of uneven lengths (full blocks and a remainder block), 6 channels.

Tolerance: the outputs and every carry (hist, w, lidx, ngamma) within
1e-4 * max|x| (the sums of the 64-tap products add in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.ops import anr as janr
from phantomsdr_tpu_torch.ops import anr as tanr
from phantomsdr_tpu_torch.ops.cuda import anr as kanr

FS = 12000
C = 6


def tones(n: int, seed: int, noise=1000.0) -> np.ndarray:
    """[C, n]: an 800 Hz tone (other phases and levels per channel) in
    white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    rows = [(2000 + 800 * c) * np.sin(2 * np.pi * 800 * t + c)
            + noise * rng.standard_normal(n) for c in range(C)]
    return np.stack(rows).astype(np.float32)


def run_both(x, sizes, notch, jstate=None, tstate=None, **kw):
    jp = janr.make_anr_params(notch=notch, **kw)
    tp = tanr.make_anr_params(notch=notch, **kw)
    js = jstate if jstate is not None else janr.init_anr_state(C, jp)
    ts = tstate if tstate is not None else tanr.init_anr_state(C, tp)
    jo, to, at = [], [], 0
    for n in sizes:
        blk = x[:, at:at + n]
        at += n
        js, jy = janr.anr_process(js, jp, jnp.asarray(blk))
        ts, ty = tanr.anr_process(ts, tp, torch.from_numpy(blk))
        jo.append(np.asarray(jy))
        to.append(ty.numpy())
    return js, ts, np.concatenate(jo, 1), np.concatenate(to, 1)


def assert_close(js, ts, jo, to, scale):
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-4 * scale)
    for name in janr.ANRState._fields:
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("notch", [False, True])
def test_anr_matches_jax_over_chained_calls(notch):
    """6480-sample steps (25 blocks of 256 and one of 80, the bench
    shape), then a step of 1000 (3 blocks and a remainder of 232)."""
    x = tones(3 * 6480 + 1000, seed=4)
    js, ts, jo, to = run_both(x, [6480, 6480, 6480, 1000], notch)
    assert_close(js, ts, jo, to, np.abs(x).max())
    assert float(ts.lidx[0]) == janr.LIDX_MIN


@pytest.mark.parametrize("two_mu", [8e-3, 0.05])
def test_anr_stability_cap_matches_jax(two_mu):
    """Aggressive gains shrink the block to 0.5/two_mu samples (62, 10)."""
    x = tones(3000, seed=5)
    p = tanr.make_anr_params(two_mu=two_mu)
    assert tanr.block_size(p, 1500) == int(0.5 / two_mu)
    js, ts, jo, to = run_both(x, [1500, 1500], False, two_mu=two_mu)
    assert_close(js, ts, jo, to, np.abs(x).max())


def test_anr_reset_rows_start_unarmed_like_jax():
    """Rows zeroed mid-stream (lidx = ngamma = 0: the leak automaton's
    unarmed phase) next to running rows."""
    x = tones(4000, seed=6)
    js, ts, _, _ = run_both(x[:, :2000], [2000], False)
    keep = np.array([True, False, True, False, True, True])
    js = janr.ANRState(*(jnp.where(jnp.asarray(keep).reshape(
        (-1,) + (1,) * (v.ndim - 1)), v, 0) for v in js))
    ts = tanr.ANRState(*(torch.where(torch.from_numpy(keep).reshape(
        (-1,) + (1,) * (v.dim() - 1)), v, 0) for v in ts))
    js, ts, jo, to = run_both(x[:, 2000:], [1000, 1000], False, js, ts)
    assert_close(js, ts, jo, to, np.abs(x).max())


@pytest.mark.parametrize("n", [1, 2, 80, 255, 256, 1000])
def test_int_pow_is_jax_integer_pow(n):
    """``lam ** bsz`` in JAX is lax.integer_pow (binary exponentiation in
    float32), not powf: the port repeats its products bit for bit."""
    lam = np.float32(1.0) - np.float32(1e-4) * np.float32(0.01296)
    x = np.array([lam, 0.999, 0.5, 1.0001], np.float32)
    want = np.asarray(jnp.asarray(x) ** n)
    got = kanr.int_pow(torch.from_numpy(x), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_tracks_the_exact_filter():
    """The documented deviation of the block form: after adaptation the
    port's output tracks JAX's per-sample anr_process_exact (ANR.c
    1:1) within 5% RMS, on both modes, over uneven chunks."""
    x = tones(24000, seed=7)[:1]
    for notch in (False, True):
        p = janr.make_anr_params(notch=notch)
        _, ye = janr.anr_process_exact(janr.init_anr_state(1, p),
                                       p, jnp.asarray(x))
        ts = tanr.init_anr_state(1, tanr.make_anr_params(notch=notch))
        outs = []
        for i in range(0, x.shape[1], 7000):
            ts, y = tanr.anr_process(ts, tanr.make_anr_params(notch=notch),
                                     torch.from_numpy(x[:, i:i + 7000]))
            outs.append(y.numpy()[0])
        yb, ye = np.concatenate(outs), np.asarray(ye)[0]
        q = 3 * x.shape[1] // 4
        num = np.sqrt(((yb[q:] - ye[q:]) ** 2).mean())
        assert num / np.sqrt((ye[q:] ** 2).mean()) < 0.05, notch


def test_notch_removes_the_carrier():
    """Auto-notch at two_mu 1e-3: the 800 Hz carrier > 26 dB down."""
    x = tones(24000, seed=8, noise=500.0)[:1]
    p = tanr.make_anr_params(notch=True, two_mu=1e-3)
    _, y = tanr.anr_process(tanr.init_anr_state(1, p), p,
                            torch.from_numpy(x))
    y = y.numpy()[0]
    q = 3 * y.size // 4
    ph = np.exp(-2j * np.pi * 800 * np.arange(q, y.size) / FS)
    assert np.abs(np.sum(y[q:] * ph)) * 2 / (y.size - q) < 0.05 * 2000


def test_zero_width_state_when_off():
    st = tanr.init_anr_state(3, None)
    assert st.hist.shape == (3, 0) and st.w.shape == (3, 0)
    assert not st.lidx.any() and not st.ngamma.any()


def ring_mirror(state, params, x):
    """K-ANR's staging and index arithmetic (csrc/anr.cu) in torch: the
    stream X (X(i < 0) the history) goes through a ring of lkeep + 2
    segments, each sample stored at q = (i + lkeep) mod ring and at
    q + ring, in the kernel's order (history and segment 0 first, each
    next segment when the one before starts); a segment's blocks read
    the run from its start % ring on, and its window powers come from
    one pass over that run before its blocks.  Unwritten places are NaN,
    so a read of one shows."""
    taps, delay = params.taps, params.delay
    c, t = x.shape
    bsz = tanr.block_size(params, t)
    lkeep = taps + delay - 1
    seg_max = kanr.segment_len(bsz)
    ring_len = lkeep + 2 * seg_max
    ring = torch.full((c, 2 * ring_len), float("nan"))

    def put(i0, vals):
        q = (torch.arange(vals.shape[1]) + i0 + lkeep) % ring_len
        ring[:, q] = vals
        ring[:, q + ring_len] = vals

    put(-lkeep, state.hist[:, :lkeep].flip(1))
    put(0, x[:, :seg_max])
    two_mu, gamma = float(np.float32(params.two_mu)), float(np.float32(params.gamma))
    w, lidx, ngamma = state.w, state.lidx, state.ngamma
    outs, seg, seg_n = [], None, 0
    taps_j = torch.arange(taps)[None, :]
    for s0 in range(0, t, seg_max):
        nseg = min(seg_max, t - s0)
        if s0 + seg_max < t:
            put(s0 + seg_max, x[:, s0 + seg_max:s0 + 2 * seg_max])
        seg, seg_n = ring[:, s0 % ring_len:], nseg
        win = seg[:, torch.arange(nseg)[:, None] + taps - 1 - taps_j]
        sig = (win * win).sum(2)
        inv = 1.0 / (sig + 1e-10)
        for b in range(0, nseg, bsz):
            nb = min(bsz, nseg - b)
            n = torch.arange(b, b + nb)
            wn = seg[:, n[:, None] + taps - 1 - taps_j]        # [C, nb, taps]
            xn = seg[:, lkeep + n]
            y = (wn * w[:, None, :]).sum(2)
            err = xn - y
            outs.append(err if params.notch else 4.0 * y)
            sn, iv = sig[:, n], inv[:, n]
            nel = torch.abs(err * (1.0 - two_mu * sn * iv))
            nev = torch.abs(xn - (1.0 - two_mu * ngamma)[:, None] * y
                            - two_mu * err * sn * iv)
            lidx = torch.where((nev < nel).any(1), kanr.LIDX_MIN, lidx)
            ngamma = gamma * (lidx * lidx) * (lidx * lidx) * kanr.DEN_MULT
            lam = 1.0 - two_mu * ngamma
            g = ((two_mu * err * iv)[:, :, None] * wn).sum(1)
            w = kanr.int_pow(lam, nb)[:, None] * w + g
    hist = seg[:, lkeep + seg_n - 1 - torch.arange(taps + delay)]
    return tanr.ANRState(hist, w, lidx, ngamma), torch.cat(outs, 1)


@pytest.mark.parametrize("two_mu,taps,delay,sizes", [
    (1e-4, 64, 8, [9000, 5000]),       # blocks of 256, segments of 2048
    (8e-3, 17, 1, [7000]),             # blocks of 62, segments of 2046
    (1e-4, 128, 128, [4500]),          # history of 255, one wrap
    (0.5, 16, 2, [4200]),              # blocks of one sample
])
def test_anr_ring_mirror_matches_jax(two_mu, taps, delay, sizes):
    """The kernel's ring, read where the wrap splits a segment's run and
    a block, against the JAX package's anr_process over the same chained
    calls: outputs and carries within 1e-4 * max|x|, and no read of a
    place the staging had not written."""
    x = tones(sum(sizes), seed=9 + taps)
    kw = dict(two_mu=two_mu, taps=taps, delay=delay)
    jp = janr.make_anr_params(**kw)
    tp = tanr.make_anr_params(**kw)
    js, ts = janr.init_anr_state(C, jp), tanr.init_anr_state(C, tp)
    at, jo, to = 0, [], []
    for n in sizes:
        assert n > taps + delay - 1 + 2 * kanr.segment_len(tanr.block_size(tp, n))
        blk = x[:, at:at + n]
        at += n
        js, jy = janr.anr_process(js, jp, jnp.asarray(blk))
        ts, ty = ring_mirror(ts, tp, torch.from_numpy(blk))
        assert torch.isfinite(ty).all()
        jo.append(np.asarray(jy))
        to.append(ty.numpy())
    assert_close(js, ts, np.concatenate(jo, 1), np.concatenate(to, 1), np.abs(x).max())
