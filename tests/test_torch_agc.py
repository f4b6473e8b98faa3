"""PyTorch port vs the JAX package: DC blocker, look-ahead AGC (the
plain version of kernel K-AGC) and the int16 conversion, on CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from phantomsdr_tpu.ops import agc as jagc
from phantomsdr_tpu.ops.channelizer import float_to_int16 as jf2i

from phantomsdr_tpu_torch.ops import agc
from phantomsdr_tpu_torch.ops.channelizer import float_to_int16
from phantomsdr_tpu_torch.ops.cuda.agc import agc_int16, chain_probe


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_dc_blocker_matches_jax_across_blocks():
    rng = np.random.default_rng(7)
    d, c, length = agc.dc_blocker_delay(12000), 3, 180 * 4
    x0 = (rng.standard_normal((c, 2 * length)) + 0.5).astype(np.float32)
    js = jagc.init_dc_state(c, d)
    ts = agc.init_dc_state(c, d)
    for blk in range(2):
        x = x0[:, blk * length:(blk + 1) * length]
        js, jy = jagc.dc_blocker(js, jnp.asarray(x), d)
        ts, ty = agc.dc_blocker(ts, t(x), d)
        # cumulative sums in another association order: float32 rounding
        # of the running sums (|sum| ~ 1e3 here) over d
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5,
                                   rtol=0)
        np.testing.assert_array_equal(ts.tail.numpy(), np.asarray(js.tail))


@pytest.mark.parametrize("sr", [2000, 12000])
def test_agc_matches_jax_across_blocks(sr):
    """Same inputs through both: the window max is exact and the gain
    recursion does the same float32 operations in the same order, so
    the outputs agree to float32 rounding."""
    rng = np.random.default_rng(sr)
    params = agc.make_agc_params(sr)
    assert params == jagc.make_agc_params(sr)
    w = params.window
    c, length = 3, 720
    nblk = -(-2 * w // length) + 1          # well past the warm-up
    x0 = (0.3 * rng.standard_normal((c, length * nblk))).astype(np.float32)
    x0[:, ::37] *= 5.0                      # peaks exercise the attack path
    x0[1] *= 40.0
    js = jagc.init_agc_state(c, w)
    ts = agc.init_agc_state(c, w)
    for blk in range(nblk):
        x = x0[:, blk * length:(blk + 1) * length]
        js, jy = jagc.agc_process(js, jnp.asarray(x), params)
        ts, ty = agc.agc_process(ts, t(x), params)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-7, err_msg=f"block {blk}")
        np.testing.assert_allclose(ts.gain.numpy(), np.asarray(js.gain),
                                   rtol=1e-6)
        np.testing.assert_array_equal(ts.seen.numpy(), np.asarray(js.seen))
        np.testing.assert_array_equal(ts.tail.numpy(), np.asarray(js.tail))
    assert (np.abs(ty.numpy()) > 0).all(axis=1).any()   # audio came out


def test_sliding_max_abs_exact():
    """The doubling window max (the formulation K-AGC uses) equals the
    brute-force sliding max exactly."""
    rng = np.random.default_rng(3)

    def brute(y, w, out_len):
        a = np.abs(y)
        return np.stack([a[..., i:i + w].max(-1) for i in range(out_len)], -1)

    cases = [(int(rng.integers(1, 40)), int(rng.integers(1, 90)),
              int(rng.integers(0, 30))) for _ in range(60)]
    cases += [(180, 2400, 0), (6480, 2400, 0), (180, 7, 0), (180, 180, 0),
              (180, 181, 0), (1, 1, 0), (3, 500, 11), (5, 1024, 0),
              (5, 1023, 0), (5, 1025, 0)]
    for out_len, w, extra in cases:
        y = rng.standard_normal((3, out_len + w - 1 + extra)).astype(
            np.float32)
        np.testing.assert_array_equal(
            agc.sliding_max_abs(t(y), w, out_len).numpy(),
            brute(y, w, out_len), err_msg=f"w={w} L={out_len}")


def test_seen_clamps_at_the_window():
    params = agc.make_agc_params(2000)
    w = params.window
    st = agc.init_agc_state(2, w)
    st = st._replace(seen=torch.tensor([0, w], dtype=torch.int32))
    x = torch.ones((2, 3 * w // 2), dtype=torch.float32)
    for _ in range(3):
        st, _ = agc.agc_process(st, x, params)
        assert int(st.seen.max()) <= w
    assert st.seen.tolist() == [w, w]


def test_float_to_int16_rounds_half_up_like_jax():
    lsb = 1.0 / 16384.0
    ties = np.float32([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 100.5]) * lsb
    x = np.concatenate([ties, np.float32([0.0, 1.9999, 2.0, -2.0, -2.5,
                                          1e9, -1e9])]).astype(np.float32)
    got = float_to_int16(t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf2i(jnp.asarray(x))))
    # half up, not half to even
    np.testing.assert_array_equal(got[:7], [1, 2, 3, 0, -1, -2, 101])
    assert got.dtype == np.int16 and got[-2] == 32767 and got[-1] == -32768


def test_agc_int16_plain_writes_the_packed_layout():
    """agc_int16 (plain on CPU) == agc_process + float_to_int16, written
    hop-major into [B, C, half]."""
    rng = np.random.default_rng(1)
    params = agc.make_agc_params(2000)
    b, c, half = 5, 3, 90
    x = (0.2 * rng.standard_normal((c, b * half))).astype(np.float32)
    st = agc.init_agc_state(c, params.window)._replace(
        seen=torch.full((c,), params.window, dtype=torch.int32),
        gain=torch.ones(c))
    want_st, want = agc.agc_process(st, t(x), params)
    out = torch.empty((b, c, half), dtype=torch.int16)
    got_st = agc_int16(st, t(x), params, out)
    want16 = float_to_int16(want).numpy().reshape(c, b, half).transpose(1, 0, 2)
    np.testing.assert_array_equal(out.numpy(), want16)
    for a_, b_ in zip(got_st, want_st):
        np.testing.assert_array_equal(a_.numpy(), b_.numpy())


def test_agc_chain_probe_needs_a_card():
    """The chain probe is a measuring aid with no plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        chain_probe(torch.zeros((2, 8)), torch.zeros(2),
                    agc.make_agc_params(2000))


@pytest.mark.parametrize("w", [20, 128, 129, 200, 256, 257, 400, 2400])
def test_agc_window_max_decomposition_is_exact(w):
    """csrc/agc.cu's window max: per aligned 128-sample block the prefix
    max P and suffix max Q of |y|, and a sparse table of block maxes;
    peak[t] = max(Q[t], P[t+W-1], two table entries over the whole
    blocks between) equals the sliding max exactly."""
    blk = 128
    rng = np.random.default_rng(w)
    length = 3 * w + 17
    y = np.abs(rng.standard_normal(w - 1 + length)).astype(np.float32)
    m = len(y)
    nb = -(-m // blk)
    blocks = np.zeros(nb * blk, np.float32)
    blocks[:m] = y
    blocks = blocks.reshape(nb, blk)
    pre = np.maximum.accumulate(blocks, axis=1).reshape(-1)
    suf = np.maximum.accumulate(blocks[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    levels = max((w + blk - 2) // blk - 1, 1).bit_length()
    table = [blocks.max(axis=1)]
    for k in range(1, levels):
        h = 1 << (k - 1)
        table.append(np.maximum(table[-1][:-h], table[-1][h:]))
    peaks = np.empty(length, np.float32)
    for t in range(length):
        last = t + w - 1
        b0, b1 = t // blk, last // blk
        if b0 == b1:
            peaks[t] = y[t:last + 1].max()
            continue
        pk = max(suf[t], pre[last])
        n = b1 - b0 - 1
        if n > 0:
            lv = n.bit_length() - 1
            assert lv < levels
            pk = max(pk, table[lv][b0 + 1], table[lv][b1 - (1 << lv)])
        peaks[t] = pk
    want = agc.sliding_max_abs(torch.from_numpy(y), w, length).numpy()
    np.testing.assert_array_equal(peaks, want)


def kernel_chunk_window_max(y: torch.Tensor, w: int, length: int,
                            t0: int) -> torch.Tensor:
    """csrc/agc.cu's window max as its worker warps form it, peak[t] for
    t in [t0, L): the max of |y| per 128-sample block and a sparse table
    over those; then, per ring chunk of 1024 outputs, the suffix maxes Q
    of the chunk's blocks (at most 8) and the prefix maxes P of the
    blocks its window ends fall in (at most 9), and peak[t] = max(Q[t],
    P[t+W-1], two table entries over the whole blocks between); a window
    inside one block is read directly.  The same index arithmetic, with
    the kernel's buffer sizes asserted."""
    blk, chunk = 128, 1024
    a = y.abs()
    m = w - 1 + length
    nb = -(-m // blk)
    blocks = torch.zeros(nb * blk, dtype=a.dtype)
    blocks[:m] = a
    blocks = blocks.view(nb, blk)
    levels = max((w + blk - 2) // blk - 1, 1).bit_length()
    table = [blocks.max(dim=1).values]
    for k in range(1, levels):
        h = 1 << (k - 1)
        table.append(torch.maximum(table[-1][:-h], table[-1][h:]))
    peaks = torch.empty(length - t0, dtype=a.dtype)
    for k in range(t0 // chunk, -(-length // chunk)):
        base = k * chunk
        s, e = max(t0, base), min(base + chunk, length)
        q0 = base // blk
        p0 = (s + w - 1) // blk
        nq = (e - 1) // blk - q0 + 1
        np_ = (e - 1 + w - 1) // blk - p0 + 1
        assert nq <= chunk // blk and np_ <= chunk // blk + 1
        qs = blocks[q0:q0 + nq].flip(1).cummax(1).values.flip(1).reshape(-1)
        ps = blocks[p0:p0 + np_].cummax(1).values.reshape(-1)
        t = torch.arange(s, e)
        last = t + w - 1
        b0, b1 = t // blk, last // blk
        pk = torch.maximum(qs[t - base], ps[last - p0 * blk])
        n = b1 - b0 - 1
        for lv in range(levels):
            sel = (n > 0) & (torch.floor(torch.log2(n.clamp(min=1).double()))
                             .long() == lv)
            if sel.any():
                row = table[lv]
                pk[sel] = torch.maximum(pk[sel], torch.maximum(
                    row[b0[sel] + 1], row[b1[sel] - (1 << lv)]))
        inside = b0 == b1
        assert not inside.any() or w <= blk
        for i in torch.nonzero(inside).flatten().tolist():
            pk[i] = a[t[i]:last[i] + 1].max()
        peaks[s - t0:e - t0] = pk
    return peaks


# W against the block (128) and the chunk (1024): below, at, W - 1 a
# multiple of either, one past; L below, at and past a chunk, and the
# production shapes (12 kHz and 192 kHz audio)
@pytest.mark.parametrize("w,length", [
    (20, 1500), (128, 700), (129, 1029), (400, 500), (1000, 3000),
    (1024, 3000), (1025, 2100), (2049, 2100), (2400, 6480), (2400, 1024),
    (38400, 700), (38400, 5000),
])
def test_agc_chunked_window_max_matches_jax(w, length):
    """The kernel's chunk decomposition of the window max equals JAX's
    _sliding_max_abs exactly, from where the warm-up of seen = 0, W - 2
    and W ends (t0 = W - 1, 1 and 0; only t >= t0 is read)."""
    rng = np.random.default_rng(w + length)
    y = rng.standard_normal(w - 1 + length).astype(np.float32)
    y[::53] *= 7.0
    want = np.asarray(jagc._sliding_max_abs(jnp.asarray(y[None]), w,
                                            length))[0]
    for seen in (0, w - 2, w):
        t0 = min(max(w - 1 - seen, 0), length)
        got = kernel_chunk_window_max(t(y), w, length, t0).numpy()
        np.testing.assert_array_equal(got, want[t0:],
                                      err_msg=f"W={w} L={length} seen={seen}")
