"""PyTorch port vs the JAX package: the whole hop step (``HopPipeline``)
over consecutive steps, in every waterfall mode, with resets, channel
bucketing, the parity seed and a mid-stream state carried over from
JAX (``interop``), on CPU.  Sizes are ``__graft_entry__._small_cfg``'s
(FFT 4096, 16 channels, hop_batch 4, IQ s16) plus one real-input case.

Tolerances: int16 audio within 4 LSB (tests/test_pipeline.py), channel
power rtol 2e-4, waterfall at most one int8 step on < 0.1% of bins.

The WBFM broadcast path (stereo + RDS + de-emphasis 75 us + Opus
decimation) at 1.536 MSPS, FFT 32768, 192 kHz audio, 4 channels: the
decimated interleaved int16 within 4 LSB, the RDS int8 baseband within
one step on < 0.1% of samples (tests/test_torch_rds.py), with resets and
resizes of the per-stream rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.config import config_from_dict as jconfig
from phantomsdr_tpu.pipeline import (
    HopPipeline as JPipeline, WaterfallViews as JViews,
    channels_from_numpy as jtable,
)
from phantomsdr_tpu.ops.quantize import pyramid_level_offsets

from phantomsdr_tpu_torch import interop
from phantomsdr_tpu_torch.config import config_from_dict
from phantomsdr_tpu_torch.pipeline import (
    HopPipeline, WaterfallViews, channels_from_numpy, unpack_outputs,
)

WARM_STEPS = 5          # past the 200 ms AGC look-ahead at 12 kHz


def cfg_dict(signal="iq"):
    return {
        "input": {"sps": 192000, "frequency": 7000000, "fft_size": 4096,
                  "signal": signal, "audio_sps": 12000,
                  "waterfall_size": 512, "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 4, "max_channels": 16},
    }


def table_arrays(cfg, k=None):
    c = cfg.max_channels
    rsize = cfg.fft_result_size
    l = np.linspace(10, rsize - 300, c).astype(np.int32)
    am_env = np.zeros(c, bool)
    am_env[6] = True                      # one AM listener on envelope
    active = np.ones(c, bool)
    active[-1] = False
    arrays = dict(l=l, r=l + 100, m_idx=l + 50, mode=np.arange(c) % 4,
                  active=active, am_env=am_env)
    if k is not None:
        arrays = {key: v[:k] for key, v in arrays.items()}
    return arrays


def view_arrays(cfg):
    offs = pyramid_level_offsets(cfg.fft_result_size, cfg.downsample_levels)
    start = np.array([offs[0] + 100, offs[1] + 5,
                      offs[cfg.downsample_levels - 1], offs[0]], np.int32)
    length = np.array([512, 300, cfg.waterfall_size, 0], np.int32)
    return start, length


class Stream:
    """Continuous s16 capture (two tones + noise), cut into halo'd
    blocks like runtime.driver.SampleSource."""

    def __init__(self, cfg, seed=42):
        self.wph = cfg.hop_size * (1 if cfg.is_real else 2)
        self.blk = cfg.hop_batch * self.wph
        self.rng = np.random.default_rng(seed)
        self.halo = np.zeros(self.wph, np.int16)
        self.pos = 0

    def next(self):
        n = np.arange(self.pos, self.pos + self.blk)
        self.pos += self.blk
        x = (self.rng.integers(-3000, 3000, self.blk)
             + 8000 * np.sin(2 * np.pi * 0.13 * n)
             + 5000 * np.sin(2 * np.pi * 0.3711 * n)).astype(np.int16)
        block = np.concatenate([self.halo, x])
        self.halo = x[-self.wph:]
        return block


class Pair:
    """The JAX and the PyTorch pipeline on one config, fed the same
    blocks."""

    def __init__(self, signal="iq"):
        self.jc = jconfig(cfg_dict(signal))
        self.tc = config_from_dict(cfg_dict(signal))
        self.jp = JPipeline(self.jc)
        self.tp = HopPipeline(self.tc, device="cpu")
        start, length = view_arrays(self.jc)
        self.jviews = JViews(start=jnp.asarray(start),
                             length=jnp.asarray(length))
        self.tviews = WaterfallViews(start=torch.from_numpy(start),
                                     length=torch.from_numpy(length))

    def tables(self, k=None):
        arrays = table_arrays(self.jc, k)
        return jtable(**arrays), channels_from_numpy(**arrays)

    def warm_jax(self, steps=WARM_STEPS):
        """JAX state after `steps` steps of a fresh stream."""
        stream = Stream(self.jc)
        jt, _ = self.tables()
        js = self.jp.init_state()
        for _ in range(steps):
            js, _ = self.jp.step(js, jnp.asarray(stream.next()), jt,
                                 self.jviews, "views")
        return js, stream


@pytest.fixture(scope="module")
def iq():
    return Pair("iq")


def compare(jo, to, mode):
    ja = np.asarray(jo.audio).astype(int)
    ta = to.audio.numpy().astype(int)
    assert ta.shape == ja.shape
    assert np.abs(ta - ja).max() <= 4
    np.testing.assert_allclose(to.avg_power.numpy(), np.asarray(jo.avg_power),
                               rtol=2e-4, atol=1e-12)
    if mode == "views":
        jw, tw = np.asarray(jo.wf).astype(int), to.wf.numpy().astype(int)
    elif mode == "full":
        jw, tw = np.asarray(jo.pyramid).astype(int), to.pyramid.numpy().astype(int)
    else:
        assert to.wf.shape[0] == 0 and to.pyramid.shape[1] == 0
        return np.abs(ja).max()
    assert tw.shape == jw.shape
    d = np.abs(tw - jw)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    return np.abs(ja).max()


def run_pair(pair, js, ts, stream, mode, steps=3, jt=None, tt=None,
             resets=None):
    if jt is None:
        jt, tt = pair.tables()
    peak = 0
    for s in range(steps):
        raw = stream.next()
        jr = tr = None
        if resets is not None and s == 0:
            jr, tr = jnp.asarray(resets), torch.from_numpy(resets)
        frame0 = int(js.frame)
        due = pair.jp.default_due_idx(frame0)
        js, jo = pair.jp.step(js, jnp.asarray(raw), jt, pair.jviews, mode,
                              reset=jr, due_idx=due)
        ts, to = pair.tp.step(ts, torch.from_numpy(raw), tt, pair.tviews,
                              mode, reset=tr,
                              due_idx=torch.from_numpy(np.array(due)))
        assert ts.frame == int(js.frame)
        peak = max(peak, compare(jo, to, mode))
    return js, ts, peak


@pytest.mark.parametrize("mode", ["views", "full", "off"])
def test_steps_match_jax_from_carried_state(iq, mode):
    """Three consecutive steps in each waterfall mode, starting from a
    mid-stream JAX state carried over with interop.state_from_numpy."""
    js, stream = iq.warm_jax()
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js))
    js, ts, peak = run_pair(iq, js, ts, stream, mode)
    assert peak > 1000                     # past the AGC warm-up: real audio
    got = interop.state_to_numpy(ts)
    for part in ("chan", "dc", "agc"):
        for name in getattr(got.audio, part)._fields:
            want = np.asarray(getattr(getattr(js.audio, part), name))
            np.testing.assert_allclose(
                getattr(getattr(got.audio, part), name), want,
                rtol=1e-3, atol=1e-4, err_msg=f"{part}.{name}")


def test_cold_start_matches_jax(iq):
    stream = Stream(iq.jc, seed=3)
    js, ts = iq.jp.init_state(), iq.tp.init_state()
    _, _, peak = run_pair(iq, js, ts, stream, "views", steps=WARM_STEPS + 2)
    assert peak > 100                      # the AGC has opened


def test_reset_mask_matches_jax(iq):
    js, stream = iq.warm_jax()
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js))
    resets = np.zeros(iq.jc.max_channels, np.int32)
    resets[1] = 1                          # RESET_FULL
    resets[2] = 2                          # RESET_AGC
    js, ts, _ = run_pair(iq, js, ts, stream, "off", resets=resets)
    assert int(ts.audio.agc.seen[1]) == int(np.asarray(js.audio.agc.seen)[1])
    assert int(ts.audio.agc.seen[1]) < int(ts.audio.agc.seen[0])


def test_resize_channel_rows_matches_jax(iq):
    """Shrink to an 8-row bucket for a step, then grow back to 16."""
    js, stream = iq.warm_jax()
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js))
    for k in (8, 16):
        js = iq.jp.resize_channel_rows(js, k)
        ts = iq.tp.resize_channel_rows(ts, k)
        assert ts.audio.chan.ssb_prev.shape[0] == k
        jt, tt = iq.tables(k)
        js, ts, _ = run_pair(iq, js, ts, stream, "views", steps=2, jt=jt,
                             tt=tt)


def test_init_state_seeds_parity_like_jax(iq):
    """A rebuild mid-stream seeds only the parity of frame0; an odd seed
    flips the (-1)^(m*hop) fix-up the same way in both packages."""
    assert iq.tp.init_state(7).frame == 1
    assert iq.tp.init_state(8).frame == 0
    stream = Stream(iq.jc, seed=9)
    js, ts = iq.jp.init_state(7), iq.tp.init_state(7)
    _, _, peak = run_pair(iq, js, ts, stream, "off", steps=WARM_STEPS + 2)
    assert peak > 100


def test_real_input_matches_jax():
    pair = Pair("real")
    js, stream = pair.warm_jax()
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js))
    _, _, peak = run_pair(pair, js, ts, stream, "views", steps=2)
    assert peak > 0


def test_packed_buffer_round_trips_through_unpack(iq):
    js, stream = iq.warm_jax(1)
    _, tt = iq.tables()
    ts = iq.tp.init_state()
    ts, out = iq.tp.step(ts, torch.from_numpy(stream.next()), tt, iq.tviews,
                         "views")
    cfg = iq.tc
    audio, pwr, wf, rds = unpack_outputs(
        out.packed.numpy(), cfg.hop_batch, cfg.max_channels,
        cfg.audio_fft_size // 2, iq.tp.due_cap, iq.tviews.start.shape[0],
        iq.tp.view_cap)
    assert rds is None and out.rds.shape == (cfg.max_channels, 2, 0)
    np.testing.assert_array_equal(audio, out.audio.numpy())
    np.testing.assert_array_equal(pwr, out.avg_power.numpy())
    np.testing.assert_array_equal(wf, out.wf.numpy())
    assert out.packed.numel() == audio.nbytes + pwr.nbytes + wf.nbytes


def test_interop_round_trip(iq):
    js, _ = iq.warm_jax(2)
    jnp_state = jax.tree.map(np.asarray, js)
    back = interop.state_to_numpy(interop.state_from_numpy(jnp_state))
    assert back.frame == jnp_state.frame
    for part in ("chan", "dc", "agc"):
        for name in getattr(back.audio, part)._fields:
            np.testing.assert_array_equal(
                getattr(getattr(back.audio, part), name),
                getattr(getattr(jnp_state.audio, part), name))
    jt, _ = iq.tables()
    table = interop.state_from_numpy(jax.tree.map(np.asarray, jt))
    assert table.need_pll
    np.testing.assert_array_equal(table.am_env.numpy(), np.asarray(jt.am_env))
    views = interop.state_from_numpy(jax.tree.map(np.asarray, iq.jviews))
    np.testing.assert_array_equal(views.start.numpy(),
                                  np.asarray(iq.jviews.start))
    with pytest.raises(TypeError):
        interop.state_from_numpy((1, 2))


# ------------------------------------------------------- WBFM broadcast

def wbfm_dict():
    return {
        "input": {"sps": 1_536_000, "frequency": 98_000_000,
                  "fft_size": 32768, "signal": "iq", "audio_sps": 192000,
                  "waterfall_size": 512, "stereo": True, "rds": True,
                  "deemphasis": 75, "audio_compression": "opus",
                  "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 4, "max_channels": 4},
    }


class WbfmStream:
    """s16 IQ: tests/test_rds.py's MPX (stereo tones, pilot, RDS)
    FM-modulated at 75 kHz deviation on the centre of the band (8x
    staircase upsample), plus noise, cut into halo'd blocks."""

    def __init__(self, cfg, blocks):
        from tests.test_rds import _mpx

        wph = cfg.hop_size * 2
        blk = cfg.hop_batch * wph
        n = (blocks * blk + wph) // 2
        up = cfg.sps // cfg.audio_sps
        mpx = np.repeat(_mpx(n // up + 1, fs=cfg.audio_sps), up)[:n]
        ph = 2 * np.pi * np.cumsum(75000.0 * mpx) / cfg.sps
        rng = np.random.default_rng(11)
        iq = 0.5 * np.exp(1j * ph) + 0.01 * rng.standard_normal(n)
        s = np.empty(2 * n, np.int16)
        s[0::2] = np.round(iq.real * 32000)
        s[1::2] = np.round(iq.imag * 32000)
        self.blocks = [s[k * blk:(k + 1) * blk + wph] for k in range(blocks)]


class WbfmPair:
    def __init__(self):
        self.jc = jconfig(wbfm_dict())
        self.tc = config_from_dict(wbfm_dict())
        self.jp = JPipeline(self.jc)
        self.tp = HopPipeline(self.tc, device="cpu")
        self.stream = WbfmStream(self.jc, 4)

    def tables(self, k=4):
        mid = self.jc.fft_result_size // 2
        half = self.jc.audio_fft_size // 2
        arrays = dict(l=np.full(4, mid - half // 2, np.int32),
                      r=np.full(4, mid + half // 2, np.int32),
                      m_idx=np.full(4, mid, np.int32),
                      mode=np.array([3, 3, 0, 3], np.int32),
                      active=np.array([True, True, True, False]),
                      rds=np.array([True, False, False, True]))
        arrays = {key: v[:k] for key, v in arrays.items()}
        return jtable(**arrays), channels_from_numpy(**arrays)

    def warm_states(self):
        """JAX's fresh state with the AGC past its look-ahead (seen =
        window, unit gain, and a look-ahead tail of discriminator output
        of the MPX, which the next 38,399 samples of output come from),
        and the same state in the port."""
        from tests.test_rds import _mpx

        js = self.jp.init_state()
        agc = js.audio.agc
        w = self.jp.agc_params.window
        fm = 2 * np.pi * 75000.0 / self.jc.audio_sps * _mpx(
            w - 1, fs=self.jc.audio_sps)
        js = js._replace(audio=js.audio._replace(agc=agc._replace(
            tail=jnp.broadcast_to(jnp.asarray(fm, jnp.float32),
                                  agc.tail.shape),
            seen=jnp.full_like(agc.seen, w),
            gain=jnp.ones_like(agc.gain))))
        return js, interop.state_from_numpy(jax.tree.map(np.asarray, js))

    def step(self, js, ts, raw, k=4, reset=None):
        jt, tt = self.tables(k)
        jr = tr = None
        if reset is not None:
            jr, tr = jnp.asarray(reset), torch.from_numpy(reset)
        js, jo = self.jp.step(js, jnp.asarray(raw), jt, waterfall="off",
                              reset=jr)
        ts, to = self.tp.step(ts, torch.from_numpy(raw), tt,
                              waterfall="off", reset=tr)
        ja, ta = np.asarray(jo.audio).astype(int), to.audio.numpy().astype(int)
        assert ta.shape == ja.shape == (k, 2 * self.jc.hop_batch
                                        * self.jc.audio_fft_size // 2 // 4)
        assert np.abs(ta - ja).max() <= 4
        jq, tq = np.asarray(jo.rds).astype(int), to.rds.numpy().astype(int)
        assert tq.shape == jq.shape == (k, 2, self.tp.rds_t)
        d = np.abs(tq - jq)
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
        np.testing.assert_allclose(to.avg_power.numpy(),
                                   np.asarray(jo.avg_power), rtol=2e-4,
                                   atol=1e-12)
        return js, ts, to


@pytest.fixture(scope="module")
def wbfm():
    return WbfmPair()


def test_wbfm_steps_match_jax(wbfm):
    """Three steps of the whole WBFM path from a warm AGC; the shared
    pilot's stereo carries mirror the RDS ones."""
    js, ts = wbfm.warm_states()
    for raw in wbfm.stream.blocks[:3]:
        js, ts, out = wbfm.step(js, ts, raw)
    audio = out.audio.numpy()
    assert np.abs(audio[0]).max() > 1000          # real audio
    assert out.rds[0].any() and not out.rds[1:].any()
    a = ts.audio
    assert torch.equal(a.st.phase, a.rds.phase)
    assert torch.equal(a.st.freq, a.rds.freq)
    assert torch.equal(a.st.bp_tail, a.rds.bp_tail)
    got = interop.state_to_numpy(ts).audio
    for part in ("dec", "st", "rds"):
        for name in getattr(got, part)._fields:
            np.testing.assert_allclose(
                getattr(getattr(got, part), name),
                np.asarray(getattr(getattr(js.audio, part), name)),
                rtol=1e-3, atol=1e-3, err_msg=f"{part}.{name}")
    np.testing.assert_allclose(got.de, np.asarray(js.audio.de), rtol=1e-3,
                               atol=1e-3)


def test_wbfm_reset_and_resize_match_jax(wbfm):
    """A full reset of channel 1 zeroes its per-stream decimator and
    de-emphasis rows (2 and 3); a shrink to 2 channels and a grow back
    to 4 keep 2k of those rows, as in JAX."""
    js, ts = wbfm.warm_states()
    js, ts, _ = wbfm.step(js, ts, wbfm.stream.blocks[0])
    reset = np.array([0, 1, 0, 0], np.int32)
    js, ts, _ = wbfm.step(js, ts, wbfm.stream.blocks[1], reset=reset)
    for k, raw in ((2, wbfm.stream.blocks[2]), (4, wbfm.stream.blocks[3])):
        js = wbfm.jp.resize_channel_rows(js, k)
        ts = wbfm.tp.resize_channel_rows(ts, k)
        assert ts.audio.dec.tail.shape[0] == ts.audio.de.shape[0] == 2 * k
        assert ts.audio.st.phase.shape[0] == k
        js, ts, _ = wbfm.step(js, ts, raw, k=k)


def test_wbfm_interop_round_trip(wbfm):
    js, _ = wbfm.warm_states()
    jt, _ = wbfm.tables()
    js, _ = wbfm.jp.step(js, jnp.asarray(wbfm.stream.blocks[0]), jt,
                         waterfall="off")
    state = jax.tree.map(np.asarray, js)
    back = interop.state_to_numpy(interop.state_from_numpy(state)).audio
    for part in ("dec", "st", "rds"):
        for name in getattr(back, part)._fields:
            np.testing.assert_array_equal(
                getattr(getattr(back, part), name),
                getattr(getattr(state.audio, part), name))
    np.testing.assert_array_equal(back.de, state.audio.de)
    table = interop.state_from_numpy(jax.tree.map(np.asarray, jt))
    assert table.need_rds and not table.need_pll
    np.testing.assert_array_equal(table.rds.numpy(), np.asarray(jt.rds))


# ------------------------------------------------------ noise reduction

NR_ALGOS = ("spectral", "lms", "notch", "nb")


class NrPair:
    """The small config with [input] nr = true and ``algo``: the JAX and
    the PyTorch pipeline, half the rows opted in (every other row)."""

    def __init__(self, algo):
        d = cfg_dict()
        d["input"] = {**d["input"], "nr": True, "nr_algo": algo}
        self.jc, self.tc = jconfig(d), config_from_dict(d)
        self.jp = JPipeline(self.jc)
        self.tp = HopPipeline(self.tc, device="cpu")

    def tables(self, k=None):
        arrays = table_arrays(self.jc)
        arrays["nr"] = np.arange(self.jc.max_channels) % 2 == 0
        if k is not None:
            arrays = {key: v[:k] for key, v in arrays.items()}
        return jtable(**arrays), channels_from_numpy(**arrays)

    def warm(self, steps=WARM_STEPS):
        """JAX state after `steps` steps, and the same state in the port
        (interop), with the stream to go on with."""
        stream = Stream(self.jc, seed=21)
        jt, _ = self.tables()
        js = self.jp.init_state()
        for _ in range(steps):
            js, _ = self.jp.step(js, jnp.asarray(stream.next()), jt,
                                 waterfall="off")
        return js, interop.state_from_numpy(jax.tree.map(np.asarray, js)), \
            stream

    def steps(self, js, ts, stream, n, k=None, reset=None):
        jt, tt = self.tables(k)
        for s in range(n):
            raw = stream.next()
            jr = tr = None
            if reset is not None and s == 0:
                jr, tr = jnp.asarray(reset), torch.from_numpy(reset)
            js, jo = self.jp.step(js, jnp.asarray(raw), jt, waterfall="off",
                                  reset=jr)
            ts, to = self.tp.step(ts, torch.from_numpy(raw), tt,
                                  waterfall="off", reset=tr)
            ja = np.asarray(jo.audio).astype(int)
            ta = to.audio.numpy().astype(int)
            assert ta.shape == ja.shape
            assert np.abs(ta - ja).max() <= 1
        return js, ts, ja


@pytest.fixture(scope="module", params=NR_ALGOS)
def nr_pair(request):
    return NrPair(request.param)


def test_nr_steps_match_jax(nr_pair):
    """Three steps of the whole step with the configured noise
    processor from a warm JAX state carried over; the processor's carries
    come back as JAX has them, and opted-in rows differ from the rest."""
    js, ts, stream = nr_pair.warm()
    js, ts, audio = nr_pair.steps(js, ts, stream, 3)
    assert np.abs(audio).max() > 1000
    got = interop.state_to_numpy(ts).audio.nr
    want = js.audio.nr
    assert type(got).__name__ == type(want).__name__
    for name in got._fields:
        w = np.asarray(getattr(want, name))
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(getattr(got, name), w, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


def test_nr_reset_and_resize_match_jax():
    """Spectral NR (the largest carries): a full reset of rows 0 and 3
    re-arms them, then a shrink to 8 rows and a grow back to 16."""
    pair = NrPair("spectral")
    js, ts, stream = pair.warm(3)
    reset = np.zeros(pair.jc.max_channels, np.int32)
    reset[[0, 3]] = 1
    js, ts, _ = pair.steps(js, ts, stream, 1, reset=reset)
    assert int(ts.audio.nr.stage[0]) == 4 and int(ts.audio.nr.stage[1]) > 4
    for k in (8, 16):
        js = pair.jp.resize_channel_rows(js, k)
        ts = pair.tp.resize_channel_rows(ts, k)
        assert ts.audio.nr.xt.shape[0] == k
        js, ts, _ = pair.steps(js, ts, stream, 1, k=k)


def test_nr_interop_round_trip_and_table():
    pair = NrPair("nb")
    js = jax.tree.map(np.asarray, pair.jp.init_state())
    back = interop.state_to_numpy(interop.state_from_numpy(js)).audio.nr
    np.testing.assert_array_equal(back.tail, js.audio.nr.tail)
    jt, _ = pair.tables()
    table = interop.state_from_numpy(jax.tree.map(np.asarray, jt))
    assert table.need_nr
    np.testing.assert_array_equal(table.nr.numpy(), np.asarray(jt.nr))
    assert not channels_from_numpy(
        **{**table_arrays(pair.jc), "nr": np.zeros(16, bool)}).need_nr


@pytest.mark.parametrize("extra", [
    {"nr": True},
    {"nr": True, "nr_algo": "LMS"},
    {"nr": True, "nr_algo": "notch", "nr_two_mu": 1e-3},
    {"nr": True, "nr_algo": "bogus"},
    {"nr": False, "nr_algo": "bogus"},
    {"nr": True, "stereo": True, "audio_sps": 192000},
    {"nr": True, "nr_algo": "nb", "nb_samples": 2},
    {"nr": True, "nr_algo": "nb", "nb_samples": 201},
    {"nr": True, "nr_algo": "nb", "nb_samples": 202},
    {"nr": True, "nr_algo": "nb", "nb_taps": 0},
    {"nr": True, "nr_algo": "nb", "nb_taps": 40},
    {"nr": True, "nr_algo": "nb", "nb_taps": 41},
    {"nr": False, "nr_algo": "nb", "nb_taps": 41},
])
def test_nr_config_decisions_match_jax(extra):
    """Both packages accept and refuse the same noise-reduction settings,
    with the same message."""
    d = cfg_dict()
    d["input"] = {**d["input"], **extra}
    outcome = []
    for make in (jconfig, config_from_dict):
        try:
            cfg = make(d)
            outcome.append(("ok", cfg.nr, cfg.nr_algo))
        except ValueError as e:
            outcome.append(("refused", str(e)))
    assert outcome[0] == outcome[1]
