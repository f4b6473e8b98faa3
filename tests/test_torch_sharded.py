"""The PyTorch port's mesh (``parallel.sharded``) on 8 CPU shards
against the JAX package's ShardedHopPipeline on the 8 virtual CPU
devices of tests/conftest.py: the same seeded stream and the same
mid-stream carries (``interop.sharded_state_from_numpy``), two chained
steps in every waterfall mode and with ``gather_wf``; an opt-in stage
that only some shards run; the host helpers (due_layout,
due_row_selector, unpack_outputs_sharded).  Then the port's mesh against
the port's single-device HopPipeline.

Sizes are __graft_entry__._small_cfg's (FFT 4096 at 192 kS/s, 12 kHz
audio, IQ s16, 16 channels) at 8 hops a step, one hop per shard.
Tolerances against JAX are tests/test_torch_pipeline.py's: int16 audio
within 4 LSB, channel power rtol 2e-4, waterfall at most one int8 step
on < 0.1% of bins.  Mesh against single device: tests/test_sharded.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.config import config_from_dict as jconfig
from phantomsdr_tpu.ops.quantize import pyramid_level_offsets
from phantomsdr_tpu.parallel import sharded as jsharded
from phantomsdr_tpu.pipeline import (
    WaterfallViews as JViews, channels_from_numpy as jtable,
)

from phantomsdr_tpu_torch import interop
from phantomsdr_tpu_torch.config import config_from_dict
from phantomsdr_tpu_torch.parallel import (
    ShardedHopPipeline, make_mesh, unpack_outputs_sharded,
)
from phantomsdr_tpu_torch.parallel.collectives import all_gather, ring_permute
from phantomsdr_tpu_torch.pipeline import (
    HopPipeline, WaterfallViews, channels_from_numpy,
)

N = 8
WARM_STEPS = 4          # past the 200 ms AGC look-ahead at 12 kHz


def cfg_dict(**extra):
    return {
        "input": {"sps": 192000, "frequency": 7000000, "fft_size": 4096,
                  "signal": "iq", "audio_sps": 12000, "waterfall_size": 512,
                  "driver": {"format": "s16"}, **extra},
        "tpu": {"hop_batch": N, "max_channels": 2 * N},
    }


def table_arrays(cfg, nr_rows=()):
    c = cfg.max_channels
    l = np.linspace(10, cfg.fft_result_size - 300, c).astype(np.int32)
    am_env = np.zeros(c, bool)
    am_env[6] = True                      # one AM listener on envelope
    active = np.ones(c, bool)
    active[-1] = False
    nr = np.zeros(c, bool)
    nr[list(nr_rows)] = True
    return dict(l=l, r=l + 100, m_idx=l + 50, mode=np.arange(c) % 4,
                active=active, am_env=am_env, nr=nr)


def view_arrays(cfg):
    offs = pyramid_level_offsets(cfg.fft_result_size, cfg.downsample_levels)
    start = np.array([offs[0] + 100, offs[1] + 5,
                      offs[cfg.downsample_levels - 1], offs[0]], np.int32)
    length = np.array([512, 300, cfg.waterfall_size, 0], np.int32)
    return start, length


def stream_blocks(cfg, count, seed=42):
    """Consecutive s16 blocks of B hops (no halo: the mesh passes it
    between shards): two tones + noise."""
    wph = cfg.hop_size * 2
    blk = cfg.hop_batch * wph
    rng = np.random.default_rng(seed)
    out = []
    for s in range(count):
        n = np.arange(s * blk, (s + 1) * blk)
        out.append((rng.integers(-3000, 3000, blk)
                    + 8000 * np.sin(2 * np.pi * 0.13 * n)
                    + 5000 * np.sin(2 * np.pi * 0.3711 * n)
                    ).astype(np.int16))
    return out


class MeshPair:
    """The JAX mesh on 8 virtual devices and the port's on 8 CPU
    shards, one config, fed the same blocks."""

    def __init__(self, gather_wf=False, nr_rows=(), **extra):
        self.jc = jconfig(cfg_dict(**extra))
        self.tc = config_from_dict(cfg_dict(**extra))
        assert len(jax.devices()) == N
        self.jp = jsharded.ShardedHopPipeline(
            self.jc, jsharded.make_mesh(N), gather_wf=gather_wf)
        self.tp = ShardedHopPipeline(self.tc, make_mesh(N, "cpu"),
                                     gather_wf=gather_wf)
        arrays = table_arrays(self.jc, nr_rows)
        self.jt = jtable(**arrays)
        self.tt = self.tp.channels_from_numpy(**arrays)
        start, length = view_arrays(self.jc)
        self.jviews = JViews(start=jnp.asarray(start),
                             length=jnp.asarray(length))
        self.tviews = WaterfallViews(start=torch.from_numpy(start),
                                     length=torch.from_numpy(length))
        self.blocks = stream_blocks(self.jc, WARM_STEPS + 2)

    def warm_jax(self):
        js = self.jp.init_state()
        for blk in self.blocks[:WARM_STEPS]:
            js, _ = self.jp.step(js, jnp.asarray(self.jp.shard_raw(blk)),
                                 self.jt, self.jviews, "views")
        return js

    def run(self, js, ts, mode, frame0):
        """Two chained steps from (js, ts); yields both outputs."""
        for blk in self.blocks[WARM_STEPS:]:
            idx, _ = self.jp.due_layout(frame0)
            js, jo = self.jp.step(js, jnp.asarray(self.jp.shard_raw(blk)),
                                  self.jt, self.jviews, mode,
                                  due_idx=jnp.asarray(idx))
            ts, to = self.tp.step(ts, self.tp.shard_raw(blk), self.tt,
                                  self.tviews, mode, due_idx=idx)
            frame0 += self.jc.hop_batch
            yield js, jo, ts, to


@pytest.fixture(scope="module")
def pair():
    return MeshPair()


def host_packed(out) -> np.ndarray:
    return torch.cat(out.packed).numpy()


def unpack(pipe, packed, rows):
    cfg = pipe.cfg
    return unpack_outputs_sharded(
        packed, pipe.n, cfg.hop_batch, cfg.max_channels,
        cfg.audio_fft_size // 2, 4, pipe.view_cap, rows,
        nch=cfg.audio_channels, rds_t=pipe.rds_t)


def close_int8(t, j):
    assert t.shape == j.shape
    d = np.abs(t.astype(int) - j.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def compare(pair, jo, to, mode):
    rows = pair.tp.due_cap_local if mode == "views" else 0
    ja, jp, jw, _ = unpack(pair.jp, np.asarray(jo.packed), rows)
    ta, tp, tw, _ = unpack(pair.tp, host_packed(to), rows)
    assert np.abs(ta.astype(int) - ja.astype(int)).max() <= 4
    np.testing.assert_allclose(tp, jp, rtol=2e-4, atol=1e-12)
    if mode == "views":
        close_int8(tw, jw)
    elif mode == "full":
        close_int8(torch.cat(to.pyramid).numpy(), np.asarray(jo.pyramid))
    return np.abs(ja).max()


@pytest.mark.parametrize("mode", ["views", "full", "off"])
def test_mesh_matches_jax_from_carried_state(pair, mode):
    """Two chained steps in each waterfall mode from a mid-stream JAX
    mesh state carried over with interop; the carries (halo included)
    come back in the JAX layout."""
    js = pair.warm_jax()
    jnp_state = jax.tree.map(np.asarray, js)
    ts = interop.sharded_state_from_numpy(jnp_state, pair.tp)
    back = interop.sharded_state_to_numpy(ts)
    np.testing.assert_array_equal(back.halo[0], jnp_state.halo[0])
    np.testing.assert_array_equal(back.inner.audio.agc.gain,
                                  jnp_state.inner.audio.agc.gain)
    frame0 = WARM_STEPS * pair.jc.hop_batch
    peak = 0
    for js, jo, ts, to in pair.run(js, ts, mode, frame0):
        assert ts.frame == int(js.inner.frame)
        peak = max(peak, compare(pair, jo, to, mode))
    assert peak > 1000                     # past the AGC warm-up
    got = interop.sharded_state_to_numpy(ts)
    np.testing.assert_array_equal(got.halo[0], np.asarray(js.halo)[0])
    for part in ("chan", "dc", "agc"):
        for name in getattr(got.inner.audio, part)._fields:
            want = np.asarray(getattr(getattr(js.inner.audio, part), name))
            np.testing.assert_allclose(
                getattr(getattr(got.inner.audio, part), name), want,
                rtol=1e-3, atol=1e-4, err_msg=f"{part}.{name}")


def test_mesh_gather_wf_matches_jax():
    """gather_wf: every shard holds all shards' due rows and the packed
    buffers are empty, as in the JAX mesh."""
    p = MeshPair(gather_wf=True)
    js = p.jp.init_state()
    ts = p.tp.init_state()
    for js, jo, ts, to in p.run(js, ts, "views", 0):
        jw = np.asarray(jo.wf)
        assert jw.shape[0] == N * p.tp.due_cap_local
        for w in to.wf:
            close_int8(w.numpy(), jw)
        assert all(b.numel() == 0 for b in to.packed)
        assert np.asarray(jo.packed).size == 0
        np.testing.assert_allclose(torch.cat(to.avg_power, 1).numpy(),
                                   np.asarray(jo.avg_power), rtol=2e-4,
                                   atol=1e-12)


def test_mesh_opt_in_stage_matches_jax():
    """LMS noise reduction opted in on shard 0's rows only: the other
    shards skip the stage (their carries go stale, as under the JAX
    mesh's per-shard lax.cond) and every shard's audio and carries
    match JAX."""
    p = MeshPair(nr_rows=(0, 1), nr=True, nr_algo="lms")
    assert [t.need_nr for t in p.tt] == [True] + [False] * (N - 1)
    js = p.warm_jax()
    ts = interop.sharded_state_from_numpy(jax.tree.map(np.asarray, js),
                                          p.tp)
    frame0 = WARM_STEPS * p.jc.hop_batch
    peak = 0
    for js, jo, ts, to in p.run(js, ts, "off", frame0):
        peak = max(peak, compare(p, jo, to, "off"))
    assert peak > 1000                     # past the AGC warm-up
    got = interop.sharded_state_to_numpy(ts).inner.audio.nr
    for name in got._fields:
        np.testing.assert_allclose(
            getattr(got, name), np.asarray(getattr(js.inner.audio.nr, name)),
            rtol=1e-3, atol=1e-3, err_msg=f"nr.{name}")


@pytest.mark.parametrize("frame0", [0, 5, 13, 17, 100])
def test_due_layout_and_selector_match_jax(pair, frame0):
    """At skip_num 3 (fft 4096 / sps 192k) several hops of a step are
    due, over several shards."""
    jidx, jcounts = pair.jp.due_layout(frame0)
    tidx, tcounts = pair.tp.due_layout(frame0)
    np.testing.assert_array_equal(tidx, jidx)
    assert tcounts == jcounts and sum(tcounts) > 0
    assert (pair.tp.due_row_selector(tcounts)
            == pair.jp.due_row_selector(jcounts))


@pytest.mark.parametrize("decim,nch,rds_t,rows", [
    (1, 1, 0, 1), (1, 2, 0, 2), (4, 2, 0, 1), (3, 1, 16, 0)])
def test_unpack_outputs_sharded_matches_jax(decim, nch, rds_t, rows):
    n, b, c, half, w, cap = 4, 8, 8, 12, 3, 7
    cl = c // n
    la = nch * b * half // decim
    na = cl * la * 2 if decim > 1 else b * cl * nch * half * 2
    seg = na + b * cl * 4 + rows * w * cap + cl * 2 * rds_t
    packed = np.random.default_rng(rows + rds_t).integers(
        0, 256, n * seg, dtype=np.uint8)
    args = (packed, n, b, c, half, w, cap, rows)
    kw = dict(decim=decim, nch=nch, rds_t=rds_t)
    for t, j in zip(unpack_outputs_sharded(*args, **kw),
                    jsharded.unpack_outputs_sharded(*args, **kw)):
        if j is None:
            assert t is None
        else:
            np.testing.assert_array_equal(t.view(np.uint8), j.view(np.uint8))


def test_mesh_matches_single_device():
    """Cold start, two steps in 'full' mode then one with the mesh in
    'views' mode gathering every hop (one a shard): the port's mesh
    against the port's single device, at tests/test_sharded.py's
    tolerances."""
    cfg = config_from_dict(cfg_dict())
    sp = ShardedHopPipeline(cfg, make_mesh(N, "cpu"))
    pipe = HopPipeline(cfg, device="cpu")
    arrays = table_arrays(cfg)
    t1, t8 = channels_from_numpy(**arrays), sp.channels_from_numpy(**arrays)
    start, length = view_arrays(cfg)
    views = WaterfallViews(start=torch.from_numpy(start),
                           length=torch.from_numpy(length))
    wph = pipe.wire_per_hop
    st1, st8 = pipe.init_state(), sp.init_state()
    halo = np.zeros(wph, np.int16)
    for s, blk in enumerate(stream_blocks(cfg, 3, seed=3)):
        mode = "full" if s < 2 else "views"
        raw = torch.from_numpy(np.concatenate([halo, blk]))
        halo = blk[-wph:]
        st1, o1 = pipe.step(st1, raw, t1, views, "full")
        st8, o8 = sp.step(st8, sp.shard_raw(blk), t8, views, mode,
                          due_idx=np.zeros((N, 1), np.int32))
        a8, p8, w8, _ = unpack_outputs_sharded(
            host_packed(o8), N, cfg.hop_batch, cfg.max_channels,
            cfg.audio_fft_size // 2, 4, sp.view_cap,
            1 if mode == "views" else 0)
        assert np.abs(o1.audio.numpy().astype(int) - a8.astype(int)).max() <= 1
        peak = np.abs(a8).max()
        np.testing.assert_allclose(o1.avg_power.numpy(), p8, rtol=1e-5,
                                   atol=1e-8)
        p1 = o1.pyramid.numpy().astype(int)
        if mode == "full":
            pm = torch.cat(o8.pyramid).numpy().astype(int)
        else:
            # one hop per shard: row i of the mesh's views is hop i
            pm = p1.copy()
            for v, (s0, n) in enumerate(zip(start, length)):
                pm[:, s0:s0 + n] = w8[:, v, :n]
        assert np.abs(p1 - pm).max() <= 1 and (p1 != pm).mean() < 1e-3
    assert st8.frame == st1.frame
    assert peak > 100                      # the AGC has opened


def test_collectives_on_cpu_shards():
    devs = make_mesh(3, "cpu")
    parts = [torch.full((2,), float(i)) for i in range(3)]
    assert [int(t[0]) for t in ring_permute(parts)] == [2, 0, 1]
    gathered = all_gather(parts, devs)
    assert gathered[0] is gathered[2]      # formed once per device
    assert gathered[1].tolist() == [0, 0, 1, 1, 2, 2]


def test_make_mesh_and_divisibility():
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="2 devices given for a mesh of 4"):
        make_mesh(4, devices=["cpu", "cpu"])
    if torch.cuda.device_count() < 64:
        with pytest.raises(RuntimeError, match="needs 64 CUDA devices"):
            make_mesh(64, "cuda")
    cfg = config_from_dict(cfg_dict())
    with pytest.raises(ValueError, match="hop_batch must divide"):
        ShardedHopPipeline(cfg, make_mesh(3, "cpu"))
