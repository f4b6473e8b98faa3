"""The port's entry points (``phantomsdr_tpu_torch.entry``) against the
JAX package's ``__graft_entry__``, on CPU.

``entry(device="cpu")``'s step against ``__graft_entry__.entry()``'s
step (jitted, on JAX's CPU backend): the example arguments as given
(a block of zeros), then the same seeded int16 blocks from a mid-stream
JAX state carried into the port by ``interop``.  Tolerances are
tests/test_torch_pipeline.py's: int16 audio within 4 LSB, channel power
rtol 2e-4, the waterfall at most one int8 step on < 0.1% of bins.

``dryrun_multichip(n, device="cpu")`` for n = 2 and 4 against the
port's single-device HopPipeline on the same block and table, at
tests/test_torch_sharded.py's mesh tolerances (audio within 1, power
rtol 1e-5, the pyramid at most one step on < 0.1% of bins).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from phantomsdr_tpu.ops.quantize import pyramid_level_offsets

from phantomsdr_tpu_torch import interop
from phantomsdr_tpu_torch.entry import dryrun_multichip, entry, small_cfg
from phantomsdr_tpu_torch.pipeline import (
    HopPipeline, WaterfallViews, channels_from_numpy,
)

WARM_STEPS = 5          # past the 200 ms AGC look-ahead at 12 kHz


def blocks(cfg, count, seed=11):
    """Consecutive halo'd s16 IQ blocks: two tones and noise."""
    wph = cfg.hop_size * 2
    blk = cfg.hop_batch * wph
    rng = np.random.default_rng(seed)
    halo = np.zeros(wph, np.int16)
    out = []
    for s in range(count):
        n = np.arange(s * blk, (s + 1) * blk)
        x = (rng.integers(-3000, 3000, blk)
             + 8000 * np.sin(2 * np.pi * 0.13 * n)
             + 5000 * np.sin(2 * np.pi * 0.3711 * n)).astype(np.int16)
        out.append(np.concatenate([halo, x]))
        halo = x[-wph:]
    return out


def close_int8(t, j):
    assert t.shape == j.shape
    d = np.abs(t.astype(int) - j.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def compare(jo, to):
    ja = np.asarray(jo.audio).astype(int)
    ta = to.audio.numpy().astype(int)
    assert ta.shape == ja.shape
    assert np.abs(ta - ja).max() <= 4
    np.testing.assert_allclose(to.avg_power.numpy(), np.asarray(jo.avg_power),
                               rtol=2e-4, atol=1e-12)
    close_int8(to.wf.numpy(), np.asarray(jo.wf))
    return np.abs(ja).max()


def test_entry_matches_graft_entry():
    jfn, jargs = graft.entry()
    tfn, targs = entry(device="cpu")
    jfn = jax.jit(jfn)
    assert all(t.device.type == "cpu" for t in targs[1:]
               if isinstance(t, torch.Tensor))
    assert targs[1].shape == jargs[1].shape and targs[1].dtype == torch.int16

    # the example arguments as given: a block of zeros
    js, jo = jfn(*jargs)
    ts, to = tfn(*targs)
    compare(jo, to)
    assert ts.frame == int(js.frame)

    # a waterfall view of level 0 and of level 1, so the rows carry data
    cfg = small_cfg()
    offs = pyramid_level_offsets(cfg.fft_result_size, cfg.downsample_levels)
    start = np.array([offs[0] + 100, offs[1] + 5], np.int32)
    length = np.array([cfg.waterfall_size, 300], np.int32)
    jviews = type(jargs[3])(start=jnp.asarray(start),
                            length=jnp.asarray(length))
    tviews = WaterfallViews(start=torch.from_numpy(start),
                            length=torch.from_numpy(length))

    # JAX alone to mid-stream, its carries into the port, then both
    _, _, jtable, _, jreset, jdue = jargs
    _, _, ttable, _, treset, tdue = targs
    stream = blocks(cfg, WARM_STEPS + 3)
    js = jargs[0]
    for raw in stream[:WARM_STEPS]:
        js, _ = jfn(js, jnp.asarray(raw), jtable, jviews, jreset, jdue)
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js))
    peak = 0
    for raw in stream[WARM_STEPS:]:
        js, jo = jfn(js, jnp.asarray(raw), jtable, jviews, jreset, jdue)
        ts, to = tfn(ts, torch.from_numpy(raw), ttable, tviews, treset, tdue)
        assert ts.frame == int(js.frame)
        assert np.abs(np.asarray(jo.wf)).max() > 0
        peak = max(peak, compare(jo, to))
    assert peak > 1000                     # past the AGC warm-up


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_single_device(n):
    d = dryrun_multichip(n, device="cpu")
    cfg = d.cfg
    full, views = d.outputs
    assert len(full.audio) == n
    pipe = HopPipeline(cfg, device="cpu")
    table = channels_from_numpy(**d.table)
    wph = pipe.wire_per_hop
    st = pipe.init_state()
    halo = np.zeros(wph, np.int16)
    for mesh_out in (full, views):
        raw = torch.from_numpy(np.concatenate([halo, d.raw]))
        halo = d.raw[-wph:]
        st, o = pipe.step(st, raw, table, waterfall="full")
        a = torch.cat(mesh_out.audio, dim=1).numpy().astype(int)
        assert np.abs(o.audio.numpy().astype(int) - a).max() <= 1
        np.testing.assert_allclose(
            torch.cat(mesh_out.avg_power, dim=1).numpy(),
            o.avg_power.numpy(), rtol=1e-5, atol=1e-8)
        if mesh_out is full:
            close_int8(torch.cat(full.pyramid).numpy(), o.pyramid.numpy())


def test_entry_points_default_to_the_card():
    """Without a card, the defaults refuse instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        dryrun_multichip(2)
