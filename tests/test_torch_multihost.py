"""The port's multi-host runtime (``phantomsdr_tpu_torch.parallel.
multihost``) against the JAX package's: the wire codecs byte for byte,
the link's accept loop against rogue peers, the cluster CLI's flags,
and 2- and 3-process gloo clusters of 2 CPU shards each
(tools/torch_multihost_dryrun.py) against the JAX package's
single-device HopPipeline on the same stream, with every follower's
retune flowing upstream into the global table.

Tolerances: each host's int16 audio within 1 of JAX's (the JAX
package's own dryrun holds its cluster to 1 against its single device),
its channel power rtol 2e-4 (tests/test_torch_pipeline.py's), and the
waterfall rows replicated identically on every host and equal to
JAX's."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from phantomsdr_tpu.parallel import multihost as jmh
from phantomsdr_tpu_torch.parallel import multihost as tmh

REPO = Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "torch_multihost_dryrun.py"
sys.path.insert(0, str(REPO / "tools"))

import torch_multihost_dryrun as dryrun  # noqa: E402


def control_arrays(seed, c=8, w=5):
    rng = np.random.default_rng(seed)
    tbl = (rng.integers(0, 1000, c).astype(np.int32),
           rng.integers(0, 1000, c).astype(np.int32),
           rng.integers(0, 1000, c).astype(np.int32),
           rng.integers(0, 4, c).astype(np.int32),
           *(rng.integers(0, 2, c).astype(bool) for _ in range(4)))
    mid = rng.standard_normal(c)
    views = (rng.integers(0, 99, w).astype(np.int32),
             rng.integers(0, 99, w).astype(np.int32))
    wfm = tuple(rng.integers(0, 99, w).astype(np.int32) for _ in range(3))
    return tbl, mid, views, wfm, rng.integers(0, 3, c).astype(np.int32)


def host_update_arrays(seed, c=4, w=3):
    rng = np.random.default_rng(seed)
    ctbl = (rng.integers(0, 99, c).astype(np.int32),
            rng.integers(0, 99, c).astype(np.int32),
            rng.integers(0, 99, c).astype(np.int32),
            rng.integers(0, 4, c).astype(np.int32),
            rng.integers(0, 2, c).astype(bool),
            rng.standard_normal(c),
            *(rng.integers(0, 2, c).astype(bool) for _ in range(3)))
    wrows = tuple(rng.integers(0, 99, w).astype(np.int32) for _ in range(5))
    return ctbl, rng.integers(0, 3, c).astype(np.int32), wrows


def assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, (tuple, list)):
            assert_same(x, y)
        elif x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("with_reset", [False, True])
def test_control_codec_matches_jax(with_reset):
    """The port's control block is the JAX package's byte for byte, and
    each side decodes the other's (every table column, views, wf meta,
    the optional reset mask)."""
    tbl, mid, views, wfm, reset = control_arrays(0)
    reset = reset if with_reset else None
    hdr, blob = tmh.pack_control(tbl, mid, views, wfm, reset)
    jhdr, jblob = jmh.pack_control(tbl, mid, views, wfm, reset)
    assert (hdr, blob) == (jhdr, jblob)
    want = (tbl, mid, views, wfm, reset)
    assert_same(tmh.unpack_control(jhdr, jblob), want)
    assert_same(jmh.unpack_control(hdr, blob), want)


@pytest.mark.parametrize("with_reset", [False, True])
def test_host_update_codec_matches_jax(with_reset):
    """The follower->ingest registry sync, byte for byte and both ways:
    the 9 channel-range arrays, the reset mask, the 5 view arrays."""
    ctbl, resets, wrows = host_update_arrays(1)
    resets = resets if with_reset else None
    got = tmh.pack_host_update(2, 4, ctbl, resets, 1, 3, wrows)
    assert got == jmh.pack_host_update(2, 4, ctbl, resets, 1, 3, wrows)
    tbl2, resets2, wrows2 = tmh.unpack_host_update(*got)
    assert_same((tbl2, resets2, wrows2), (ctbl, resets, wrows))
    assert tmh._events_tbl(ctbl, ctbl[5]) == jmh._events_tbl(ctbl, ctbl[5])


def test_serve_links_survives_rogue_peers():
    """A peer that connects without a valid hello must neither wedge the
    accept loop nor take a follower's place; an out-of-range pid must
    not replace a live link (tests/test_multihost.py's check, on a free
    port)."""
    port = dryrun.free_port()
    result = {}

    def serve():
        result["links"] = tmh.serve_links(port, 1, host="127.0.0.1")

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    deadline = time.monotonic() + 10
    while True:
        try:
            rogue = socket.create_connection(("127.0.0.1", port), timeout=5)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    rogue.sendall(b"\x00" * 16)
    bad = tmh.connect_link(f"127.0.0.1:{port}", pid=7)
    good = tmh.connect_link(f"127.0.0.1:{port}", pid=1)
    th.join(timeout=30)
    assert not th.is_alive(), "serve_links wedged on a rogue peer"
    assert set(result["links"]) == {1}
    good.send({"type": "step_done", "seq": 3}, b"xyz")
    assert result["links"][1].recv() == ({"type": "step_done", "seq": 3},
                                         b"xyz")
    for ln in (rogue, bad, good, *result["links"].values()):
        ln.close()


def test_cli_has_every_flag_of_the_jax_cli():
    """Every option of ``python -m phantomsdr_tpu`` but --platform (the
    JAX backend pin; the port has --device) exists in the port's CLI."""
    def flags(module):
        out = subprocess.run([sys.executable, "-m", module, "--help"],
                             capture_output=True, text=True, cwd=REPO,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        return {w.rstrip(",") for w in out.stdout.split()
                if w.startswith("--")}

    want = flags("phantomsdr_tpu") - {"--platform"}
    got = flags("phantomsdr_tpu_torch")
    assert {"--coordinator", "--num-processes", "--process-id",
            "--link-port", "--link-addr", "--cpu-devices"} <= want
    assert want <= got, want - got


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal")
def test_bootstrap_on_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmh.bootstrap("127.0.0.1:1", 2, 0, device="cuda")


def jax_reference(nprocs: int, spp: int, retune: bool = True):
    """The JAX package's single-device HopPipeline on the dryrun's
    stream, the followers' retunes applied from RETUNE_STEP: (audio [S,
    B, C, half], power [S, B, C], every step's due waterfall rows)."""
    import jax.numpy as jnp

    from phantomsdr_tpu.config import config_from_dict
    from phantomsdr_tpu.pipeline import (
        HopPipeline, WaterfallViews, channels_from_numpy,
        waterfall_due_positions,
    )

    cfg = config_from_dict(dryrun.cfg_dict(nprocs, spp))
    stream = dryrun.make_stream(cfg)
    table = dryrun.base_table(cfg)
    start, length, _ = dryrun.views_for(cfg)
    views = WaterfallViews(start=jnp.asarray(start),
                           length=jnp.asarray(length))
    pipe = HopPipeline(cfg)
    wph = cfg.hop_size * 2
    blk_w = cfg.hop_batch * wph
    halo = np.zeros(wph, np.int16)
    st = pipe.init_state()
    audio, power, wf = [], [], []
    for s in range(dryrun.STEPS):
        if s == dryrun.RETUNE_STEP and retune:
            dryrun.apply_retunes(table, nprocs, spp)
        blk = stream[s * blk_w:(s + 1) * blk_w]
        frame0 = s * cfg.hop_batch
        due = waterfall_due_positions(cfg, frame0)
        st, o = pipe.step(st, jnp.asarray(np.concatenate([halo, blk])),
                          channels_from_numpy(*table[:5]), views,
                          "views" if due else "off",
                          due_idx=pipe.default_due_idx(frame0))
        halo = blk[-wph:]
        audio.append(np.asarray(o.audio))
        power.append(np.asarray(o.avg_power))
        if due:
            wf.append(np.asarray(o.wf)[:len(due)])
    return np.stack(audio), np.stack(power), np.concatenate(wf)


@pytest.mark.parametrize("nprocs,spp", [(2, 2), (3, 2), (2, 1)])
def test_gloo_cluster_matches_jax_single_device(tmp_path, nprocs, spp):
    """N processes x ``spp`` CPU shards over gloo (2 x 1 is the topology
    of two processes sharing one card), rows over the TCP links, every
    follower retuning its first slot before RETUNE_STEP: the tool's own
    check against the port's single device passes, and each host's
    channel range matches the JAX package's single device."""
    res = subprocess.run(
        [sys.executable, str(TOOL), "--device", "cpu", "--out",
         str(tmp_path), "--n-proc", str(nprocs), "--cpu-shards", str(spp)],
        capture_output=True,
        text=True, timeout=240, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "TORCH_MULTIHOST_DRYRUN_OK" in res.stdout, res.stdout
    assert res.stdout.count("over gloo") == nprocs, res.stdout

    ref_audio, ref_power, ref_wf = jax_reference(nprocs, spp)
    # the retunes move the followers' slots' audio, so matching the
    # retuned reference means each retune reached the global table
    still, _, _ = jax_reference(nprocs, spp, retune=False)
    for fpid in range(1, nprocs):
        slot = dryrun.retuned_row(fpid, spp)["slot"]
        late = slice(dryrun.RETUNE_STEP, None)
        assert np.abs(still[late, :, slot].astype(int)
                      - ref_audio[late, :, slot].astype(int)).max() > 100
    wf0 = None
    for pid in range(nprocs):
        info = json.loads((tmp_path / f"range_pid{pid}.json").read_text())
        o, c = info["offset"], info["count"]
        assert (o, c) == (pid * spp, spp)
        audio = np.load(tmp_path / f"audio_pid{pid}.npy")
        err = np.abs(audio.astype(int)
                     - ref_audio[:, :, o:o + c].astype(int)).max()
        assert err <= 1, (pid, err)
        np.testing.assert_allclose(np.load(tmp_path / f"power_pid{pid}.npy"),
                                   ref_power[:, :, o:o + c], rtol=2e-4,
                                   atol=1e-12)
        wf = np.load(tmp_path / f"wf_pid{pid}.npy")
        if wf0 is None:
            wf0 = wf
        np.testing.assert_array_equal(wf, wf0)
    np.testing.assert_array_equal(wf0, ref_wf)


class OneProcess:
    """The cross-process collectives of a cluster of one process: the
    ring hands the tail back, the gather returns the part."""

    rank, size, backend, staged = 0, 1, "gloo", False

    def ring(self, tail):
        return tail.clone()

    def all_gather(self, part):
        return part


def test_runtime_reads_its_shards_wbfm_outputs():
    """A runtime over a one-process cluster of 2 CPU shards steps the
    WBFM path (stereo, RDS, de-emphasis, Opus decimation) through the
    cluster branches of ShardedHopPipeline, and its local_audio,
    local_power and local_rds equal the single-process mesh's packed
    outputs on the same blocks."""
    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.parallel import (
        ShardedHopPipeline, make_mesh, unpack_outputs_sharded,
    )
    from tests.test_torch_pipeline import WbfmStream, wbfm_dict

    cfg = config_from_dict(wbfm_dict())
    cluster = tmh.Cluster([torch.device("cpu")] * 2, [2], "gloo",
                          OneProcess())
    rt = tmh.MultihostRuntime(cfg, cluster)
    assert (rt.n, rt.local_shards, rt.chan_offset, rt.chan_count) == (
        2, [0, 1], 0, 4)
    mesh = ShardedHopPipeline(cfg, make_mesh(2, "cpu"))
    mid, half = cfg.fft_result_size // 2, cfg.audio_fft_size // 2
    cols = (np.full(4, mid - half // 2), np.full(4, mid + half // 2),
            np.full(4, mid), np.array([3, 3, 0, 3]),
            np.array([True, True, True, False]))
    rds = np.array([True, False, False, True])
    wph = rt.sp.wire_per_hop
    blocks = WbfmStream(cfg, 7).blocks     # past the AGC look-ahead
    s1 = rt.sp.init_state()._replace(halo=torch.from_numpy(blocks[0][:wph]))
    s2 = mesh.init_state()._replace(halo=torch.from_numpy(blocks[0][:wph]))
    for raw in blocks:
        rows = raw[wph:]
        s1, o1 = rt.sp.step(s1, rt.global_raw(rt.all_rows(rows)),
                            rt.sp.channels_from_numpy(*cols, rds=rds),
                            waterfall="off")
        s2, o2 = mesh.step(s2, mesh.shard_raw(rows),
                           mesh.channels_from_numpy(*cols, rds=rds),
                           waterfall="off")
        audio, pwr, _, rds8 = unpack_outputs_sharded(
            torch.cat(o2.packed).numpy(), 2, cfg.hop_batch, 4, half, 1,
            mesh.view_cap, 0, decim=mesh.decim, nch=cfg.audio_channels,
            rds_t=mesh.rds_t)
        np.testing.assert_array_equal(rt.local_audio(o1), audio)
        np.testing.assert_array_equal(rt.local_power(o1), pwr)
        np.testing.assert_array_equal(rt.local_rds(o1), rds8)
        assert rt.local_wf(o1) is None
    assert np.abs(audio).max() > 100 and rds8[0].any()   # not silent
