"""N-process cluster dryrun of the PyTorch port's multi-host runtime.

The counterpart of tools/multihost_dryrun.py for ``phantomsdr_tpu_torch``:

- ``multihost.bootstrap``: N processes, each with 2 CPU shards (``--device
  cpu``, over gloo; ``--cpu-shards`` sets another count) or with one card
  of its own (``--device cuda``: card
  i for process i, over NCCL), make one mesh of 2N (or N) shards whose
  halo ring and spectrum all-gather cross process boundaries,
- the ingest host (process 0) reads the sample stream and ships each
  follower ONLY its time-shard raw rows over a real TCP link, plus the
  replicated control block (channel table, views, due layout, frame
  counter),
- EVERY follower retunes one of its own slots concurrently, and all the
  retunes flow BACK over the links (table_update) into the global table
  for a later step -- with N > 2 over several links at once,
- each host runs the sharded step over its own shards and extracts the
  audio of ITS channel slots from its own output tensors,
- the concatenated per-host audio is compared against the port's
  single-device HopPipeline on the identical stream (on the same kind
  of device): within 1 int16 step on the CPU, the mesh's 4 on the
  card; the reference's last step must not be silent, and the
  replicated waterfall rows must be identical on every host and within
  the mesh's tolerance of the single device's.

Each process writes its audio, power and waterfall rows as .npy files to
--out, with its channel range, so a caller can hold them against another
reference.  Ports are free ephemeral ones unless given.

Run:  python tools/torch_multihost_dryrun.py --device cpu   (2 processes)
      python tools/torch_multihost_dryrun.py --device cpu --n-proc 3
                                                    (1 ingest + 2)
      python tools/torch_multihost_dryrun.py   (--device cuda: a card each)
      python tools/torch_multihost_dryrun.py --pid N ...  (one process)
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CPU_SHARDS = 2      # CPU shards per process (--device cpu), default
# the AGC's 200 ms look-ahead keeps the first ~4 steps (43 ms each)
# silent: run far enough past it that the audio compared is not
STEPS = 12
RETUNE_STEP = 6     # followers retune their slot before this step


def cfg_dict(nprocs: int, shards_per_proc: int) -> dict:
    """tools/multihost_dryrun.py's config: its 2-process shape (8 hops,
    4 channels) for 4 shards, scaled for other shard counts (at least
    8 hops a step)."""
    n = nprocs * shards_per_proc
    return {
        "input": {
            "sps": 192000, "frequency": 7000000, "fft_size": 2048,
            "signal": "iq", "audio_sps": 2000, "waterfall_size": 256,
            "driver": {"format": "s16"},
        },
        "tpu": {"hop_batch": 2 * n * -(-4 // n), "max_channels": n},
    }


def make_stream(cfg) -> np.ndarray:
    rng = np.random.default_rng(11)
    wph = cfg.hop_size * 2
    return rng.integers(-20000, 20000, size=wph * cfg.hop_batch * STEPS,
                        dtype=np.int16)


def base_table(cfg) -> list[np.ndarray]:
    c = cfg.max_channels
    l = np.linspace(10, cfg.fft_result_size - 200, c).astype(np.int32)
    return [l, l + 64, l + 32, np.arange(c, dtype=np.int32) % 4,
            np.ones(c, bool), np.zeros(c, bool),
            np.zeros(c, bool),
            np.zeros(c, bool)]  # active, nr, rds, am_env


def retuned_row(pid: int, shards_per_proc: int) -> dict:
    """Follower ``pid``'s retune of its first own slot (applied before
    RETUNE_STEP).  Each process owns shards_per_proc slots starting at
    pid * shards_per_proc (one channel a shard here), so the slots never
    collide -- the ingest host must merge ALL of them."""
    slot = pid * shards_per_proc
    return {"slot": slot, "l": 400 + 20 * pid, "r": 500 + 20 * pid,
            "m_idx": 450 + 20 * pid, "mode": (pid + 1) % 4}


def apply_retunes(table, nprocs: int, shards_per_proc: int) -> None:
    for fpid in range(1, nprocs):
        u = retuned_row(fpid, shards_per_proc)
        for col, key in enumerate(("l", "r", "m_idx", "mode")):
            table[col][u["slot"]] = u[key]


def views_for(cfg):
    from phantomsdr_tpu_torch.ops.quantize import pyramid_level_offsets

    offs = pyramid_level_offsets(cfg.fft_result_size, cfg.downsample_levels)
    start = np.asarray([offs[0] + 64, offs[1] + 16], np.int32)
    length = np.asarray([200, 100], np.int32)
    meta = (np.asarray([64, 16], np.int32), np.asarray([264, 116], np.int32),
            np.asarray([0, 1], np.int32))
    return start, length, meta


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_step(rt, state, my_rows, table, views, idx, due):
    tbl = rt.sp.channels_from_numpy(*table[:5], am_env=table[7],
                                    rds=table[6], nr=table[5])
    mode = "views" if due else "off"
    return rt.sp.step(state, rt.global_raw(my_rows), tbl, views, mode,
                      due_idx=idx)


def cluster_main(pid: int, outdir: str, nprocs: int, device: str,
                 cpu_shards: int, coord_port: int, link_port: int) -> None:
    import torch
    import torch.distributed

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.parallel.multihost import (
        MultihostRuntime, bootstrap, connect_link, pack_control,
        serve_links, unpack_control,
    )
    from phantomsdr_tpu_torch.pipeline import WaterfallViews, to_device

    cluster = bootstrap(f"127.0.0.1:{coord_port}", nprocs, pid,
                        device=device,
                        cpu_devices=cpu_shards if device == "cpu" else 0)
    spp = len(cluster.devices)
    cfg = config_from_dict(cfg_dict(nprocs, spp))
    rt = MultihostRuntime(cfg, cluster)
    views_start, views_length, wf_meta = views_for(cfg)
    views = WaterfallViews(
        start=to_device(views_start, torch.int32, rt.sp.device),
        length=to_device(views_length, torch.int32, rt.sp.device))
    state = rt.sp.init_state()
    audio_out, pwr_out, wf_out = [], [], []

    def keep(out, counts):
        audio_out.append(rt.local_audio(out))
        pwr_out.append(rt.local_power(out))
        wf = rt.local_wf(out)
        if wf is not None:      # this host's replica, in due order
            wf_out.append(wf[rt.sp.due_row_selector(counts)])

    if pid == 0:
        stream = make_stream(cfg)
        blk_w = cfg.hop_batch * cfg.hop_size * 2
        table = base_table(cfg)
        links = serve_links(link_port, nprocs - 1, host="127.0.0.1")
        for s in range(STEPS):
            # lockstep: wait for EVERY follower's previous step-done
            # ack, applying any table updates each pushed first (a
            # follower retune is sent BEFORE its step_done, so TCP
            # ordering makes the per-link merge deterministic; links
            # are drained one by one, exercising the N-link fan-in)
            if s > 0:
                for follower in links.values():
                    while True:
                        hdr, _ = follower.recv()
                        if hdr.get("type") == "table_update":
                            u = hdr["row"]
                            for col, key in enumerate(("l", "r", "m_idx",
                                                       "mode")):
                                table[col][u["slot"]] = u[key]
                        elif hdr.get("type") == "step_done":
                            assert hdr["seq"] == s - 1
                            break
            frame0 = s * cfg.hop_batch
            idx, counts = rt.sp.due_layout(frame0)
            due = [i * rt.sp.hops_per_shard + int(idx[i, j])
                   for i in range(rt.n) for j in range(counts[i])]
            rows = rt.all_rows(stream[s * blk_w:(s + 1) * blk_w])
            mids = table[2].astype(np.float64)  # metadata only
            meta, cblob = pack_control(table, mids,
                                       (views_start, views_length),
                                       wf_meta, None)
            for fpid, link in links.items():
                their = [i for i in range(rt.n) if i // spp == fpid]
                link.send({"seq": s, "frame0": frame0, "due": due,
                           "idx": idx.tolist(), "counts": counts,
                           "control": meta, "nrows": len(their)},
                          cblob + rows[their].tobytes())
            state, out = run_step(rt, state, rows[rt.local_shards], table,
                                  views, idx, due)
            keep(out, counts)
        # drain the FINAL step's acks before exiting: unread data in the
        # receive buffer would make process exit RST the links
        for follower in links.values():
            while True:
                hdr, _ = follower.recv()
                if (hdr.get("type") == "step_done"
                        and hdr["seq"] == STEPS - 1):
                    break
    else:
        link = connect_link(f"127.0.0.1:{link_port}", pid)
        for s in range(STEPS):
            hdr, blob = link.recv()
            assert hdr["seq"] == s
            rows_bytes = hdr["nrows"] * rt.sp.raw_shard_len * 2
            table_arrays, _mids, _views, _wfm, _reset = unpack_control(
                hdr["control"], blob[: len(blob) - rows_bytes])
            rows = np.frombuffer(blob[len(blob) - rows_bytes:],
                                 np.int16).reshape(hdr["nrows"],
                                                   rt.sp.raw_shard_len)
            idx = np.asarray(hdr["idx"], np.int32)
            state, out = run_step(rt, state, rows, list(table_arrays),
                                  views, idx, hdr["due"])
            keep(out, hdr["counts"])
            # a follower-side retune rides upstream BEFORE step_done so
            # the ingest host's next control block includes it; every
            # follower retunes concurrently in the same step
            if s + 1 == RETUNE_STEP:
                link.send({"type": "table_update",
                           "row": retuned_row(pid, spp)})
            link.send({"type": "step_done", "seq": s})

    torch.distributed.destroy_process_group()
    np.save(f"{outdir}/audio_pid{pid}.npy", np.stack(audio_out))
    np.save(f"{outdir}/power_pid{pid}.npy", np.stack(pwr_out))
    # every step's due rows, one after another
    np.save(f"{outdir}/wf_pid{pid}.npy", np.concatenate(wf_out))
    with open(f"{outdir}/range_pid{pid}.json", "w") as f:
        json.dump({"offset": rt.chan_offset, "count": rt.chan_count,
                   "shards_per_proc": spp, "backend": cluster.backend}, f)
    print(f"pid {pid} done: chans [{rt.chan_offset},"
          f"{rt.chan_offset + rt.chan_count}) over {cluster.backend}",
          flush=True)


def single_device_reference(cfg, nprocs: int, shards_per_proc: int,
                            device: str):
    """The port's single-device HopPipeline on the identical stream, with
    the followers' retunes applied from RETUNE_STEP: (audio [S, B, C,
    half], every step's due waterfall rows one after another)."""
    import torch

    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, WaterfallViews, channels_from_numpy, to_device,
        waterfall_due_positions,
    )

    stream = make_stream(cfg)
    table = base_table(cfg)
    views_start, views_length, _ = views_for(cfg)
    pipe = HopPipeline(cfg, device=device)
    views = WaterfallViews(start=to_device(views_start, torch.int32, device),
                           length=to_device(views_length, torch.int32,
                                            device))
    wph = cfg.hop_size * 2
    blk_w = cfg.hop_batch * wph
    halo = np.zeros(wph, np.int16)
    st = pipe.init_state()
    audio, wf = [], []
    for s in range(STEPS):
        if s == RETUNE_STEP:
            apply_retunes(table, nprocs, shards_per_proc)
        blk = stream[s * blk_w:(s + 1) * blk_w]
        frame0 = s * cfg.hop_batch
        due = waterfall_due_positions(cfg, frame0)
        st, o = pipe.step(st, to_device(np.concatenate([halo, blk]), None,
                                        device),
                          channels_from_numpy(*table[:5], device=device),
                          views, "views" if due else "off",
                          due_idx=pipe.default_due_idx(frame0))
        halo = blk[-wph:]
        audio.append(o.audio.cpu().numpy())
        if due:
            wf.append(o.wf.cpu().numpy()[:len(due)])
    return np.stack(audio), np.concatenate(wf)


def orchestrate(outdir: str, nprocs: int, device: str, cpu_shards: int,
                timeout: float) -> None:
    """Spawn the N-process cluster, then check against single-device:
    int16 audio within 1 on the CPU (the same operations), within the
    mesh's 4 on the card."""
    tol = 1 if device == "cpu" else 4
    coord, link = free_port(), free_port()
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ)
        if device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--pid", str(pid), "--out", outdir,
             "--n-proc", str(nprocs), "--device", device,
             "--cpu-shards", str(cpu_shards),
             "--coordinator-port", str(coord), "--link-port", str(link)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fail = False
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            fail = True
        sys.stdout.write(out.decode())
        if p.returncode != 0:
            fail = True
    if fail:
        print("TORCH_MULTIHOST_DRYRUN_FAIL: cluster process error")
        sys.exit(1)

    from phantomsdr_tpu_torch.config import config_from_dict

    info = [json.load(open(f"{outdir}/range_pid{pid}.json"))
            for pid in range(nprocs)]
    spp = info[0]["shards_per_proc"]
    cfg = config_from_dict(cfg_dict(nprocs, spp))
    ref, ref_wf = single_device_reference(cfg, nprocs, spp, device)

    # ---- compare each host's channel range ----
    loud = int(np.abs(ref[-1]).max())
    print(f"single device: last step's audio peaks at {loud}")
    max_err = 0
    for pid, rng_info in enumerate(info):
        got = np.load(f"{outdir}/audio_pid{pid}.npy")  # [S, B, C_loc, half]
        o, c = rng_info["offset"], rng_info["count"]
        err = int(np.abs(got.astype(int)
                         - ref[:, :, o:o + c].astype(int)).max())
        max_err = max(max_err, err)
        print(f"pid {pid}: channels [{o},{o + c}) max |err| = {err} "
              f"({rng_info['backend']})")
    # every host must hold identical replicated waterfall rows, within
    # the mesh's tolerance of the single device's (at most one int8
    # step on < 0.1% of the bytes)
    wf0 = np.load(f"{outdir}/wf_pid0.npy")
    wf_equal = all(
        (w := np.load(f"{outdir}/wf_pid{pid}.npy")).shape == wf0.shape
        and np.array_equal(w, wf0) for pid in range(1, nprocs))
    d = np.abs(wf0.astype(int) - ref_wf.astype(int))
    wf_close = wf0.shape == ref_wf.shape and d.max() <= 1 \
        and (d > 0).mean() < 1e-3
    print(f"waterfall replicas equal: {wf_equal} (shape {wf0.shape}); "
          f"against the single device max |diff| = {d.max()}, share "
          f"{(d > 0).mean()}")
    if max_err <= tol and wf_equal and wf_close and loud >= 1000:
        print("TORCH_MULTIHOST_DRYRUN_OK")
    else:
        print("TORCH_MULTIHOST_DRYRUN_FAIL")
        sys.exit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--out", default="build/multihost/dryrun")
    ap.add_argument("--n-proc", type=int, default=2,
                    help="cluster processes (1 ingest + n-1 followers)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--cpu-shards", type=int, default=CPU_SHARDS,
                    help="CPU shards per process with --device cpu")
    ap.add_argument("--timeout", type=float, default=300,
                    help="seconds the cluster may take before it is killed")
    ap.add_argument("--coordinator-port", type=int, default=0)
    ap.add_argument("--link-port", type=int, default=0)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if args.pid is None:
        orchestrate(args.out, args.n_proc, args.device, args.cpu_shards,
                    args.timeout)
    else:
        cluster_main(args.pid, args.out, args.n_proc, args.device,
                     args.cpu_shards, args.coordinator_port, args.link_port)


if __name__ == "__main__":
    main()
