"""Multi-host runtime: raw-row distribution over TCP, replicated-table
sync, and the per-host serving partition.

The port of ``phantomsdr_tpu/parallel/multihost.py``; the host half
(the link, the codecs, the driver's loops) is its copy, and the device
half runs the mesh over ``torch.distributed``:

- **Bootstrap**: one process per host, ``bootstrap`` (called from
  main.py's --coordinator/--process-id flags) joins a
  ``torch.distributed`` group at ``tcp://<coordinator>``.  The mesh is
  every process's local devices (its visible cards, or ``--cpu-devices``
  CPU shards), process-index-major; each process steps only its own
  shards (``ShardedHopPipeline(group=...)``), and the overlap
  halo and the spectrum all-gather cross processes over the group
  (``collectives.CrossProcess``): NCCL where no card is shared between
  processes, gloo -- through pinned host buffers for CUDA tensors --
  where one is, or on the CPU.

- **Raw feeding over TCP**: the SDR byte stream lands on ONE ingest
  host (process 0).  Each step it slices the hop batch into
  per-time-shard rows and ships every remote host ONLY the rows of its
  shards over a plain length-prefixed TCP link.  At 35 MSPS u8 IQ that
  is 70 MB/s total; rows are disjoint because the overlap halo moves
  over the group, never the link.

- **Replicated control state**: every process must issue the same
  sequence of collectives with the same shapes.  The ingest host owns
  the merged channel/view tables and piggybacks them (plus reset masks,
  due layout, frame counter) on each step's row message; the step only
  runs on a follower once it has that step's control block.

- **Per-host serving partition**: audio comes back channel-sharded with
  channel slot ranges aligned to hosts (slot s lives on shard
  s // (C/n)), so host h serves listeners in its slot range from its
  own shards (``local_audio``); follower registries allocate from their
  own range and push row updates back to the ingest host over the same
  link (``host_update``), which merges them into the global table.
  Waterfall rows are all-gathered (``ShardedHopPipeline(gather_wf=
  True)``) so every host serves waterfall clients from its replica.

Validated by tools/torch_multihost_dryrun.py: N CPU processes of 2
shards each over gloo produce the single-device pipeline's audio, with
the rows truly crossing the TCP link.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import struct
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import ServerConfig
from .collectives import CrossProcess

DEFAULT_LINK_PORT = 28700
# how long a collective may wait for its peers before it raises (a
# dead peer's closed connection ends it at once; this bounds a wedged
# one)
COLLECTIVE_TIMEOUT_S = 60.0


class Cluster(NamedTuple):
    """What ``bootstrap`` set up for this process (its rank and the
    process count are ``collectives.rank`` / ``.size``)."""

    devices: list             # this process's shards' devices
    shard_counts: list        # every process's local shard count
    backend: str              # the collectives' backend: nccl or gloo
    collectives: CrossProcess


def bootstrap(coordinator: str, num_processes: int, process_id: int,
              device="cuda", cpu_devices: int = 0) -> Cluster:
    """Join the cluster (one call per process, before any other CUDA
    work).  ``device="cuda"`` takes this process's visible cards as its
    shards (CUDA_VISIBLE_DEVICES picks them) and raises without one;
    ``"cpu"`` takes ``cpu_devices`` CPU shards (default 1).

    The group is formed over gloo at ``tcp://<coordinator>``; each rank
    then shares its shard count and its cards' UUIDs.  Where no card is
    shared between ranks, the collectives run on an NCCL group, whose
    init is forced here so that a failure raises now (never a switch to
    gloo); where ranks share a card (NCCL refuses two ranks on one GPU)
    they run on gloo, staged through pinned host memory.  The choice is
    printed on one line."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bootstrap: device cuda, but no CUDA device "
                               "is visible; pass device='cpu' (--device "
                               "cpu) to run the plain PyTorch versions")
        if cpu_devices:
            raise ValueError("bootstrap: cpu_devices applies to device "
                             "'cpu' only")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        torch.cuda.set_device(devices[0])
        uuids = [str(torch.cuda.get_device_properties(d).uuid)
                 for d in devices]
    elif dev.type == "cpu":
        devices, uuids = [dev] * (cpu_devices or 1), []
    else:
        raise ValueError(f"bootstrap: unsupported device {device}")
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    info: list = [None] * num_processes
    dist.all_gather_object(info, (len(devices), uuids))
    counts = [c for c, _ in info]
    every = [u for _, us in info for u in us]
    group, backend, staged = None, "gloo", False
    if dev.type == "cuda":
        if len(set(every)) < len(every):
            staged = True
        else:
            backend = "nccl"
            group = dist.new_group(list(range(num_processes)),
                                   backend="nccl", timeout=timeout)
            probe = torch.ones(1, device=devices[0])
            dist.all_reduce(probe, group=group)
            torch.cuda.synchronize(devices[0])
    why = {"nccl": "no card shared between processes",
           "gloo": ("processes share a card: CUDA tensors staged through "
                    "pinned host memory") if staged else "CPU shards"}
    print(f"multihost: process {process_id}/{num_processes}, backend "
          f"{backend} ({why[backend]}), shards {counts} on "
          f"{', '.join(map(str, devices))}", flush=True)
    return Cluster(devices, counts, backend,
                   CrossProcess(group, process_id, num_processes, backend,
                                staged))


# ---------------------------------------------------------------- link

class Link:
    """Length-prefixed TCP message link: one JSON header + one binary
    blob per message.  Blocking, ordered, one peer."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()

    def send(self, header: dict, blob: bytes = b"") -> None:
        h = json.dumps(header).encode()
        with self._wlock:
            self.sock.sendall(struct.pack("<II", len(h), len(blob)))
            self.sock.sendall(h)
            if blob:
                self.sock.sendall(blob)

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except socket.timeout:
                if buf:
                    # timing out MID-message would desync the framing;
                    # the peer is stalled, not idle
                    raise ConnectionError("partial read timed out")
                raise
            if not chunk:
                raise ConnectionError("link closed")
            buf.extend(chunk)
        return bytes(buf)

    def recv(self) -> tuple[dict, bytes]:
        hl, bl = struct.unpack("<II", self._read_exact(8))
        header = json.loads(self._read_exact(hl))
        blob = self._read_exact(bl) if bl else b""
        return header, blob

    def close(self):
        # shutdown BEFORE close: socket.close() only marks the fd when
        # another thread is blocked in recv() on it (CPython io_refs
        # defer the real close), so no FIN would ever reach the peer --
        # a surviving follower would then block in recv() forever after
        # _fail_cluster "closed every link".  shutdown() sends FIN
        # immediately and also unblocks local blocked recvs.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def serve_links(port: int, num_followers: int, host: str = "0.0.0.0",
                stop=None) -> dict[int, Link]:
    """Ingest-host side: accept one link per follower (each identifies
    with its process id).  `stop` (threading.Event) makes the wait
    interruptible -- a short-handed cluster (a follower that never
    starts) must not wedge the ingest driver thread in accept()
    forever."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(num_followers)
    srv.settimeout(1.0)
    links: dict[int, Link] = {}
    try:
        while len(links) < num_followers:
            if stop is not None and stop.is_set():
                raise RuntimeError(
                    f"stopped while waiting for followers "
                    f"({len(links)}/{num_followers} connected)")
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            # accept() returns a BLOCKING socket regardless of the
            # listener's timeout: a peer that connects but never sends a
            # complete hello (health check, scanner, crashed follower)
            # must not park this thread in recv() forever
            conn.settimeout(10.0)
            link = Link(conn)
            try:
                hello, _ = link.recv()
                pid = int(hello["pid"])
            except Exception:
                link.close()  # malformed / timed-out hello: not a follower
                continue
            if pid in links or not (0 < pid <= num_followers):
                # duplicate or out-of-range id: reject the newcomer
                # rather than silently replacing (and leaking) a live link
                link.close()
                continue
            conn.settimeout(None)  # blocking link; idle gaps are normal
            links[pid] = link
    finally:
        srv.close()
    return links


def connect_link(addr: str, pid: int, timeout: float = 60.0) -> Link:
    """Follower side: connect to the ingest host and identify."""
    host, port = addr.rsplit(":", 1)
    import time

    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection((host, int(port)), timeout=5)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    sock.settimeout(None)  # blocking link; idle gaps are normal
    link = Link(sock)
    link.send({"pid": pid})
    return link


# ------------------------------------------------------- control codec

def _pack_arrays(specs) -> bytes:
    """specs: [(array, dtype), ...] -> concatenated bytes.  Always used
    through one of the codec PAIRS below -- the wire format exists in
    exactly one place per message type."""
    return b"".join(np.ascontiguousarray(a, d).tobytes() for a, d in specs)


class _Taker:
    def __init__(self, blob: bytes):
        self.blob = blob
        self.off = 0

    def __call__(self, count, dt):
        a = np.frombuffer(self.blob, dt, count=count, offset=self.off)
        self.off += a.nbytes
        return a


def pack_control(table_arrays, mid, views, wf_meta, reset
                 ) -> tuple[dict, bytes]:
    """Step control block: (channel table, packet-metadata mids,
    waterfall views, wf coordinate meta, reset mask) -> (header, blob).
    Inverse: unpack_control (keep the two in lockstep)."""
    l, r, m_idx, mode, active, nr, rds, am_env = table_arrays
    specs = [(a, np.int32) for a in (l, r, m_idx, mode)]
    specs.append((active, np.int8))
    specs.append((nr, np.int8))
    specs.append((rds, np.int8))
    specs.append((am_env, np.int8))
    specs.append((mid, np.float64))
    specs += [(views[0], np.int32), (views[1], np.int32)]
    specs += [(a, np.int32) for a in wf_meta]
    has_reset = reset is not None
    if has_reset:
        specs.append((reset, np.int32))
    return ({"c": int(l.shape[0]), "w": int(views[0].shape[0]),
             "reset": has_reset}, _pack_arrays(specs))


def unpack_control(meta: dict, blob: bytes):
    c, w = meta["c"], meta["w"]
    take = _Taker(blob)
    l, r, m_idx, mode = (take(c, np.int32) for _ in range(4))
    active = take(c, np.int8).astype(bool)
    nr = take(c, np.int8).astype(bool)
    rds = take(c, np.int8).astype(bool)
    am_env = take(c, np.int8).astype(bool)
    mid = take(c, np.float64)
    views = (take(w, np.int32), take(w, np.int32))
    wf_meta = tuple(take(w, np.int32) for _ in range(3))
    reset = take(c, np.int32) if meta["reset"] else None
    return ((l, r, m_idx, mode, active, nr, rds, am_env), mid, views,
            wf_meta, reset)


def pack_host_update(chan_offset, chan_count, ctbl, cresets,
                     wf_offset, wf_count, wrows) -> tuple[dict, bytes]:
    """Follower->ingest registry sync: the channel range's table arrays
    (l, r, m_idx, mode, active, mid, nr, rds, am_env), optional reset
    mask, and the waterfall range's 5 view arrays.  Inverse:
    unpack_host_update."""
    specs = [(a, np.int32) for a in ctbl[:4]]
    specs.append((ctbl[4], np.int8))
    specs.append((ctbl[5], np.float64))
    specs.append((ctbl[6], np.int8))
    specs.append((ctbl[7], np.int8))
    specs.append((ctbl[8], np.int8))
    if cresets is not None:
        specs.append((cresets, np.int32))
    specs += [(a, np.int32) for a in wrows]
    return ({"type": "host_update", "chan_offset": chan_offset,
             "chan_count": chan_count, "reset": cresets is not None,
             "wf_offset": wf_offset, "wf_count": wf_count},
            _pack_arrays(specs))


def _events_tbl(tbl_arrays, mids) -> dict:
    """JSON-able slot coordinates for the idle-path /events sync."""
    return {"l": np.asarray(tbl_arrays[0]).tolist(),
            "r": np.asarray(tbl_arrays[1]).tolist(),
            "mid": np.asarray(mids).tolist(),
            "active": np.asarray(tbl_arrays[4]).astype(int).tolist()}


def unpack_host_update(hdr: dict, blob: bytes):
    c, w = hdr["chan_count"], hdr["wf_count"]
    take = _Taker(blob)
    tbl = ([take(c, np.int32) for _ in range(4)]
           + [take(c, np.int8).astype(bool), take(c, np.float64),
              take(c, np.int8).astype(bool),
              take(c, np.int8).astype(bool),
              take(c, np.int8).astype(bool)])
    resets = take(c, np.int32) if hdr["reset"] else None
    wrows = tuple(take(w, np.int32) for _ in range(5))
    return tuple(tbl), resets, wrows


# ------------------------------------------------------------ runtime

class MultihostRuntime:
    """Per-process glue around ShardedHopPipeline for a multi-host mesh.

    Construct AFTER bootstrap(); wraps the global mesh, knows this
    host's shard/channel/hop sub-ranges, puts host-local rows on the
    local devices, and extracts this host's serving outputs."""

    def __init__(self, cfg: ServerConfig, cluster: Cluster):
        from .sharded import ShardedHopPipeline

        self.cfg = cfg
        self.cluster = cluster
        self.process_id = cluster.collectives.rank
        self.num_processes = cluster.collectives.size
        self.mesh = list(cluster.devices)
        counts = cluster.shard_counts
        self.n = sum(counts)
        first = sum(counts[:self.process_id])
        self.local_shards = list(range(first, first + len(self.mesh)))
        assert counts[self.process_id] == len(self.mesh), \
            "host devices must be contiguous on the mesh axis"
        # the ingest host computes each follower's raw-row span from
        # process-id arithmetic (rows[i // dpp == pid]); that is only
        # correct when the mesh axis is process-index-major with equal
        # device counts -- check it here instead of garbling the time
        # shards silently on an uneven cluster
        assert self.n % self.num_processes == 0 \
            and len(set(counts)) == 1, \
            f"devices must split evenly across processes: {counts}"
        dpp = self.n // self.num_processes
        assert self.local_shards[0] == self.process_id * dpp \
            and len(self.local_shards) == dpp, \
            (f"mesh axis not process-index-major: process "
             f"{self.process_id} holds shards {self.local_shards}, "
             f"expected [{self.process_id * dpp}, "
             f"{(self.process_id + 1) * dpp})")
        self.sp = ShardedHopPipeline(
            cfg, self.mesh, gather_wf=True, group=cluster.collectives)
        # serving partition: channel slots are sharded over devices in
        # order, so this host's slot range is exactly its device span
        cpd = cfg.max_channels // self.n
        self.chan_offset = self.local_shards[0] * cpd
        self.chan_count = len(self.local_shards) * cpd

    # ---- input side -------------------------------------------------
    def rows_for(self, block: np.ndarray, shard: int) -> np.ndarray:
        """Ingest host: the raw row for one time shard of this block."""
        return self.all_rows(block)[shard]

    def all_rows(self, block: np.ndarray) -> np.ndarray:
        """Ingest host: [B * wph] wire samples (NO halo) -> [n,
        raw_shard_len] rows, one per time shard."""
        return np.asarray(block).reshape(self.n, self.sp.raw_shard_len)

    def global_raw(self, local_rows: np.ndarray) -> list[torch.Tensor]:
        """[local_n, row_len] host rows -> the local shards' rows on the
        local devices (the step's raw_shards)."""
        return self.sp.shard_raw(local_rows)

    # ---- output side ------------------------------------------------
    def local_audio(self, out) -> np.ndarray:
        """This host's channel-shard audio: [B, C_local, half] (or
        [C_local, T] decimated)."""
        axis = 0 if out.audio[0].ndim == 2 else 1
        return np.concatenate([a.cpu().numpy() for a in out.audio],
                              axis=axis)

    def local_power(self, out) -> np.ndarray:
        return np.concatenate([p.cpu().numpy() for p in out.avg_power],
                              axis=1)

    def local_wf(self, out) -> np.ndarray | None:
        """All hosts hold the full due-row set (gather_wf replication);
        read one local replica."""
        wf = out.wf[0]
        if wf is None or wf.shape[0] == 0:
            return None
        return wf.cpu().numpy()

    def local_rds(self, out) -> np.ndarray | None:
        """This host's channel-shard RDS baseband [C_local, 2, T] (None
        when [input] rds is off), same partition as local_audio."""
        if out.rds[0].shape[-1] == 0:
            return None
        return np.concatenate([r.cpu().numpy() for r in out.rds], axis=0)


# ------------------------------------------------------------- driver

class MultihostDriver:
    """Multi-host drop-in for runtime.driver.DSPDriver: same consumer
    contract (the SpectrumServer's dispatch), engine spanning all hosts.

    Process 0 (ingest): reads the sample stream, merges every host's
    registry rows into the global control state, ships each follower its
    raw rows + the replicated control block per step, runs the step, and
    serves its own channel range.  Followers: receive, step, serve their
    range, and push their registry updates upstream (piggybacked before
    each step_done ack).  Every process passes bit-identical replicated
    inputs to its step, so all issue the same collectives -- the control
    block is the single source of truth.

    Like the single-host driver, the cluster keeps ONE step of ack
    slack in flight: before shipping step N the ingest host waits for
    every follower's ack of step N-2 (not N-1), so the step_done
    round-trip -- a full cluster RTT -- overlaps the next step's
    read/send/compute instead of sitting on the critical path.  The
    step's collectives still synchronize compute per step (all hosts
    issue the same sequence in order); the only cost of the extra slack
    is that a follower-side retune can take two steps instead of one to
    enter the global control block.

    A collective whose peer died raises (gloo: the closed connection;
    any backend: the group's timeout), and the driver fails the cluster
    as it does for a lost link."""

    def __init__(self, cfg: ServerConfig, runtime: MultihostRuntime,
                 source, server, link_addr: str | None = None,
                 link_port: int = DEFAULT_LINK_PORT):
        from ..runtime.driver import Metrics

        self.cfg = cfg
        self.rt = runtime
        self.source = source            # ingest only
        self.server = server
        self.link_port = link_port
        self.link_addr = link_addr or f"127.0.0.1:{link_port}"
        self.metrics = Metrics()
        self.pipe = runtime.sp          # /metrics + tests poke this
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._links: dict[int, "Link"] = {}
        self._acked: dict[int, int] = {}
        self._ack_cv = threading.Condition()
        # cluster-wide /events state: {str(slot): uid} of live slots
        self._uids: dict[str, str] = {}
        self._uid_lock = threading.Lock()
        self._ack_test_delay = float(
            os.environ.get("PHANTOM_MH_TEST_ACK_DELAY", "0") or 0)
        # device-resident (table, views) cache keyed by the ingest's
        # registry versions (shipped as "tver" in the step header):
        # re-uploading the full control table every step costs per-step
        # host->device transfer for state that changes only on retunes
        # (mirrors DSPDriver._tables_for's version-keyed cache)
        self._dev_cache: tuple | None = None

    # ------------------------------------------------------------ plumbing
    def start(self):
        t = threading.Thread(target=self._run, name="multihost-driver",
                             daemon=True)
        self._threads = [t]
        t.start()

    def stop(self):
        self._stop.set()
        # close links FIRST: the driver thread blocks in link.recv() /
        # sendall and only a socket close unblocks it
        for link in list(self._links.values()):
            link.close()
        for t in self._threads:
            t.join(timeout=10)

    def _run(self):
        try:
            if self.rt.sp.device.type == "cuda":
                # build the kernel libraries before the links form, so
                # every process enters the warm-up's collectives at once
                from ..ops.cuda import all_kernels
                from ..ops.cuda.build import build_all

                build_all(all_kernels())
            if self.rt.process_id == 0:
                self._run_ingest()
            else:
                self._run_follower()
        except Exception as e:
            if self._stop.is_set():
                # orderly stop(): the link close unblocks recv()/sendall
                # by design -- not a device error, keep /metrics clean
                return
            import traceback

            traceback.print_exc()
            # fail the CLUSTER, not just this process: a silently-dead
            # ingest leaves followers parked in recv() forever while
            # their websocket servers keep accepting listeners who hear
            # silence (the wedge _fail_cluster exists to prevent)
            self._fail_cluster(repr(e)[:200])

    # ------------------------------------------------------------- ingest
    def _reader(self, pid: int, link: "Link"):
        """Ingest-side per-follower reader: applies host updates into
        the global registries, tracks step acks."""
        # the only offsets this follower may legitimately claim: its
        # device span (registries are range-partitioned identically,
        # main.py slot_offset=rt.chan_offset) -- anything else is
        # version skew or a rogue peer and must not poison the global
        # tables other listeners are served from
        cpd = self.cfg.max_channels // self.rt.n
        dpp = self.rt.n // self.rt.num_processes
        exp_off, exp_cnt = pid * dpp * cpd, dpp * cpd
        try:
            while not self._stop.is_set():
                try:
                    hdr, blob = link.recv()
                except socket.timeout:
                    continue  # idle link; healthy followers may be quiet
                t = hdr.get("type")
                if t == "host_update":
                    if ((hdr["chan_offset"], hdr["chan_count"])
                            != (exp_off, exp_cnt)
                            or (hdr["wf_offset"], hdr["wf_count"])
                            != (exp_off, exp_cnt)):
                        raise ValueError(
                            f"follower {pid} claimed slot range "
                            f"{hdr['chan_offset']}+{hdr['chan_count']}/"
                            f"wf {hdr['wf_offset']}+{hdr['wf_count']}, "
                            f"expected {exp_off}+{exp_cnt}")
                    tbl, resets, wrows = unpack_host_update(hdr, blob)
                    self.server.channels.merge_rows(hdr["chan_offset"],
                                                    tbl, resets)
                    self.server.waterfalls.merge_rows(hdr["wf_offset"],
                                                      wrows)
                    with self._uid_lock:
                        lo = hdr["chan_offset"]
                        hi = lo + hdr["chan_count"]
                        for k in [k for k in self._uids
                                  if lo <= int(k) < hi]:
                            del self._uids[k]
                        self._uids.update(hdr.get("uids", {}))
                elif t == "step_done":
                    def _record(s=hdr["seq"]):
                        with self._ack_cv:
                            self._acked[pid] = max(
                                self._acked.get(pid, -1), s)
                            self._ack_cv.notify_all()

                    if self._ack_test_delay > 0:
                        # fault-injection knob (PHANTOM_MH_TEST_ACK_DELAY
                        # seconds): delivers this ack late, concurrently,
                        # simulating one-way network latency on the step_done
                        # path -- the pipelining test uses it to prove
                        # step cadence is no longer bounded by ack RTT.
                        # daemon: pending timers must not block interpreter
                        # exit after _fail_cluster/EOF
                        t = threading.Timer(self._ack_test_delay, _record)
                        t.daemon = True
                        t.start()
                    else:
                        _record()
        except (ConnectionError, OSError):
            # a dropped link is a DEFINITIVE follower-loss signal --
            # fail the cluster now rather than waiting for the next
            # send to error or the 60 s ack barrier to time out
            # (tests/test_multihost.py::test_multihost_follower_death).
            # After stop() or ingest EOF the close is orderly teardown,
            # not a fault.
            if not (self._stop.is_set() or self.metrics.eof):
                self._fail_cluster(f"follower {pid} link lost")
        except Exception as e:
            # malformed frame (corrupt header, version skew, bad claimed
            # slot range): fail at the decode error with its cause, not
            # 60 s later as a misdiagnosed ack-barrier timeout from a
            # silently-dead reader thread
            if not (self._stop.is_set() or self.metrics.eof):
                import traceback

                traceback.print_exc()
                self._fail_cluster(
                    f"follower {pid} protocol error: {repr(e)[:120]}")

    def _fail_cluster(self, why: str):
        """Fail LOUDLY and promptly.  The step's collectives span every
        process's devices, so a dead or wedged follower
        cannot be papered over -- the next collective would hang all
        hosts with no diagnostics.  Surface the cause in metrics/logs,
        stop issuing steps, and close every link so peers unblock and
        exit too; an external supervisor restarts the cluster (the
        engine is stateless beyond per-connection scratch, like the
        reference)."""
        # the cause first: /metrics is read from another thread, and a
        # reader that sees the count must also see why
        self.metrics.last_device_error = f"cluster failed: {why}"[:300]
        self.metrics.device_errors += 1
        print(f"multihost: cluster failed ({why}); stopping", flush=True)
        self._stop.set()
        for link in list(self._links.values()):
            link.close()
        with self._ack_cv:
            self._ack_cv.notify_all()

    def _run_ingest(self):
        from ..ops.convert import host_preconvert

        cfg = self.cfg
        rt = self.rt
        self._links = serve_links(self.link_port, rt.num_processes - 1,
                                  stop=self._stop)
        for pid, link in self._links.items():
            # bounded socket ops so a WEDGED follower (socket alive,
            # process not reading) surfaces as a timeout instead of an
            # eternal sendall under _wlock
            link.sock.settimeout(60)
            th = threading.Thread(target=self._reader, args=(pid, link),
                                  daemon=True)
            th.start()
        state = self._warmup()
        scalars = 1 if cfg.is_real else 2
        seq = 0
        was_idle = False

        def send_all(hdr, blob=b""):
            for pid, link in list(self._links.items()):
                try:
                    link.send(hdr, blob)
                except (OSError, socket.timeout) as e:
                    self._fail_cluster(f"send to follower {pid}: {e!r}")
                    return False
            return True

        while not self._stop.is_set():
            block = self.source.read_block()
            if block is None:
                self.metrics.eof = True
                send_all({"type": "eof"})
                return
            self.metrics.samples += self.source.block_wire // scalars
            # one-step-in-flight ack barrier (class docstring): before
            # shipping step N, require every follower's ack of N-2 so
            # the step_done round-trip overlaps the next step instead
            # of gating every send (a follower's registry updates ride
            # ahead of its ack, so a retune lands within two steps); a
            # follower that stops acking means the next collective
            # would hang every host -> fail the cluster loudly instead
            with self._ack_cv:
                # generous grace on the FIRST real ack: a follower may
                # still be in its warmup when the ingest starts stepping
                ok = self._ack_cv.wait_for(
                    lambda: all(self._acked.get(p, -1) >= seq - 2
                                for p in self._links)
                    or self._stop.is_set(),
                    timeout=600 if seq <= 2 else 60)
            if self._stop.is_set():
                return
            if not ok:
                stalled = [p for p in self._links
                           if self._acked.get(p, -1) < seq - 2]
                self._fail_cluster(f"followers {stalled} stopped acking "
                                   f"at seq {seq - 2}")
                return

            cv, tbl_arrays, resets, (_, _, mids) = \
                self.server.channels.snapshot()
            wv, vstart, vlength, wf_meta = self.server.waterfalls.snapshot()
            frame0 = self.metrics.frames
            audio_any = bool(tbl_arrays[4].any())
            wf_any = bool((vlength > 0).any())
            # cluster-wide /events block (riding both step and skip):
            # merged uid map + global wf count; every host diffs the
            # replicated table to surface ALL users' tuning
            with self._uid_lock:
                for k in [k for k in self._uids
                          if self.rt.chan_offset <= int(k)
                          < self.rt.chan_offset + self.rt.chan_count]:
                    del self._uids[k]
                self._uids.update(
                    {str(s): u for s, u
                     in self.server.channels.uid_rows().items()})
                uids = dict(self._uids)
            events = {"uids": uids,
                      "wf_clients": int((vlength > 0).sum())}
            self._apply_events(tbl_arrays, mids, events)
            if not audio_any and not wf_any:
                # global idle: skip compute everywhere (src/fft.cpp:72-79)
                if not send_all({"type": "skip", "seq": seq,
                                 "events": events,
                                 "tbl": _events_tbl(tbl_arrays, mids)}):
                    return
                self.metrics.idle_frames += cfg.hop_batch
                self.metrics.frames += cfg.hop_batch
                seq += 1
                was_idle = True
                continue
            fresh = was_idle
            was_idle = False
            if fresh:
                # the sharded pipeline keeps the 50%-overlap halo ON
                # DEVICE; it went stale across the idle gap -- re-init
                # everywhere (followers via the step header) rather than
                # windowing minutes-old samples into the resume frame
                # (same as DSPDriver's sharded resume, runtime/driver.py).
                # frame0 seeds the hop-counter parity (audio polarity
                # continuity); followers seed the SAME value from the
                # step header's frame0, staying in lockstep
                state = rt.sp.init_state(frame0)
            idx, counts = rt.sp.due_layout(frame0)
            due = [i * rt.sp.hops_per_shard + int(idx[i, j])
                   for i in range(rt.n) for j in range(counts[i])]
            due = due if wf_any else []
            mode = "views" if due else "off"
            # format conversion that must happen host-side (f64 -> f32)
            # happens ON THE INGEST HOST, before rows cross the link
            rows = rt.all_rows(host_preconvert(block, cfg.input_format))
            meta, cblob = pack_control(tbl_arrays, mids, (vstart, vlength),
                                       wf_meta, resets)
            dpp = rt.n // rt.num_processes
            sent = True
            for pid, link in list(self._links.items()):
                their = [i for i in range(rt.n) if i // dpp == pid]
                rbytes = rows[their].tobytes()
                try:
                    link.send({"type": "step", "seq": seq,
                               "frame0": frame0, "mode": mode, "due": due,
                               "idx": idx.tolist(), "counts": counts,
                               "control": meta, "nrows": len(their),
                               "events": events, "fresh": fresh,
                               "tver": [cv, wv]},
                              cblob + rbytes)
                except (OSError, socket.timeout) as e:
                    self._fail_cluster(f"send to follower {pid}: {e!r}")
                    sent = False
                    break
            if not sent:
                return
            t0 = time.monotonic()
            state = self._step_and_serve(
                state, rows[rt.local_shards], tbl_arrays, mids,
                (vstart, vlength), wf_meta, resets, idx, counts, due,
                mode, frame0, t0, tver=(cv, wv))
            self.metrics.frames += cfg.hop_batch
            seq += 1

    # ----------------------------------------------------------- follower
    def _run_follower(self):
        cfg = self.cfg
        rt = self.rt
        link = connect_link(self.link_addr, rt.process_id)
        self._links = {0: link}
        state = self._warmup()
        self._last_chan_v = -1
        self._last_wf_v = -1
        while not self._stop.is_set():
            hdr, blob = link.recv()
            t = hdr.get("type")
            if t == "eof":
                self.metrics.eof = True
                return
            if t == "skip":
                self.metrics.frames += cfg.hop_batch
                ev, tb = hdr.get("events"), hdr.get("tbl")
                if ev is not None and tb is not None:
                    self._apply_events(
                        (np.asarray(tb["l"]), np.asarray(tb["r"]),
                         None, None, np.asarray(tb["active"], bool)),
                        np.asarray(tb["mid"]), ev)
                # a client may have connected while idle: its slot must
                # still flow upstream or the ingest host never wakes up
                self._push_updates(link)
                link.send({"type": "step_done", "seq": hdr["seq"]})
                continue
            assert t == "step"
            if hdr.get("fresh"):
                # ingest resumed from a global-idle gap: drop the stale
                # device halo in lockstep with every other host, seeding
                # the same hop-counter parity as the ingest host
                state = rt.sp.init_state(hdr["frame0"])
            rows_bytes = (hdr["nrows"] * rt.sp.raw_shard_len
                          * self.row_dtype.itemsize)
            tbl, mids, views_np, wf_meta, resets = unpack_control(
                hdr["control"], blob[: len(blob) - rows_bytes])
            rows = np.frombuffer(
                blob[len(blob) - rows_bytes:],
                dtype=self.row_dtype).reshape(hdr["nrows"],
                                              rt.sp.raw_shard_len)
            idx = np.asarray(hdr["idx"], np.int32)
            if "events" in hdr:
                self._apply_events(tbl, mids, hdr["events"])
            t0 = time.monotonic()
            state = self._step_and_serve(
                state, rows, tbl, mids, views_np, wf_meta, resets, idx,
                hdr["counts"], hdr["due"], hdr["mode"], hdr["frame0"],
                t0, tver=tuple(hdr["tver"]) if "tver" in hdr else None)
            self.metrics.frames += cfg.hop_batch
            # push local registry changes upstream BEFORE the ack so the
            # ingest host merges them for the next control block
            self._push_updates(link)
            link.send({"type": "step_done", "seq": hdr["seq"]})

    def _push_updates(self, link: "Link"):
        ch = self.server.channels
        wf = self.server.waterfalls
        if ch.version == self._last_chan_v and wf.version == self._last_wf_v:
            return
        self._last_chan_v, self._last_wf_v = ch.version, wf.version
        co, cc, ctbl, cresets = ch.range_rows()
        wo, wc, wrows = wf.range_rows()
        hdr, blob = pack_host_update(co, cc, ctbl, cresets, wo, wc, wrows)
        hdr["uids"] = {str(s): u for s, u in ch.uid_rows().items()}
        link.send(hdr, blob)

    def _apply_events(self, tbl_arrays, mids, events: dict):
        """Marshal the cluster /events state onto this host's serving
        loop (every host shows ALL users, SURVEY section 5 events row)."""
        srv = self.server
        if srv.loop is None:
            return
        srv.loop.call_soon_threadsafe(
            srv.apply_cluster_state,
            np.asarray(tbl_arrays[0]), np.asarray(tbl_arrays[1]),
            np.asarray(mids), np.asarray(tbl_arrays[4]),
            dict(events.get("uids", {})), int(events.get("wf_clients", 0)))

    # -------------------------------------------------------------- step
    def _warmup(self):
        """Run both step variants once up front, mirroring DSPDriver's
        warmup (runtime/driver.py): cuFFT plans, the allocator's pools
        and the staging buffers are made off the serving path, which
        the no-client skip path would otherwise defer to the moment the
        first listener connects -- on EVERY process.  Runs concurrently
        on all hosts right after link formation (its steps are
        collectives).  Returns a fresh serving state.

        Shapes are taken from the real registry snapshots so the warmed
        shapes are exactly the serving loop's."""
        rt = self.rt
        t0 = time.monotonic()
        _, tbl_arrays, _, _ = self.server.channels.snapshot()
        _, vstart, vlength, _ = self.server.waterfalls.snapshot()
        table = self._table(tbl_arrays)
        views = self._views((vstart, vlength))
        zrows = np.zeros((len(rt.local_shards), rt.sp.raw_shard_len),
                         self.row_dtype)
        idx, _ = rt.sp.due_layout(0)
        for mode in ("views", "off"):
            st = rt.sp.init_state()
            st, out = rt.sp.step(st, rt.global_raw(zrows), table, views,
                                 mode, reset=None, due_idx=idx)
            rt.local_power(out)
        print(f"multihost pipeline warmed up in "
              f"{time.monotonic() - t0:.1f}s (process "
              f"{rt.process_id}/{rt.num_processes}, "
              f"{rt.cluster.backend})", flush=True)
        return rt.sp.init_state()

    @property
    def row_dtype(self):
        """Dtype of rows ON THE WIRE: the ingest host runs
        host_preconvert before shipping (f64 arrives as f32)."""
        from ..ops.convert import device_dtype

        return device_dtype(self.cfg.input_format)

    def _table(self, tbl_arrays):
        """The local shards' ChannelTables from the global registry
        columns (l, r, m_idx, mode, active, nr, rds, am_env)."""
        return self.rt.sp.channels_from_numpy(
            *tbl_arrays[:5], am_env=tbl_arrays[7], rds=tbl_arrays[6],
            nr=tbl_arrays[5])

    def _views(self, views_np):
        from ..pipeline import WaterfallViews, to_device

        dev = self.rt.sp.device
        return WaterfallViews(start=to_device(views_np[0], torch.int32, dev),
                              length=to_device(views_np[1], torch.int32,
                                               dev))

    def _step_and_serve(self, state, my_rows, tbl_arrays, mids, views_np,
                        wf_meta, resets, idx, counts, due, mode, frame0,
                        t0, tver=None):
        rt = self.rt
        raw = rt.global_raw(np.ascontiguousarray(my_rows))
        if tver is not None and self._dev_cache is not None \
                and self._dev_cache[0] == tver:
            table, views = self._dev_cache[1], self._dev_cache[2]
        else:
            table = self._table(tbl_arrays)
            views = self._views(views_np)
            if tver is not None:
                self._dev_cache = (tver, table, views)
        # the step takes the reset mask of its own shards' channels
        reset = (None if resets is None else
                 resets[rt.chan_offset:rt.chan_offset + rt.chan_count])
        state, out = rt.sp.step(state, raw, table, views, mode,
                                reset=reset, due_idx=idx)
        audio = rt.local_audio(out)
        pwr = rt.local_power(out)
        wf = rt.local_wf(out) if mode == "views" else None
        if wf is not None:
            # padded per-shard replica rows -> due-list order (counts
            # from due_layout, shipped in the step header)
            wf = wf[rt.sp.due_row_selector(counts)]
        self.metrics.step_seconds.append(time.monotonic() - t0)
        try:
            audio_meta = (tbl_arrays[0], tbl_arrays[1], mids)
            self.server.dispatch_threadsafe(frame0, audio, pwr, wf,
                                            due, wf_meta, audio_meta,
                                            rt.local_rds(out))
        except Exception:
            import traceback

            traceback.print_exc()
        return state
