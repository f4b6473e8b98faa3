"""The port's multi-host server as real clusters of ``python -m
phantomsdr_tpu_torch --device cpu --cpu-devices 2`` processes over
gloo, the counterparts of tests/test_multihost.py's cluster tests:
follower death is detected promptly by the ingest host, which keeps
serving; input EOF shuts every process down cleanly; the pipelined ack
barrier hides an injected ack delay; a 3-process cluster serves a
listener on every host, a follower's through its own channel shard.

Every coordinator, link and server port is a free ephemeral one, so
these run beside tests/test_multihost.py's fixed ports."""

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

CFG = """
[server]
port={port}

[input]
sps=192000
fft_size=2048
frequency=7166000
signal="iq"
audio_sps=12000
waterfall_size=256

[input.driver]
name="stdin"
format="s16"

[tpu]
hop_batch={hop}
max_channels={chans}
"""


def free_ports(k: int) -> list[int]:
    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def spawn_cluster(tmp_path, n_proc, loop=True, capture_blocks=400,
                  env_extra=None, device="cpu"):
    """Start an N-process cluster (1 ingest + N-1 followers, 2 CPU
    shards each, or with ``device="cuda"`` card i for process i);
    returns (procs, ports, hop_batch, metrics_fn).  The caller ends the
    processes with ``stop``."""
    ports = free_ports(n_proc + 2)
    coord, link, ports = ports[0], ports[1], ports[2:]
    n_dev = (2 if device == "cpu" else 1) * n_proc
    # hop_batch/max_channels must divide over the mesh (sharded.py);
    # tests/test_multihost.py's shapes: 8/8 for 2 processes, 2n else
    hop = chans = 8 if n_dev == 4 else 2 * n_dev
    raw = np.random.default_rng(0).integers(
        -20000, 20000, size=16384 * capture_blocks, dtype=np.int16)
    capture = tmp_path / "capture.s16"
    raw.tofile(capture)
    for pid, port in enumerate(ports):
        (tmp_path / f"config{pid}.toml").write_text(
            CFG.format(port=port, hop=hop, chans=chans))
    # one compute thread a process, and the capture replayed at its
    # real rate (a block each 43 ms) rather than as fast as the ingest
    # can read it: a cluster is several processes on the test machine's
    # cores, beside other files' clusters, and an idle one would
    # otherwise spin through skip messages on every core it has
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    shards = ["--cpu-devices", "2"] if device == "cpu" else []
    common = [sys.executable, "-m", "phantomsdr_tpu_torch",
              "--device", device, *shards,
              "--coordinator", f"127.0.0.1:{coord}",
              "--num-processes", str(n_proc), "--throttle",
              "--input-file", str(capture)] + (["--loop"] if loop else [])
    procs = []
    for pid in range(n_proc):
        role = (["--link-port", str(link)] if pid == 0
                else ["--link-addr", f"127.0.0.1:{link}"])
        card = {} if device == "cpu" else {"CUDA_VISIBLE_DEVICES": str(pid)}
        with open(tmp_path / f"s{pid}.log", "wb") as log:
            procs.append(subprocess.Popen(
                common + ["-c", str(tmp_path / f"config{pid}.toml"),
                          "--process-id", str(pid)] + role,
                env=dict(env, **card), stdout=log,
                stderr=subprocess.STDOUT, cwd=REPO,
                stdin=subprocess.DEVNULL))

    def metrics(which=0):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ports[which]}/metrics", timeout=2) as r:
            return json.loads(r.read())

    return procs, ports, hop, metrics


def logs(tmp_path, n):
    return "\n".join((tmp_path / f"s{i}.log").read_text()[-2000:]
                     for i in range(n))


def wait_metrics(procs, metrics, pred, deadline_s, tmp_path, which=0):
    deadline = time.monotonic() + deadline_s
    m = None
    while time.monotonic() < deadline:
        try:
            m = metrics(which)
            if pred(m):
                return m
        except OSError:
            pass
        # the polled process must stay up; its peer may legitimately be
        # dead (the fault being injected)
        assert procs[which].poll() is None, logs(tmp_path, len(procs))
        time.sleep(0.2)
    raise AssertionError(f"metrics predicate not met in {deadline_s}s: {m}"
                         f"\n{logs(tmp_path, len(procs))}")


def stop(procs):
    """SIGTERM every process; each must end within 10 s."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    slow = []
    for i, p in enumerate(procs):
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            slow.append(i)
    return slow


def hold_waterfall(port: int, stop_evt: threading.Event) -> threading.Thread:
    """A thread holding one /waterfall client on ``port`` until
    ``stop_evt``: the cluster then computes every step."""
    async def run():
        import aiohttp

        async with aiohttp.ClientSession() as s:
            async with s.ws_connect(f"http://127.0.0.1:{port}/waterfall",
                                    max_msg_size=1 << 22) as ws:
                while not stop_evt.is_set():
                    try:
                        await ws.receive(timeout=0.3)
                    except asyncio.TimeoutError:
                        pass

    th = threading.Thread(target=lambda: asyncio.run(run()), daemon=True)
    th.start()
    return th


@pytest.mark.parametrize("serving", [False, True])
def test_multihost_follower_death(tmp_path, serving):
    """SIGKILL the follower mid-stream, with the cluster idle (skip
    messages only) or computing every step for a waterfall client (the
    ingest's driver thread then sits in the step's collectives): the
    ingest host detects the loss (its reader thread, or the collective
    that lost its peer) in under 20 s, reports ``cluster failed`` in
    /metrics, stops stepping (frames freeze) and keeps serving; SIGTERM
    then ends it."""
    procs, ports, hop, metrics = spawn_cluster(tmp_path, 2)
    done = threading.Event()
    try:
        wait_metrics(procs, metrics, lambda m: m["frames"] >= 3 * hop, 90,
                     tmp_path)
        if serving:
            hold_waterfall(ports[0], done)
            wait_metrics(procs, metrics,
                         lambda m: m["waterfall_clients"] == 1
                         and m["step_ms_p50"] > 0, 30, tmp_path)
        procs[1].kill()
        t_kill = time.monotonic()
        m = wait_metrics(procs, metrics, lambda m: m["device_errors"] >= 1,
                         30, tmp_path)
        detect_s = time.monotonic() - t_kill
        assert "cluster failed" in m["last_device_error"], m
        assert detect_s < 20, f"detection took {detect_s:.1f}s"
        f0 = metrics()["frames"]
        time.sleep(2.0)
        assert metrics()["frames"] == f0
        assert procs[0].poll() is None
    finally:
        done.set()
        slow = stop(procs)
    assert not slow, f"processes {slow} outlived SIGTERM by 10 s"


def test_multihost_eof_propagates_shutdown(tmp_path):
    """Input EOF at the ingest host ends the stream on every host: both
    report eof with no device error after stepping (or skipping) every
    block, both serving edges stay up, and SIGTERM ends both within
    10 s."""
    blocks = 60
    procs, _, hop, metrics = spawn_cluster(tmp_path, 2, loop=False,
                                           capture_blocks=blocks)
    try:
        m0 = wait_metrics(procs, metrics, lambda m: m["eof"], 120, tmp_path)
        m1 = wait_metrics(procs, metrics, lambda m: m["eof"], 30, tmp_path,
                          which=1)
        assert m0["device_errors"] == 0 and m1["device_errors"] == 0, (m0,
                                                                       m1)
        # 16384 int16 a block = 8192 IQ samples = 8 hops of 1024
        assert m0["frames"] == m1["frames"] == blocks * 8, (m0, m1)
        assert hop == 8
        assert procs[0].poll() is None and procs[1].poll() is None
    finally:
        slow = stop(procs)
    assert not slow, f"processes {slow} outlived SIGTERM by 10 s"


def test_multihost_pipelined_ack_hides_delay(tmp_path):
    """A 1.5 s one-way delay on every step_done ack
    (PHANTOM_MH_TEST_ACK_DELAY): the ack barrier waits for ack N-2
    before shipping step N, so the step cadence stays under 0.8 x the
    delay, where a lockstep barrier would hold it at the delay or
    more."""
    delay = 1.5
    procs, _, hop, metrics = spawn_cluster(
        tmp_path, 2, env_extra={"PHANTOM_MH_TEST_ACK_DELAY": str(delay)})
    try:
        m = wait_metrics(procs, metrics, lambda m: m["frames"] >= 3 * hop,
                         90, tmp_path)
        t0, f0 = time.monotonic(), m["frames"]
        time.sleep(9.0)
        m1 = metrics()
        steps = (m1["frames"] - f0) / hop
        assert steps >= 2, (m, m1)
        cadence = (time.monotonic() - t0) / steps
        assert cadence < delay * 0.8, (
            f"step cadence {cadence:.2f}s still bounded by the {delay}s "
            f"ack latency", m, m1)
        assert m1["device_errors"] == 0, m1
    finally:
        stop(procs)


def test_multihost_three_process_serving(tmp_path):
    """1 ingest + 2 followers (6 CPU shards), one live AM listener on
    EVERY host: the followers' slots come from their own ranges and
    their window commands flow up two links at once; every listener
    receives audio packets from its host's own channel shard, and every
    host's /events reports the cluster's 3 listeners."""
    procs, ports, hop, metrics = spawn_cluster(tmp_path, 3)
    try:
        for which in range(3):
            wait_metrics(procs, metrics, lambda m: m["frames"] >= 3 * hop,
                         120, tmp_path, which=which)

        async def listen(port, synced):
            import aiohttp

            loop = asyncio.get_running_loop()
            async with aiohttp.ClientSession() as s:
                url = f"http://127.0.0.1:{port}"
                async with s.ws_connect(url + "/audio",
                                        max_msg_size=1 << 22) as ws:
                    info = json.loads((await ws.receive()).data)
                    mid = info["fft_result_size"] // 2
                    await ws.send_str(json.dumps(
                        {"cmd": "window", "l": mid - 32, "m": mid,
                         "r": mid + 32}))
                    await ws.send_str(json.dumps(
                        {"cmd": "demodulation", "demodulation": "AM"}))
                    pkts, deadline = 0, loop.time() + 60
                    while pkts < 3:
                        left = deadline - loop.time()
                        assert left > 0, f"port {port}: {pkts} audio pkts"
                        msg = await ws.receive(timeout=left)
                        if msg.type == aiohttp.WSMsgType.BINARY:
                            pkts += 1
                    # hold the slot while the others sync, so /events
                    # sees all three listeners
                    async with s.ws_connect(url + "/events") as ev:
                        deadline = loop.time() + 60
                        while True:
                            msg = await ev.receive(
                                timeout=deadline - loop.time())
                            st = json.loads(msg.data)
                            if st.get("signal_clients") == 3:
                                break
                    # no listener leaves its slot until every one has
                    # seen all three
                    await asyncio.wait_for(synced.wait(), 60)
                    async with s.get(url + "/metrics") as r:
                        st["local"] = json.loads(await r.text())
                    return st

        async def drive():
            synced = asyncio.Barrier(3)
            return await asyncio.gather(*(listen(p, synced) for p in ports))

        states = asyncio.run(drive())
        for st in states:
            assert st["signal_clients"] == 3, st
            assert st["local"]["audio_clients"] == 1, st["local"]
            assert st["local"]["device_errors"] == 0, st["local"]
    finally:
        slow = stop(procs)
    assert not slow, f"processes {slow} outlived SIGTERM by 10 s"
