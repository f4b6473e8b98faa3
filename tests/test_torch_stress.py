"""tools/torch_stress.py and what it adds to tools/torch_clients.py.

The tool against ``python -m phantomsdr_tpu_torch --device cpu`` at a
small config, fed on its stdin by the clients' pipe feeder, with the
JAX package unimportable: every key of tools/stress.py's output, its
flags and defaults, packets and decoded streams with no error of any
kind (delivery and integrity only: a CPU server on a machine shared
with other test workers runs far behind real time, so no rate is
asserted).  Then the clients' parts on their own: the RDS counters on
synthetic ``{"type":"rds"}`` frames, the feeder's order across its
pool's wrap and its lag when the reader stalls.
"""

import ast
import asyncio
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import torch_clients  # noqa: E402
from tools import torch_stress  # noqa: E402

# runs a script with the JAX package and JAX itself unimportable
NO_JAX = ("import runpy, sys; sys.modules['jax'] = None; "
          "sys.modules['phantomsdr_tpu'] = None; sys.argv = sys.argv[1:]; "
          "runpy.run_path(sys.argv[0], run_name='__main__')")
SMALL = """[server]
port = {port}

[input]
sps = 192000
frequency = 7000000
fft_size = 4096
signal = "iq"
audio_sps = 12000
waterfall_size = 512

[input.driver]
name = "stdin"
format = "u8"

[tpu]
hop_batch = 4
max_channels = 16
"""
BLOCK_BYTES = 4 * 2048 * 2     # hop_batch x hop x (I, Q), u8


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stress_py_output_keys() -> set:
    """The keys of the dict tools/stress.py prints (its json.dumps)."""
    tree = ast.parse((REPO / "tools" / "stress.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "dumps" and node.args \
                and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps of a dict in tools/stress.py")


def stress_py_flags() -> dict:
    """tools/stress.py's flags: {flag: (type name, default, action)}."""
    tree = ast.parse((REPO / "tools" / "stress.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = (
                getattr(kw.get("type"), "id", None),
                ast.literal_eval(kw["default"]) if "default" in kw
                else None,
                ast.literal_eval(kw["action"]) if "action" in kw else None)
    return out


def test_flags_and_defaults_are_stress_py_s():
    ours = {a.option_strings[0]: a for a in torch_stress.parser()._actions
            if a.option_strings and a.dest != "help"}
    for flag, (typ, default, action) in stress_py_flags().items():
        a = ours[flag]
        if action == "store_true":
            assert a.const is True and a.nargs == 0, flag
            assert a.default is False and default is None, flag
        else:
            assert a.default == default, flag
            assert getattr(a.type, "__name__", None) == typ, flag
    assert set(ours) - set(stress_py_flags()) == {"--device"}
    assert ours["--device"].default == "cuda"


def test_stress_against_the_cpu_cli_fed_through_stdin(tmp_path):
    port = free_port()
    (tmp_path / "config.toml").write_text(SMALL.format(port=port))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    log = open(tmp_path / "server.log", "w")
    srv = subprocess.Popen(
        [sys.executable, "-m", "phantomsdr_tpu_torch", "-c",
         str(tmp_path / "config.toml"), "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT,
        cwd=REPO, env=env)
    feeder = torch_clients.PipeFeeder(
        srv.stdin, torch_clients.seeded_pool(4 * BLOCK_BYTES, 1),
        192000 * 2).start()
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                    if json.loads(r.read())["frames"] > 0:
                        break
            except OSError:
                pass
            assert srv.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "server.log").read_text()[-3000:]
            time.sleep(0.2)
        res = subprocess.run(
            [sys.executable, "-c", NO_JAX, "tools/torch_stress.py",
             "--url", f"ws://127.0.0.1:{port}", "--audio", "4", "--wf",
             "2", "--secs", "8", "--churn", "4", "--wf-deflate-frac",
             "0.5", "--decode-every", "2", "--device", "cpu"],
            capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    finally:
        feeder.stop()
        srv.stdin.close()
        srv.terminate()
        try:
            srv.wait(timeout=20)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
        log.close()
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout)
    assert stress_py_output_keys() <= set(out)
    assert list(out)[:len(stress_py_output_keys())] == [
        k for k in out if k in stress_py_output_keys()]
    assert out["audio_pkts_per_s"] > 0 and out["wf_pkts_per_s"] > 0, out
    assert out["decoded_audio_samples"] > 0, out
    assert out["decoded_wf_rows"] > 0 and out["deflate_acks"] >= 1, out
    assert out["errors"] == 0 and out["decode_errors"] == 0, out
    assert out["server_metrics"]["frames"] > 0
    assert out["server_metrics"]["device_errors"] == 0
    assert out["card"] is None and feeder.error is None
    assert out["client_loop_lag_ms"]["max"] >= 0
    assert out["audio_pkts_per_client_per_s"]["p50"] > 0, out


def test_stress_on_the_card_by_default(tmp_path):
    """No fallback: without a card the default --device cuda refuses."""
    if shutil.which("nvidia-smi"):
        pytest.skip("this machine has nvidia-smi: the card is there")
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, "tools/torch_stress.py", "--secs",
         "1"], capture_output=True, text=True, timeout=60, cwd=REPO)
    assert res.returncode == 2 and "--device cpu" in res.stderr
    assert res.stdout == ""


def test_rds_counters_on_synthetic_frames():
    """audio_client(rds=True, same_window=True) tunes FM on the middle
    of the band at full width, opts in, and counts the rds frames."""
    from aiohttp import web

    got = []
    frames = [{"type": "rds", "pi": "54A7", "synced": False},
              {"type": "rds", "pi": "54A7", "ps": "PHANTOM!",
               "synced": True},
              {"type": "compression", "waterfall": "deflate"}]

    async def audio(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        await ws.send_str(json.dumps({"fft_result_size": 4096,
                                      "audio_max_fft": 360}))
        for _ in range(3):
            got.append(json.loads((await ws.receive()).data))
        for f in frames:
            await ws.send_str(json.dumps(f))
        await ws.send_bytes(b"\xa0")          # an empty CBOR map
        await ws.close()
        return ws

    async def run():
        import aiohttp

        app = web.Application()
        app.router.add_get("/audio", audio)
        runner = web.AppRunner(app)
        await runner.setup()
        port = free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        stats = torch_clients.new_stats()
        try:
            async with aiohttp.ClientSession() as s:
                await asyncio.wait_for(torch_clients.audio_client(
                    s, f"ws://127.0.0.1:{port}", 7, stats, asyncio.Event(),
                    rds=True, same_window=True), 30)
        finally:
            await runner.cleanup()
        return stats

    stats = asyncio.run(run())
    l = (4096 - 360) // 2
    assert got == [{"cmd": "window", "l": l, "m": l + 180, "r": l + 360},
                   {"cmd": "demodulation", "demodulation": "FM"},
                   {"cmd": "rds", "enabled": True}]
    assert stats["rds_frames"] == 2 and stats["rds_synced"] == 1
    assert stats["audio_pkts"] == 1 and stats["audio_closed"] == 1
    assert stats["audio_pkts_by_client"] == {7: 1}
    assert stats["audio_errors"] == 0, stats["last_error"]


def test_pipe_feeder_loops_its_pool_in_order():
    pool = torch_clients.seeded_pool(3000, 4)
    stream, feeder = torch_clients.feed_pipe(pool, None)
    try:
        data = stream.read(10_000)
    finally:
        stream.close()
        feeder.stop()
    assert not feeder._thread.is_alive()
    np.testing.assert_array_equal(np.frombuffer(data, np.uint8),
                                  np.tile(pool, 4)[:10_000])
    assert 100 < pool.mean() < 156


def test_pipe_feeder_lag_grows_when_the_reader_stalls():
    """Paced at 4 MB/s: a reader that stops for 1 s lets 4 MB pile up
    against a pipe of at most 1 MiB, so a write waits and lags."""
    stream, feeder = torch_clients.feed_pipe(
        torch_clients.seeded_pool(1 << 20, 5), 4e6)
    try:
        stream.read(1 << 20)
        feeder.mark()
        time.sleep(1.0)
        stream.read(6 << 20)
        st = feeder.stats()
    finally:
        stream.close()
        feeder.stop()
    assert st["bytes"] > 0 and st["chunks"] > 0
    assert st["max_lag_ms"] >= 300, st
    assert st["error"] is None


def test_loop_lag_probe():
    async def run():
        stop, lags = asyncio.Event(), []
        task = asyncio.create_task(torch_clients.loop_lag(stop, lags))
        await asyncio.sleep(0.12)
        time.sleep(0.3)                       # the loop held up
        await asyncio.sleep(0.12)
        stop.set()
        await task
        return lags

    lags = asyncio.run(run())
    assert len(lags) >= 3 and max(lags) >= 200
    assert torch_clients.percentile(lags, 0.5) < max(lags)
