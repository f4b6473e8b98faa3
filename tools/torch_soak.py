"""Long-run serving soak of the PyTorch port, with resource bounds.

The counterpart of tools/soak.py: the same flags, defaults and pass
criteria, for ``python -m phantomsdr_tpu_torch``.  It makes the
``tools/verify/captures.py --variant tone`` capture, serves it with
``--loop --throttle`` on the card (``--device``, default ``cuda``),
churns audio and waterfall clients against it for ``--secs`` (default
one hour) and samples every ``--sample-secs``:

  - the server's RSS (/proc/<pid>/status VmRSS) and its device memory
    (``nvidia-smi --query-compute-apps=pid,used_memory``: the server's
    row, or the sum of the rows where the card's process ids are not
    this machine's; null on ``--device cpu``)
  - /metrics step_ms_p50, encode queue depth and drops, device errors
    and the kernels' launches
  - client packet delivery and decode integrity (tools/torch_clients.py:
    every 8th audio and every 4th waterfall client decodes its stream)

Pass criteria (exit non-zero on a miss):
  - RSS growth after the warm-up (the first fifth of the samples)
    under --rss-budget-pct an hour (default 5%), and the device memory's
    growth under the same budget
  - latency stays flat: the late third's step_ms_p50 within
    --lat-factor (default 1.5) of the early third's
  - zero device errors, zero client errors, zero decode errors

Writes the samples and the verdict to --out (if given) and prints the
verdict, with the card's nvidia-smi name and power limit.  tests/test_torch_soak.py runs a short smoke on the CPU.

Usage:
  python tools/torch_soak.py --secs 3600 --audio 24 --wf 8 \\
      --out build/soak/SOAK_torch.json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
START_SECS = 300    # the server's start: the kernels' build and warm-up


def rss_kb(pid: int) -> int:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


def device_mem_mb(pid: int) -> tuple[int | None, str | None]:
    """(MiB the card holds for ``pid``, how it was read): nvidia-smi's
    row for the pid, else the sum of every compute process's rows (in a
    container the card reports host process ids); (None, None) where
    nvidia-smi lists nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None, None
    rows = []
    for line in out.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            rows.append((int(parts[0]), int(parts[1])))
    mine = [mb for p, mb in rows if p == pid]
    if mine:
        return sum(mine), "pid"
    if rows:
        return sum(mb for _, mb in rows), "all compute processes"
    return None, None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _growth_pct_per_hour(first, last, hours):
    if not isinstance(first, (int, float)) or not isinstance(
            last, (int, float)) or first <= 0:
        return None
    return 100.0 * (last - first) / first / hours


def verdict(samples: list[dict], stats: dict, args) -> dict:
    """tools/soak.py's verdict over ``samples`` (dicts with t, rss_kb,
    device_mem_mb, step_ms_p50, device_errors, encode_dropped) and the
    clients' ``stats``, with the device memory held to the RSS budget
    where it was read."""
    n = len(samples)
    warm = max(1, n // 5)          # the first fifth is the warm-up
    post = samples[warm:] or samples[-1:]
    hours = max((post[-1]["t"] - post[0]["t"]) / 3600.0, 1e-6)
    rss0, rss1 = post[0]["rss_kb"], post[-1]["rss_kb"]
    rss_pct = _growth_pct_per_hour(rss0, rss1, hours)
    dev0, dev1 = post[0].get("device_mem_mb"), post[-1].get("device_mem_mb")
    dev_pct = _growth_pct_per_hour(dev0, dev1, hours)
    lat = [p["step_ms_p50"] for p in post
           if isinstance(p.get("step_ms_p50"), (int, float))
           and p["step_ms_p50"] > 0]
    third = max(1, len(lat) // 3)
    lat_early = sum(lat[:third]) / third if lat else None
    lat_late = sum(lat[-third:]) / third if lat else None
    # cumulative server counters: the max over the samples, so that a
    # failed last /metrics fetch cannot hide earlier errors
    dev_errors = max((p["device_errors"] for p in samples
                      if isinstance(p.get("device_errors"), int)),
                     default=0)
    enc_dropped = max((p["encode_dropped"] for p in samples
                       if isinstance(p.get("encode_dropped"), int)),
                      default=0)
    client_errors = stats["audio_errors"] + stats["wf_errors"]
    return {
        "secs": args.secs,
        "clients": {"audio": args.audio, "wf": args.wf,
                    "churn_secs": args.churn},
        "samples": n,
        "rss_kb_first_postwarmup": rss0,
        "rss_kb_final": rss1,
        "rss_pct_per_hour": rss_pct,
        "rss_budget_pct_per_hour": args.rss_budget_pct,
        "device_mem_mb_first_postwarmup": dev0,
        "device_mem_mb_final": dev1,
        "device_mem_pct_per_hour": dev_pct,
        "step_ms_p50_early": lat_early,
        "step_ms_p50_late": lat_late,
        "lat_factor": args.lat_factor,
        "audio_pkts": stats["audio_pkts"],
        "wf_pkts": stats["wf_pkts"],
        "reconnects": stats["reconnects"],
        "decoded_audio_samples": stats["decoded_audio_samples"],
        "decoded_wf_rows": stats["decoded_wf_rows"],
        "decode_errors": stats["decode_errors"],
        "client_errors": client_errors,
        "last_client_error": stats.get("last_error"),
        "device_errors": dev_errors,
        "encode_dropped": enc_dropped,
        "device_mem_read": samples[-1].get("device_mem_read"),
        "kernel_launches": samples[-1].get("kernel_launches"),
        "pass": (rss_pct is not None and rss_pct < args.rss_budget_pct
                 and (dev_pct is None or dev_pct < args.rss_budget_pct)
                 and lat_early is not None
                 and lat_late <= args.lat_factor * lat_early
                 and stats["decode_errors"] == 0 and client_errors == 0
                 and dev_errors == 0),
    }


async def _metrics(session, url: str) -> dict:
    async with session.get(url + "/metrics") as r:
        return json.loads(await r.text())


async def soak(args) -> dict:
    import aiohttp

    from tools.torch_clients import audio_client, new_stats, wf_client
    from phantomsdr_tpu_torch.bench import card_line

    out = Path(args.dir)
    port = args.port or free_port()
    subprocess.run(
        [sys.executable, "tools/verify/captures.py", "--variant", "tone",
         "--out", str(out), "--port", str(port)],
        check=True, cwd=REPO, capture_output=True)
    log = open(out / "server.log", "w")
    srv = subprocess.Popen(
        [sys.executable, "-m", "phantomsdr_tpu_torch", "-c",
         str(out / "config.toml"), "--input-file",
         str(out / "capture.s16"), "--loop", "--throttle",
         "--device", args.device],
        stdout=log, stderr=log, cwd=REPO)
    url = f"http://127.0.0.1:{port}"
    stats = new_stats()
    samples: list[dict] = []
    stop = asyncio.Event()
    on_card = args.device == "cuda"
    try:
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as s:
            deadline = time.monotonic() + START_SECS
            while True:  # wait for serving
                try:
                    if (await _metrics(s, url))["frames"] > 0:
                        break
                except (aiohttp.ClientError, OSError, KeyError, ValueError):
                    pass
                if srv.poll() is not None or time.monotonic() > deadline:
                    raise RuntimeError("server never served")
                await asyncio.sleep(1.0)
            ws_url = f"ws://127.0.0.1:{port}"
            tasks = [asyncio.create_task(audio_client(
                s, ws_url, i, stats, stop, churn_secs=args.churn,
                decode=i % 8 == 0)) for i in range(args.audio)]
            tasks += [asyncio.create_task(wf_client(
                s, ws_url, i, stats, stop, deflate=i % 2 == 0,
                decode=i % 4 == 0)) for i in range(args.wf)]
            t0 = time.monotonic()
            while time.monotonic() - t0 < args.secs:
                await asyncio.sleep(min(args.sample_secs, args.secs / 10))
                try:
                    m = await _metrics(s, url)
                except (aiohttp.ClientError, OSError, ValueError) as e:
                    m = {"error": repr(e)}
                dev_mb, dev_src = (device_mem_mb(srv.pid) if on_card
                                   else (None, None))
                samples.append({
                    "t": time.monotonic() - t0,
                    "rss_kb": rss_kb(srv.pid),
                    "device_mem_mb": dev_mb,
                    "device_mem_read": dev_src,
                    "step_ms_p50": m.get("step_ms_p50"),
                    "frames": m.get("frames"),
                    "encode_queue_depth": m.get("encode_queue_depth"),
                    "encode_dropped": m.get("encode_dropped"),
                    "device_errors": m.get("device_errors"),
                    "audio_pkts": stats["audio_pkts"],
                    "wf_pkts": stats["wf_pkts"],
                    "decode_errors": stats["decode_errors"],
                    "kernel_launches": m.get("kernel_launches"),
                })
                if srv.poll() is not None:
                    raise RuntimeError("server died mid-soak")
            stop.set()
            for t in tasks:
                t.cancel()
            # drain the cancellations before reading stats: each session's
            # decode check runs in its finally
            await asyncio.gather(*tasks, return_exceptions=True)
    finally:
        srv.terminate()
        try:
            srv.wait(timeout=10)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
        log.close()
    v = verdict(samples, stats, args)
    v["card"] = card_line() if on_card else None
    return {"samples": samples, "verdict": v}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--secs", type=float, default=3600)
    ap.add_argument("--sample-secs", type=float, default=30)
    ap.add_argument("--audio", type=int, default=24)
    ap.add_argument("--wf", type=int, default=8)
    ap.add_argument("--churn", type=float, default=45,
                    help="audio clients reconnect every ~N s")
    ap.add_argument("--rss-budget-pct", type=float, default=5.0)
    ap.add_argument("--lat-factor", type=float, default=1.5,
                    help="final-third step p50 must be <= factor x "
                         "first-third (looser for short smokes)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--port", type=int, default=0,
                    help="the server's port (0: a free one)")
    ap.add_argument("--dir", default=str(REPO / "build" / "soak"))
    ap.add_argument("--out", default=None)
    return ap


def main():
    args = parser().parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_soak: no CUDA device; pass --device cpu",
                  file=sys.stderr)
            return 2
    res = asyncio.run(soak(args))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res["verdict"], indent=1))
    return 0 if res["verdict"]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
