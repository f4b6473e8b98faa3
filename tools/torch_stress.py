"""Serving stress for the PyTorch port: N audio + M waterfall websocket
clients against a running ``python -m phantomsdr_tpu_torch`` server;
reports packet rates, decode integrity and the server's metrics.

The counterpart of tools/stress.py, with its flags, defaults and JSON
keys.  Its clients (tools/torch_clients.py) decode FLAC, Opus, zstd,
deflate and AV1 through a copy of the from-spec FLAC decoder and the
port's ``runtime.codecs`` / ``runtime.av1``, so it needs neither the
JAX package nor python-zstandard.  After stress.py's keys it adds:

  - ``client_loop_lag_ms``: how late the clients' own event loop woke
    (p50, max), so that a client-side bottleneck is not read as the
    server's;
  - ``audio_pkts_per_client_per_s``: each audio client's packet rate
    over the run (min, p50);

and ``card``, the nvidia-smi name and power limit of the card the
server runs on (``--device cuda``, the default, which fails where
nvidia-smi lists no card), or null with ``--device cpu``.

The stream decode of every ``--decode-every``-th client runs in worker
processes; at the end of the run the clients stop on their own (each
within its receive timeout) so that every session's stream is checked
there, and the JSON follows.

Usage:
  python tools/torch_stress.py --url ws://127.0.0.1:19002 --audio 100 \\
      --wf 28 --churn 45 --wf-deflate-frac 0.5 --decode-every 10 --secs 60
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import json
import multiprocessing
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STOP_GRACE_SECS = 8.0   # a waterfall client's receive timeout is 5 s


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="ws://127.0.0.1:19002")
    ap.add_argument("--audio", type=int, default=50)
    ap.add_argument("--wf", type=int, default=50)
    ap.add_argument("--secs", type=float, default=20)
    ap.add_argument("--churn", type=float, default=0.0,
                    help="audio clients reconnect every ~N s and retune "
                         "randomly (slot-reuse/reset/AGC churn)")
    ap.add_argument("--rds", action="store_true",
                    help="every audio client tunes FM on the default "
                         "window and opts into server-side RDS")
    ap.add_argument("--wf-deflate-frac", type=float, default=0.0,
                    help="fraction of waterfall clients opting into the "
                         "per-conn deflate extension (zstd server only): "
                         "mixes both wf codecs on one encode pool")
    ap.add_argument("--decode-every", type=int, default=0,
                    help="every Nth client of each kind fully decodes "
                         "its stream (integrity under load); 0 = off")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the server runs: cuda (=) reports the "
                         "card beside the figures and fails without one")
    return ap


async def stress(args, card: str | None) -> dict:
    import aiohttp

    from tools.torch_clients import (
        audio_client, loop_lag, new_stats, percentile, wf_client,
    )

    # the clients' codecs import torch: seconds that must not land in
    # the loop-lag probe's samples
    import phantomsdr_tpu_torch.runtime.av1  # noqa: F401

    stats = new_stats()
    stop = asyncio.Event()
    lags: list[float] = []
    de = args.decode_every
    # the FLAC decoder is pure Python: in this loop's threads it would
    # hold the interpreter lock the clients need to read their sockets
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    try:
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as session:
            lag_task = asyncio.create_task(loop_lag(stop, lags))
            tasks = [asyncio.create_task(audio_client(
                session, args.url, i, stats, stop, args.churn,
                rds=args.rds, same_window=args.rds,
                decode=bool(de) and i % de == 0, executor=pool))
                for i in range(args.audio)]
            tasks += [asyncio.create_task(wf_client(
                session, args.url, i, stats, stop,
                deflate=args.wf_deflate_frac > 0
                and i < args.wf * args.wf_deflate_frac,
                decode=bool(de) and i % de == 0))
                for i in range(args.wf)]
            print("torch_stress: clients started", file=sys.stderr,
                  flush=True)
            t0 = time.monotonic()
            await asyncio.sleep(args.secs)
            stop.set()
            dt = time.monotonic() - t0
            pkts = [stats["audio_pkts_by_client"].get(i, 0) / dt
                    for i in range(args.audio)]
            # the clients leave their loops within their receive timeout
            # and check their session's stream on the way out; a client
            # still waiting after the grace is cancelled (its stream is
            # then checked in the loop)
            _, late = await asyncio.wait(tasks, timeout=STOP_GRACE_SECS)
            for t in late:
                t.cancel()
            await asyncio.gather(*tasks, lag_task, return_exceptions=True)
            http_url = args.url.replace("ws://", "http://")
            try:
                async with session.get(http_url + "/metrics") as resp:
                    metrics = await resp.json()
            except (aiohttp.ClientError, ValueError):
                metrics = {}
    finally:
        pool.shutdown(cancel_futures=True)
    return {
        "secs": round(dt, 1),
        "audio_pkts_per_s": round(stats["audio_pkts"] / dt, 1),
        "audio_MBps": round(stats["audio_bytes"] / dt / 1e6, 2),
        "wf_pkts_per_s": round(stats["wf_pkts"] / dt, 1),
        "wf_MBps": round(stats["wf_bytes"] / dt / 1e6, 2),
        "errors": stats["audio_errors"] + stats["wf_errors"],
        "rds_frames": stats["rds_frames"],
        "rds_synced": stats["rds_synced"],
        "retunes": stats["retunes"],
        "reconnects": stats["reconnects"],
        "closed": stats["audio_closed"] + stats["wf_closed"],
        "decoded_audio_samples": stats["decoded_audio_samples"],
        "decoded_wf_rows": stats["decoded_wf_rows"],
        "decode_errors": stats["decode_errors"],
        "deflate_acks": stats["deflate_acks"],
        "server_metrics": metrics,
        "client_loop_lag_ms": {"p50": percentile(lags, 0.5),
                               "max": max(lags, default=None)},
        "audio_pkts_per_client_per_s": {"min": min(pkts, default=None),
                                        "p50": percentile(pkts, 0.5)},
        "card": card,
        "last_error": stats["last_error"],
    }


def main() -> int:
    args = parser().parse_args()
    card = None
    if args.device == "cuda":
        from phantomsdr_tpu_torch.bench import card_line

        card = card_line()
        if card is None:
            print("torch_stress: nvidia-smi lists no card; pass --device "
                  "cpu for a server on the CPU", file=sys.stderr)
            return 2
    print(json.dumps(asyncio.run(stress(args, card)), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
