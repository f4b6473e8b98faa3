"""Host-side ingest bench of the PyTorch port: can the host side of the
ingest chain -- pipe read, halo concat, preconvert view, pinned copy,
host-to-device copy, dispatch -- sustain 35 MSPS of u8 IQ (70 MB/s of
wire bytes)?

The counterpart of tools/ingest_bench.py, with its legs and JSON, on the
port's own reader and upload at the north-star block shape:

- ``read``: a writer thread feeds an OS pipe as fast as the reader
  drains it (tools/torch_clients.feed_pipe); the port's
  ``SampleSource.read_block`` (blocking read, np.frombuffer, halo
  concat) consumes blocks.
- ``upload``: ``host_preconvert`` plus the port's real upload,
  ``pipeline.to_device`` (a pinned copy, then a non-blocking copy to
  the card), fenced by a CUDA event a block.
- ``upload_split``: the legs the port's upload adds to the JAX side's,
  in ms a block: the halo concat and the pinned copy (host clock) and
  the host-to-device copy alone (CUDA events; null on the CPU, where
  ``to_device`` copies nothing).
- ``overlap``: the driver's structure (runtime/driver.py): a reader
  thread, a ``queue.Queue(maxsize=3)``, then prepare, upload and a
  trivial step that touches every byte, its result fetched as the
  driver fetches a step's (pinned, fenced by an event), with one step
  in flight.  The number bounds ingest, not compute.

``meets_target`` is the overlap leg at 35 MSPS or more.  Runs on the
card (``--device cuda``, the default; it fails without one) and writes
build/ingest/INGEST_torch.json; ``--device cpu`` runs the same legs on
the CPU, where the times say nothing about a card.

Run:  python tools/torch_ingest_bench.py [--device cuda] [--blocks 40]
          [--hop-batch 18] [--fft-log2 20] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

WIRE_MBPS_TARGET = 70.0     # 35 MSPS IQ * 2 u8 scalars
MSPS_TARGET = 35.0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--hop-batch", type=int, default=18)
    ap.add_argument("--fft-log2", type=int, default=20)
    ap.add_argument("--blocks", type=int, default=40)
    ap.add_argument("--out",
                    default=str(REPO / "build" / "ingest" /
                                "INGEST_torch.json"))
    return ap


def bench(args) -> dict:
    import torch

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.ops.convert import host_preconvert
    from phantomsdr_tpu_torch.pipeline import to_device
    from phantomsdr_tpu_torch.runtime.driver import SampleSource, _Fetch
    from tools.torch_clients import feed_pipe, seeded_pool
    from phantomsdr_tpu_torch.bench import card_line

    cfg = config_from_dict({
        "input": {
            "sps": 35_000_000, "frequency": 100_000_000,
            "fft_size": 1 << args.fft_log2, "signal": "iq",
            "audio_sps": 12000, "waterfall_size": 1024,
            "driver": {"format": "u8"},
        },
        "tpu": {"hop_batch": args.hop_batch, "max_channels": 128},
    })
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    n = args.blocks
    block_bytes = cfg.hop_batch * cfg.hop_size * 2
    samples_per_block = block_bytes / 2  # IQ pairs
    pool = seeded_pool(block_bytes, 0)
    results = {
        "config": {"platform": args.device,
                   "device": (torch.cuda.get_device_name(0) if on_card
                              else "cpu"),
                   "hop_batch": cfg.hop_batch,
                   "fft_size": cfg.fft_size, "format": "u8 iq",
                   "blocks": n},
        "targets": {"wire_mbps": WIRE_MBPS_TARGET, "msps": MSPS_TARGET},
        "card": card_line() if on_card else None,
    }

    def rate(dt, blocks):
        return {"mbps": round(blocks * block_bytes / dt / 1e6, 1),
                "msps": round(blocks * samples_per_block / dt / 1e6, 1),
                # 3 significant figures: a small block on a fast host
                # takes a few microseconds, which 2 decimals read as 0
                "ms_per_block": float(f"{dt / blocks * 1e3:.3g}")}

    # ---- leg 1: pipe read + frombuffer + halo concat ----
    stream, feeder = feed_pipe(pool, None)
    try:
        src = SampleSource(cfg, stream)
        src.read_block()                       # warm allocators
        t0 = time.monotonic()
        for _ in range(n):
            if src.read_block() is None:
                raise RuntimeError("read: the pipe ended early")
        results["read"] = rate(time.monotonic() - t0, n)
        blk = src.read_block()
    finally:
        stream.close()                         # ends the feeder
        feeder.stop()

    # ---- leg 2: preconvert + the port's upload + a fence a block ----
    x = to_device(host_preconvert(blk, "u8"), None, dev)
    if on_card:
        torch.cuda.synchronize(dev)            # warm the pinned pool
    t0 = time.monotonic()
    for _ in range(n):
        x = to_device(host_preconvert(blk, "u8"), None, dev)
        if on_card:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
    results["upload"] = rate(time.monotonic() - t0, n)
    del x

    # ---- the upload's legs, each alone ----
    halo = blk[:src.wire_per_hop].copy()
    new = blk[src.wire_per_hop:]
    t0 = time.perf_counter()
    for _ in range(n):
        cat = np.concatenate([halo, new])
    concat_ms = (time.perf_counter() - t0) / n * 1e3
    pinned_ms = h2d_ms = None
    if on_card:
        host = torch.from_numpy(cat)
        host.pin_memory()                      # warm the pinned pool
        t0 = time.perf_counter()
        for _ in range(n):
            pinned = host.pin_memory()
        pinned_ms = (time.perf_counter() - t0) / n * 1e3
        d = pinned.to(dev, non_blocking=True)
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(n):
            d.copy_(pinned, non_blocking=True)
        end.record()
        end.synchronize()
        h2d_ms = start.elapsed_time(end) / n
        del d, pinned
    results["upload_split"] = {"halo_concat_ms": round(concat_ms, 3),
                               "pinned_copy_ms": pinned_ms
                               and round(pinned_ms, 3),
                               "h2d_ms": h2d_ms and round(h2d_ms, 3)}

    # ---- leg 3: the driver's overlap with a trivial step ----
    def tiny_step(raw):
        # touches every input byte once (the cheapest honest "step"),
        # so nothing can skip the upload
        return _Fetch(torch.sum(raw, dtype=torch.int32).reshape(1))

    stream, feeder = feed_pipe(pool, None)
    q: queue.Queue = queue.Queue(maxsize=3)
    src = SampleSource(cfg, stream)

    def read_loop():
        for _ in range(n + 1):
            q.put(src.read_block())
        q.put(None)

    rt = threading.Thread(target=read_loop, daemon=True)
    try:
        rt.start()
        first = q.get()
        tiny_step(to_device(host_preconvert(first, "u8"), None,
                            dev)).result()     # warm
        done = 0
        pending = None
        t0 = time.monotonic()
        while (b := q.get()) is not None:
            cur = tiny_step(to_device(host_preconvert(b, "u8"), None, dev))
            if pending is not None:            # one step in flight, like
                pending.result()               # the driver's flush
                done += 1
            pending = cur
        if pending is not None:
            pending.result()
            done += 1
        results["overlap"] = rate(time.monotonic() - t0, done)
        rt.join(timeout=10)
    finally:
        stream.close()
        feeder.stop()
    results["meets_target"] = bool(
        results["overlap"]["msps"] >= MSPS_TARGET)
    return results


def main() -> int:
    args = parser().parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_ingest_bench: no CUDA device; pass --device cpu",
                  file=sys.stderr)
            return 2
    results = bench(args)
    out = json.dumps(results, indent=1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
