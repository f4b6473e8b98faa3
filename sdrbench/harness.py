"""One run of one cell: the port's ``DSPDriver`` fed fresh blocks.

Set-up makes the cell's ring of raw blocks from the seed (on the device,
then copied to pageable host memory, where a pipe read leaves samples),
puts its listeners and waterfall views into the port's
``ChannelRegistry`` and ``WaterfallRegistry`` and starts the driver
(reader thread, bounded queue, device loop) with a ring source and a
recording sink.  The window opens once the driver has warmed up and
delivered ``steady_steps`` steps, and lasts ``--seconds``:

- ``msps``: input samples (IQ pairs, or reals) of every block whose
  outputs reached the sink inside the window, over the window's length;
- ``setup_s``: from the process's start to the window's opening.

Every block the source hands out inside the window is waited for (what
is in flight when it closes too); its latency is the time from hand-out
to its outputs reaching the sink, queue wait included.  Their median
and 95th percentile go to standard error; in the traced run the 95th
percentile is the per-layer metric ``latency_p95_ms``.

A block is failed if its outputs never come, or a device error was
counted.  After the window, the reference works out again the steps the
comparison samples (``compare.py``) and each number is printed beside
its limit.  With ``--trace 1`` the run reads the cell's per-layer
metrics instead of its end-to-end ones (``trace.py``,
``sdrbench/metrics/``).
"""

from __future__ import annotations

import json
import math
import os
import resource
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import compare, guard, spec, trace, traffic
from .reference import dsp

ROOT = Path(__file__).resolve().parent.parent


class RunError(RuntimeError):
    """A run that prints no result."""


class RingSource:
    """``SampleSource``'s face over a ring of distinct blocks: hands out
    the next block, halo included, as a fresh contiguous writable view,
    and stamps the hand-out; returns None (end of stream) once the
    window has closed."""

    def __init__(self, p: dsp.Plan, blocks: list[np.ndarray]):
        self.dtype = blocks[0].dtype
        self.wire_per_hop = p.wire_per_hop
        self.block_wire = p.b * p.wire_per_hop
        self.include_halo = True
        self.blocks = blocks
        self.handed: list[float] = []
        self.close_at = math.inf
        self.ended = False
        self._ids: dict[int, tuple[int, np.ndarray]] = {}
        self._lock = threading.Lock()

    def read_block(self) -> np.ndarray | None:
        if time.perf_counter() >= self.close_at:
            self.ended = True
            return None
        seq = len(self.handed)
        view = self.blocks[seq % len(self.blocks)][:]
        with self._lock:
            self._ids[id(view)] = (seq, view)
        self.handed.append(time.perf_counter())
        return view

    def seq_of(self, block) -> int | None:
        with self._lock:
            got = self._ids.pop(id(block), None)
        return None if got is None else got[0]


class Sink:
    """The driver's consumer: the time each step's outputs arrive, and a
    copy of the outputs of the steps the comparison may read."""

    def __init__(self, hops: int, keep):
        self.hops = hops
        self.keep = keep
        self.recv: dict[int, float] = {}
        self.kept: dict[int, tuple] = {}
        self.cond = threading.Condition()

    def __call__(self, frame0, audio, pwr, wf, due, wf_meta, audio_meta,
                 rds):
        t = time.perf_counter()
        seq = frame0 // self.hops
        if self.keep(seq):
            self.kept[seq] = (np.array(audio), np.array(pwr),
                              None if wf is None else np.array(wf),
                              list(due))
        with self.cond:
            self.recv[seq] = t
            self.cond.notify_all()

    def wait(self, pred, timeout: float) -> bool:
        with self.cond:
            return self.cond.wait_for(pred, timeout)


def _clone(x):
    """A copy of a state: its tensors cloned (on their stream, so the copy
    holds what the work queued before it leaves there), the rest as is."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


class Capture:
    """Keeps a copy of the program's carries going into the steps the
    comparison samples, so the reference can follow the stream from
    there: the raw tensor ``_prepare_raw`` returns for a sampled block is
    matched to the ``pipe.step`` call it feeds.  The wrappers stay on the
    timed path in every run (a dictionary look-up a step; a clone of the
    carries for the sampled steps only), so a step that writes its
    carries in place is judged alike."""

    def __init__(self, driver, source: RingSource, want):
        self.states: dict[int, object] = {}
        raw_seq: dict[int, int] = {}
        prepare, step = driver._prepare_raw, driver.pipe.step

        def prepare_raw(block):
            seq = source.seq_of(block)
            raw = prepare(block)
            if seq is not None and want(seq):
                raw_seq[id(raw)] = seq
            return raw

        def pipe_step(state, raw, *a, **kw):
            seq = raw_seq.pop(id(raw), None)
            if seq is not None:
                self.states[seq] = _clone(state)
            return step(state, raw, *a, **kw)

        driver._prepare_raw = prepare_raw
        driver.pipe.step = pipe_step


def _thread_cpu() -> dict[str, float]:
    """CPU seconds of the driver's threads so far, by name."""
    out = {}
    for t in threading.enumerate():
        if t.name in ("sdr-reader", "dsp-step") and t.ident is not None:
            try:
                out[t.name] = time.clock_gettime(
                    time.pthread_getcpuclockid(t.ident))
            except OSError:
                pass
    return out


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no card"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def log(*a) -> None:
    print("#", *a, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace_on: bool, *,
        root: Path = ROOT, device: str = "cuda", t_process: float = 0.0,
        fault=None, control: bool = False) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``device="cpu"`` drives the port's plain versions (the tests);
    ``fault(driver)`` may break the timed path underneath (the tests);
    ``control`` compares the reference in bfloat16 in the program's place
    (the limits' upper readings, ``calibrate.py``)."""
    import torch

    marks = {"import torch": time.perf_counter()}
    seed = int(seed) % (1 << 63)     # any whole number: a valid seed
    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.ops.cuda import all_kernels
    from phantomsdr_tpu_torch.runtime import driver as driver_mod
    from phantomsdr_tpu_torch.runtime.registry import (
        ChannelRegistry, WaterfallRegistry,
    )

    bad = guard.check_program_location(ROOT)
    if bad:
        raise RunError(bad)
    faults = guard.check_sources(root / "sdrbench")
    if faults:
        raise RunError("; ".join(faults))
    cell = spec.cell(root, workload)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if on_card and cards < cell.chips:
        raise RunError(f"{workload} needs {cell.chips} CUDA card(s); "
                       f"found {cards}")
    if on_card:
        torch.zeros(1, device=dev)      # the CUDA context
    marks["the program, CUDA"] = time.perf_counter()
    card = card_line() if on_card else "cpu"
    marks["nvidia-smi"] = time.perf_counter()
    kernels = all_kernels()
    cold = [k.name for k in kernels if on_card and not k.lib_path().exists()]

    p = dsp.plan(cell.server_config)
    cfg = config_from_dict(cell.server_config)
    mix = cell.mix
    if mix.get("loop", "closed") != "closed":
        raise RunError(f"loop {mix['loop']!r}: only closed loops run")
    table = traffic.listener_table(p, mix)
    views = traffic.view_table(p, mix)
    t0 = time.perf_counter()
    blocks = traffic.make_ring(p, mix, table, seed, dev)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ring_s = time.perf_counter() - t0
    marks["the ring"] = time.perf_counter()

    chans = ChannelRegistry(cfg)
    wfs = WaterfallRegistry(cfg, p.level_offsets())
    traffic.place(p, table, views, chans, wfs)

    chk = mix["check"]
    rng = np.random.default_rng(seed)
    stride = int(chk["stride"])
    phase = int(rng.integers(stride))
    steady = int(mix["window"]["steady_steps"])
    start_steps = int(chk["start_steps"])

    def candidate(seq: int) -> bool:
        return seq >= steady and (seq - phase) % stride == 0

    def keep(seq: int) -> bool:
        return seq < start_steps or candidate(seq) or candidate(seq - 1)

    source = RingSource(p, blocks)
    sink = Sink(p.b, keep)
    drv = driver_mod.DSPDriver(cfg, source, chans, sink,
                               waterfall_registry=wfs, device=dev)
    spans = None
    if trace_on:
        spans = trace.Spans()
        spans.install(drv, driver_mod)
    cap = Capture(drv, source, candidate)
    if fault is not None:
        fault(drv)

    watched = {k.name: k for k in kernels}
    prof = None
    if trace_on and on_card:
        # the profiler starts warming up here: its first start on a card
        # takes seconds (CUPTI), which must not fall inside the window
        from torch.profiler import ProfilerActivity, profile, schedule

        prof = profile(activities=[ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1))
        prof.start()
    marks["registries, driver, profiler"] = time.perf_counter()
    drv.start()
    try:
        if not sink.wait(lambda: len(sink.recv) >= steady
                         or drv.metrics.device_errors, 1200):
            raise RunError(f"no {steady} steps within 1200 s")
        if drv.metrics.device_errors:
            raise RunError(f"device error before the window: "
                           f"{drv.metrics.last_device_error}")
        t_w0 = time.perf_counter()
        t_w1 = t_w0 + seconds
        use0 = resource.getrusage(resource.RUSAGE_SELF)
        cpu0 = _thread_cpu()
        source.close_at = t_w1
        setup_s = t_w0 - t_process
        marks[f"warm-up and {steady} steps"] = t_w0
        prof_iv = (t_w1, t_w1)
        rec = None
        if trace_on:
            rec, prof_iv = _profile(dev, prof, spans, t_w0, seconds,
                                    watched)
        time.sleep(max(0.0, t_w1 - time.perf_counter()))
        use1 = resource.getrusage(resource.RUSAGE_SELF)
        cpu1 = _thread_cpu()
        # what is in flight when the window closes is waited for
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and not (
                source.ended and all(s in sink.recv
                                     for s in range(len(source.handed)))):
            time.sleep(0.005)
    finally:
        drv.stop()
        if spans is not None:
            spans.remove()
    device_errors = drv.metrics.device_errors
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    attempted = [s for s, t in enumerate(source.handed) if t_w0 <= t < t_w1]
    lat = [sink.recv[s] - source.handed[s] for s in attempted
           if s in sink.recv]
    missing = len(attempted) - len(lat)
    done = sum(1 for t in sink.recv.values() if t_w0 <= t <= t_w1)
    msps = done * p.b * p.hop / seconds / 1e6
    lat_ms = np.asarray(lat) * 1e3
    p95 = float(np.percentile(lat_ms, 95)) if lat else math.inf
    log(f"{workload} seed {seed}: {len(attempted)} blocks attempted, "
        f"{done} delivered in the {seconds} s window, {missing} never "
        f"came, device errors {device_errors}; latency median "
        f"{float(np.median(lat_ms)) if lat else math.inf:.3f} ms, p95 "
        f"{p95:.3f} ms over {len(lat)} blocks; {msps:.3f} MSPS")
    log(f"host in the window: {use1.ru_utime - use0.ru_utime:.3f} s user "
        f"+ {use1.ru_stime - use0.ru_stime:.3f} s system CPU on "
        f"{os.cpu_count()} cores, {torch.get_num_threads()} torch threads; "
        + ", ".join(f"thread {k} on a core {100 * (cpu1[k] - v) / seconds:.1f}%"
                    " of the window" for k, v in cpu0.items() if k in cpu1))
    per_s = np.histogram([t for t in sink.recv.values() if t_w0 <= t <= t_w1],
                         bins=max(1, int(seconds)), range=(t_w0, t_w1))[0]
    log("steps delivered in each part of the window: "
        + " ".join(str(int(c)) for c in per_s))
    prev, parts = t_process, []
    for name, t in marks.items():
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    log("set-up parts (s): " + ", ".join(parts))
    log(f"set-up {setup_s:.3f} s (ring of {len(blocks)} blocks "
        f"{ring_s:.3f} s; kernels built this run: "
        f"{', '.join(cold) if cold else 'none, all cached'}); "
        f"device peak {peak} bytes; {card}")

    del drv
    if on_card:
        torch.cuda.empty_cache()

    # ---- the comparison, once the window has closed
    in_window = set(attempted)
    sel = [s for s in attempted if candidate(s) and s + 1 in in_window
           and s in sink.kept and s + 1 in sink.kept]
    samples = sorted(rng.choice(sel, min(int(chk["samples"]), len(sel)),
                                replace=False).tolist()) if sel else []
    t0 = time.perf_counter()
    checks = compare.run(p, table, views, blocks, sink.kept, cap.states,
                         start_steps, samples, cell.limits, dev,
                         control=control)
    if len(samples) < int(chk["samples"]):
        checks["sampled_pairs"] = {"value": len(samples),
                                   "limit": int(chk["samples"]),
                                   "at_least": True}
    log(f"compared steps 0-{start_steps - 1} and pairs at {samples} in "
        f"{time.perf_counter() - t0:.3f} s")
    ok = compare.passed(checks)
    failed = missing + device_errors + (0 if ok else 1)
    correct = ok and missing == 0 and device_errors == 0

    metrics, breakdown = {}, None
    if trace_on:
        rec.latency_s = [sink.recv[s] - source.handed[s] for s in attempted
                         if s in sink.recv and not (
                             prof_iv[0] <= source.handed[s] < prof_iv[1])]
        metrics, breakdown = _per_layer(root, cell, rec, spans, table, p,
                                        t_w0, t_w1, prof_iv, card)
        after = sum(1 for t in sink.recv.values() if prof_iv[1] <= t <= t_w1)
        span = max(t_w1 - prof_iv[1], 1e-9)
        log(f"traced run: {msps:.3f} MSPS over the window, "
            f"{after * p.b * p.hop / span / 1e6:.3f} MSPS over the "
            f"{span:.3f} s after the profiler (where the spans are "
            f"counted), latency p95 {p95:.3f} ms")
    else:
        for m in cell.end_to_end:
            v = {"msps": msps, "setup_s": setup_s}[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    found = guard.banned_loaded()
    if found:
        raise RunError(f"loaded after the window: {', '.join(found)}")
    dev_line = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                "count": cell.chips if on_card else 0,
                "memory_peak_bytes": int(peak)}
    if trace_on and rec is not None and rec.device is not None \
            and not rec.dropped:
        dev_line["busy_s"] = rec.busy_s
        dev_line["window_s"] = rec.window_s
    for name, c in checks.items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name} {c['value']} (limit {rel} {c['limit']})",
              file=sys.stderr)
    out = {"correct": bool(correct), "attempted": len(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev_line}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def _profile(dev, prof, spans, t_w0: float, seconds: float, watched: dict):
    """torch.profiler's CUDA records over a steady part of the window
    (from 10% of it, for 15% of it, at most 1.5 s) and the launches the
    port's kernels counted meanwhile; returns them with the interval the
    spans leave out: the window up to 0.2 s after the profiler stopped
    (its warm-up slows the host's launches, and its stop processes the
    records)."""
    import torch

    rec = trace.Records(spans={}, steps=0)
    if prof is None:
        return rec, (t_w0 - 1.0, t_w0 - 1.0)
    time.sleep(max(0.0, t_w0 + 0.1 * seconds - time.perf_counter()))
    n0 = {k: v.launches for k, v in watched.items()}
    prof.step()                      # warm-up -> recording
    p0 = time.perf_counter()
    time.sleep(min(1.5, 0.15 * seconds))
    torch.cuda.synchronize(dev)
    p1 = time.perf_counter()
    prof.stop()
    rec.launches = {k: v.launches - n0[k] for k, v in watched.items()}
    rec.device = trace.device_ops(prof)
    off = spans.offset_ns
    rec.window_ns = (int(p0 * 1e9 + off), int(p1 * 1e9 + off))
    return rec, (t_w0 - 1.0, time.perf_counter() + 0.2)


def _per_layer(root, cell, rec, spans, table, p, t_w0, t_w1, prof_iv,
               card):
    rec.spans, rec.steps = spans.counted(t_w0, t_w1, prof_iv)
    rec.plan, rec.table, rec.card = p, table, card
    rec.due_rows = len(dsp.due_rows(p, 0))
    mods = [(m, spec.metric_module(root, m["name"])) for m in cell.per_layer]
    for _, mod in mods:
        if hasattr(mod, "PARTS") and hasattr(mod, "LAUNCHER"):
            rec.check_counts(mod.PARTS, mod.LAUNCHER)
    for note in rec.dropped:
        log(f"{note}: no device figure is reported")
    metrics = {}
    for m, mod in mods:
        v = mod.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if rec.device is None:
        return metrics, None
    bd = trace.breakdown(rec, spans)
    log(f"profiled {rec.window_s:.3f} s: device busy {rec.busy_s:.4f} s; "
        f"launches {json.dumps(rec.launches)}; {card}")
    return metrics, bd
