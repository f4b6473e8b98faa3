"""The traced run's records: host spans around the calls into the
driver's layers, and the device's operations from torch.profiler.

Spans are host-clock wrappers that only a traced run installs, around
``DSPDriver._prepare_raw`` (span ``ingest``: ``host_preconvert`` and
``pipeline.to_device``), the driver's ``pipe.step`` (span ``issue``:
the host's issue of one ``HopPipeline.step``) and ``_Fetch.result``
(span ``fetch_wait``: the host blocked on the previous step's outputs).
The profiler records the CUDA activity only (no host operators), over a
short steady part of the window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

SPANS = ("ingest", "issue", "fetch_wait")


@dataclass
class Records:
    """What the per-layer readers read (``sdrbench/metrics/*.py``)."""

    spans: dict                  # span -> [seconds] in the counted steps
    steps: int                   # steps issued in the counted part
    device: list | None = None   # [(name, start_ns, end_ns)] device ops
    window_ns: tuple | None = None   # the profiled interval
    launches: dict = field(default_factory=dict)  # kernel -> launches
    #                              issued in the profiled interval
    plan: object = None          # reference.dsp.Plan of the cell
    table: object = None         # reference.dsp.Table
    due_rows: int = 0            # waterfall rows a step
    card: str = ""               # nvidia-smi name and power limit
    latency_s: list = field(default_factory=list)  # hand-out to sink of
    #                              the window's blocks outside the profile
    dropped: list = field(default_factory=list)  # where the profiler
    #                              kept another count than was launched

    def check_counts(self, parts, launcher: str, edge: int = 2) -> None:
        """Holds the profiler's records of a launcher's kernels (each of
        ``parts`` the names one of its kernels may have) to the launches
        the port counted in the profiled interval, within ``edge``
        launches (one step's worth at each end); a disagreement goes into
        ``dropped``."""
        launches = self.launches.get(launcher)
        if self.device is None or launches is None:
            return
        for names in parts:
            _, count = self.stage(names)
            if abs(count - launches) > edge:
                self.dropped.append(
                    f"the profiler kept {count} records of "
                    f"{'/'.join(names)} for {launches} launches of "
                    f"{launcher}")

    def stage(self, names: tuple[str, ...]):
        """(device seconds of the profiled ops whose name contains one
        of ``names``, their count), or None without a trace."""
        if self.device is None:
            return None
        hit = [(e - s) for n, s, e in self.device
               if any(k in n for k in names)]
        return sum(hit) * 1e-9, len(hit)

    @property
    def busy_s(self) -> float | None:
        """Seconds in which some operation ran on the device, in the
        profiled interval (the union of the ops' intervals)."""
        if self.device is None:
            return None
        return sum(e - s for s, e in merged(self.device, self.window_ns)) \
            * 1e-9

    @property
    def window_s(self) -> float | None:
        if self.window_ns is None:
            return None
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9


def merged(ops, window) -> list[tuple[int, int]]:
    """The device ops' intervals clipped to the window and merged."""
    lo, hi = window
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in ops
                if e > lo and s < hi)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Spans:
    """Host-clock spans of the calls into the driver's layers, each
    (name, start, end) in ``time.perf_counter`` seconds; ``offset_ns``
    maps them onto the profiler's clock (nanoseconds since the epoch)."""

    def __init__(self):
        self.log: list[tuple[str, float, float]] = []
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._undo = []

    def wrap(self, name, fn):
        log = self.log

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                log.append((name, t0, time.perf_counter()))
        return timed

    def install(self, driver, driver_module) -> None:
        driver._prepare_raw = self.wrap("ingest", driver._prepare_raw)
        driver.pipe.step = self.wrap("issue", driver.pipe.step)
        fetch = driver_module._Fetch
        orig = fetch.result
        timed = self.wrap("fetch_wait", orig)
        fetch.result = lambda self_, *a, **kw: timed(self_, *a, **kw)
        self._undo.append(lambda: setattr(fetch, "result", orig))

    def remove(self) -> None:
        for undo in self._undo:
            undo()
        self._undo.clear()

    def counted(self, t0: float, t1: float, skip: tuple[float, float]
                ) -> tuple[dict, int]:
        """Spans that start in [t0, t1) and outside ``skip`` (the
        profiled part): ({span: [seconds]}, steps issued)."""
        out = {k: [] for k in SPANS}
        for name, s, e in self.log:
            if t0 <= s < t1 and not (skip[0] <= s < skip[1]):
                out[name].append(e - s)
        return out, len(out["issue"])

    def label(self, gap: tuple[int, int]) -> str:
        """The span that overlaps a device-idle gap (profiler clock) the
        most, or ``other``."""
        best, name = 0, "other"
        for n, s, e in self.log:
            s_ns = s * 1e9 + self.offset_ns
            e_ns = e * 1e9 + self.offset_ns
            ov = min(e_ns, gap[1]) - max(s_ns, gap[0])
            if ov > best:
                best, name = ov, n
        return name


def device_ops(prof) -> list[tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every CUDA-device record of a stopped
    torch.profiler session."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns()))
    return out


def short(name: str) -> str:
    """A kernel's function name without its signature."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0][:80]


def breakdown(rec: Records, spans: Spans) -> dict:
    """The ten device ops that took most time (seconds over the profiled
    interval) and the ten longest idle gaps, each named by the host span
    it fell in."""
    by = {}
    for n, s, e in rec.device:
        k = short(n)
        by[k] = by.get(k, 0.0) + (e - s) * 1e-9
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    busy = merged(rec.device, rec.window_ns)
    lo, hi = rec.window_ns
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[spans.label(g), (g[1] - g[0]) * 1e-9] for g in gaps[:10]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
