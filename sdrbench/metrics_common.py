"""What the per-layer readers share: a stage's share of its roofline
from the traced run's records."""

from __future__ import annotations


def share(rec, parts: list, least_s: float):
    """100 * least time / the stage's mean device time a launch.

    ``parts``: for each kernel one launch runs, the names the profiler
    gives it (any one matching).  None where the trace holds no record
    of a part (the stage did not run), or where the profiler dropped
    records (``Records.dropped``: then no device figure is reported)."""
    if rec.device is None or rec.dropped:
        return None
    per_launch = 0.0
    for names in parts:
        secs, count = rec.stage(names)
        if not count:
            return None
        per_launch += secs / count
    return 100.0 * least_s / per_launch
