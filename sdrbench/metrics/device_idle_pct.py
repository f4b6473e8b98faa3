"""device_idle_pct: the share of the profiled interval in which no
operation ran on the card (torch.profiler's CUDA records, their union).
None where the profiler dropped records of the port's kernels
(``Records.dropped``): an interval with records missing reads idle.
Layer: device.  Moves: msps."""

NAME, UNIT, LAYER, MOVES = "device_idle_pct", "%", "device", "msps"


def read(rec):
    if rec.device is None or rec.dropped or not rec.window_s:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
