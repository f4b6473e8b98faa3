"""agc_roofline: the AGC stage's share of its roofline: the least time
for its bytes and operations (``roofline.agc`` over the channel table's
rows, the step's samples and the look-ahead window) over its mean device
time a launch in the trace.  Stage: the look-ahead AGC and int16 (K-AGC,
``csrc/agc.cu``).  Layer: kernels.  Moves: msps."""

from sdrbench import roofline
from sdrbench.metrics_common import share

NAME, UNIT, LAYER, MOVES = "agc_roofline", "%", "kernels", "msps"
# for each kernel a launch runs, the names the profiler gives it
PARTS = [("agc_kernel",)]
LAUNCHER = "agc"


def read(rec):
    if rec.plan is None:
        return None
    p = rec.plan
    least, _ = roofline.least_s(*roofline.agc(p.c, p.b * p.half,
                                              p.agc_window))
    return share(rec, PARTS, least)
