"""waterfall_roofline: the waterfall stage's share of its roofline: the
least time for its bytes and operations (``roofline.waterfall`` on the
step's due rows) over its mean device time a launch in the trace.
Stage: the power, roll and int8 pyramid of the due hops (K-WF,
``csrc/waterfall.cu``).  Layer: kernels.  Moves: msps."""

from sdrbench import roofline
from sdrbench.metrics_common import share

NAME, UNIT, LAYER, MOVES = "waterfall_roofline", "%", "kernels", "msps"
# for each kernel a launch runs, the names the profiler gives it
PARTS = [("chunk_pyramid_kernel", "tile_pyramid_kernel")]
LAUNCHER = "waterfall"


def read(rec):
    if rec.plan is None or not rec.due_rows:
        return None
    p = rec.plan
    least, _ = roofline.least_s(*roofline.waterfall(rec.due_rows, p.r,
                                                    p.levels))
    return share(rec, PARTS, least)
