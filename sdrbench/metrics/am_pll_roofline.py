"""am_pll_roofline: the AM carrier PLL's share of its roofline: the
least time for its bytes and operations (``roofline.am_pll`` over the
channel table's rows and the step's samples) over its mean device time a
launch (the chain kernel and the output kernel) in the trace.  Stage:
K-PLL, ``csrc/pll.cu``; it runs only where an AM listener keeps carrier
sync.  Layer: kernels.  Moves: msps."""

from sdrbench import roofline
from sdrbench.metrics_common import share

NAME, UNIT, LAYER, MOVES = "am_pll_roofline", "%", "kernels", "msps"
# for each kernel a launch runs, the names the profiler gives it
PARTS = [("pll_chain_kernel",), ("pll_output_kernel",)]
LAUNCHER = "pll"


def read(rec):
    if rec.plan is None:
        return None
    p = rec.plan
    least, _ = roofline.least_s(*roofline.am_pll(p.c, p.b * p.half))
    return share(rec, PARTS, least)
