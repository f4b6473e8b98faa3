"""latency_p95_ms: the 95th percentile, over the blocks the source handed
out in the traced window outside the profiled part, of the time from
hand-out to the block's outputs reaching the consumer: the wait in the
driver's queue, the step and the step in flight.  The closed loop holds
the driver at capacity, with its queue full, so the tail follows the
step period and its jitter.  Layer: driver.  Moves: msps."""

import numpy as np

NAME, UNIT, LAYER, MOVES = "latency_p95_ms", "ms", "driver", "msps"


def read(rec):
    if not rec.latency_s:
        return None
    return float(np.percentile(np.asarray(rec.latency_s) * 1e3, 95))
