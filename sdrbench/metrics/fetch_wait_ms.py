"""fetch_wait_ms: host milliseconds a step blocked in ``_Fetch.result``
on the previous step's outputs (large: the device paces the loop;
small: the host does), total over the counted steps of the traced
window.  Layer: driver.  Moves: msps."""

NAME, UNIT, LAYER, MOVES = "fetch_wait_ms", "ms", "driver", "msps"


def read(rec):
    if not rec.steps or "fetch_wait" not in rec.spans:
        return None
    return 1e3 * sum(rec.spans["fetch_wait"]) / rec.steps
