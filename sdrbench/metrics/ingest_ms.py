"""ingest_ms: host milliseconds a step in ``DSPDriver._prepare_raw``
(``host_preconvert`` and ``pipeline.to_device``: the pinned copy of the
fresh block and its upload), total over the counted steps of the traced
window.  Layer: driver.  Moves: msps."""

NAME, UNIT, LAYER, MOVES = "ingest_ms", "ms", "driver", "msps"


def read(rec):
    if not rec.steps or not rec.spans.get("ingest"):
        return None
    return 1e3 * sum(rec.spans["ingest"]) / rec.steps
