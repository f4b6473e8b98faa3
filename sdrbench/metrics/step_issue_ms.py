"""step_issue_ms: host milliseconds a step in ``HopPipeline.step`` (the
host's issue of the step's work), total over the counted steps of the
traced window.  Layer: hop step.  Moves: msps."""

NAME, UNIT, LAYER, MOVES = "step_issue_ms", "ms", "hop step", "msps"


def read(rec):
    if not rec.steps:
        return None
    return 1e3 * sum(rec.spans["issue"]) / rec.steps
