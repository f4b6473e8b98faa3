"""The readings the comparison's limits are set from, on the card.

    python -m sdrbench.calibrate --workload <cell> --seeds 12
        --control-seeds 3 --seconds 3 --base-seed <n> --out <file.json>

Runs the cell's whole path (ring, driver, window, comparison) on
``--seeds`` seeds in one process, then ``--control-seeds`` more with
the reference computed in bfloat16 in the program's place, and writes
each run's compared numbers: the lower reading of a number is the
largest that sound runs give, its upper reading the smallest that the
control gives.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    from .harness import run

    ap = argparse.ArgumentParser(prog="python -m sdrbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--base-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    rows = []
    for i in range(args.seeds + args.control_seeds):
        control = i >= args.seeds
        seed = args.base_seed + i
        t0 = time.perf_counter()
        out = run(args.workload, seed, args.seconds, False,
                  t_process=t0, control=control)
        rows.append({"seed": seed, "control": control,
                     "correct": out["correct"],
                     "checks": {k: v["value"]
                                for k, v in out["checks"].items()},
                     "metrics": {k: v["value"]
                                 for k, v in out["metrics"].items()},
                     "run_s": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for k in rows[0]["checks"]:
        prog = [r["checks"][k] for r in rows if not r["control"]]
        ctrl = [r["checks"][k] for r in rows if r["control"]]
        summary[k] = {"lower": max(prog) if prog else None,
                      "upper": min(ctrl) if ctrl else None,
                      "program": prog, "control": ctrl}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload,
                                          "rows": rows,
                                          "summary": summary}, indent=1))
    for k, s in summary.items():
        print(f"{k}: lower {s['lower']} upper {s['upper']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
