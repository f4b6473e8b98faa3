"""``python -m sdrbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on the CUDA card of this machine.

Prints the run's figures on standard error, the compared numbers beside
their limits last, and one JSON line on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and ``checks``.  Without a card (or with fewer cards
than the cell asks for), or when the port or a forbidden module cannot
be held apart, it prints no result and exits with 2.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sdrbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from .harness import RunError, run

    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  t_process=T_PROCESS)
    except (RunError, ModuleNotFoundError, FileNotFoundError,
            KeyError) as e:
        print(f"sdrbench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
