"""Run one cell of the benchmark of xchu_slam_tpu_torch's device engine.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. Prints the
check's numbers beside their limits as the last lines of standard error and
one JSON object as the last line of standard output. Exits with a code other
than 0, printing no result, without CUDA or with fewer cards than the cell
asks for, or where a JAX module was loaded. Nothing heavy is imported at
the top: the lap's spawned render workers import this file again.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also judge the reference's lower-precision control "
                         "(the control tool's runs; the benchmark's runs do not)")
    args = ap.parse_args(argv)

    from slambench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: the cell {cell.name} needs {cell.chips} CUDA device(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                      check_mode="control" if args.control else "program", log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"slambench: the process loaded {bad}: the benchmark runs the port alone")
        return 3
    verdict = out["verdict"]
    if "control" in verdict:
        log("control " + json.dumps(verdict["control"]))
    log(f"check: correct={verdict['correct']} in {verdict['seconds']:.2f} s "
        f"{json.dumps(verdict['info'])} {json.dumps(verdict['counts'])}")
    for name, item in verdict["numbers"].items():     # the last lines: number, limit
        log(f"check {name}: {item['value']!r} limit {item['limit']!r}"
            f"{'' if item['ok'] else '  FAILED'}")
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
