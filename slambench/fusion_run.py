"""Run a cell's configuration with every sensor mode on (ISC loops, the IMU
and wheel guess, GPS altitudes) through the harness on the card: not a cell
of the benchmark, a proof that the harness and its check take that
deployment.

    python3 slambench/fusion_run.py --workload sim_circuit_sc.laps --seed <n> --seconds 51

From the root of a checkout on a machine with a card. Prints the check's
numbers beside the cell's limits (a number without one is read and not
compared), the program's counters over the window (the guess kernel's
launches among them), the session's counts and `correct`, as one JSON
object on the last line of standard output. Exits with 1 where the run is
not correct, 2 without a card, and 3, printing no result, where a JAX
module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the program's four modes, and the feeds' noise as run-sim gives it
# (`cli._sim_feeds`: gyro 0.002 rad/s and accel 0.05 m/s^2, wheel 0.03 m/s
# and 0.002 rad/s, altimeter 0.5 m with 20 % dropouts)
FUSION = {"loop.method": "isc", "odom.use_imu": True, "odom.use_odom": True,
          "pgo.use_gps": True}
SENSOR = {"imu": {"gyro_noise": 0.002, "accel_noise": 0.05},
          "wheel": {"vel_noise": 0.03, "gyro_noise": 0.002},
          "gps": {"alt_noise_m": 0.5, "dropout_share": 0.2}}


def fusion_config(config: dict) -> dict:
    """A copy of a configuration with the four modes on and their feeds'
    noise stated."""
    cfg = copy.deepcopy(config)
    cfg["program"].update(FUSION)
    cfg["sensor"].update(copy.deepcopy(SENSOR))
    return cfg


def fusion_run(workload: str, seed: int, seconds: float, t_start: float, log=print) -> dict:
    """One run of `workload` with the four modes on; the harness's output
    and a summary of what the check and the program read."""
    from slambench import harness

    cell = harness.load_cell(workload)
    cell.config = fusion_config(cell.config)
    out = harness.run(cell, seed, seconds, False, t_start, log=log)
    v = out["verdict"]
    c0, c1 = out["ctx"]["counters"]
    return {"correct": v["correct"],
            "numbers": {k: [x["value"], x["limit"]] for k, x in v["numbers"].items()},
            "read_not_compared": {k: v["info"][k] for k in ("gps_mismatch", "ate_m")
                                  if k in v["info"]},
            "counts": v["counts"], "gps_keyframes": v["info"].get("gps_keyframes"),
            "detections_replayed": v["info"]["detections"], "icp_runs": v["info"]["icp_runs"],
            "counters": {k: c1[k] - c0[k] for k in c0},
            "metrics": out["result"]["metrics"], "device": out["result"]["device"],
            "check_seconds": v["seconds"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="sim_circuit_sc.laps")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fusion_run: no CUDA device", file=sys.stderr)
        return 2
    summary = fusion_run(args.workload, args.seed, args.seconds, T_START,
                         log=lambda m: print(m, file=sys.stderr, flush=True))
    from slambench import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"fusion_run: the process loaded {bad}: the run is of the port alone",
              file=sys.stderr)
        return 3
    print(json.dumps(summary), flush=True)
    return 0 if summary["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
