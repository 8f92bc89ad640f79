"""The readings behind the limits of ``correct``: for each seed, one run of
a cell (a short window), the numbers compared for the program and for the
control, the plain reference in a lower precision put in the program's
place (the cell's ``control``), on the same LPs.

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds 1 2 3

One JSON line a seed.  The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)

    from portbench import harness

    registry = harness.Registry()
    control = registry.cell(args.workload)["control"]
    for seed in args.seeds:
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               t_start=time.perf_counter(), registry=registry,
                               also_controls=(control,))
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "program": {k: c["value"] for k, c in out["checks"].items()},
                          "control": {"precision": control, **out["controls"][control]},
                          "device": out["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
