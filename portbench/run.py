"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``relp_tpu_torch``.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared beside its limit); the numbers compared
are also the last lines of standard error.  Exits 2 without a result when
the machine lacks the cards the cell asks for, 3 when a JAX module is
loaded once the window has closed, and 1 on any other failure.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import harness

    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               t_start=T_START)
    except harness.NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    found = harness.refused_modules()
    if found:
        print(f"portbench: modules loaded that the port must not load: {found}",
              file=sys.stderr)
        return 3
    for name, check in out["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
