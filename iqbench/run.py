"""Run one cell of the benchmark once, from the root of a checkout:

    python3 iqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result, one JSON object; the
numbers the check compared, each beside its limit, are the last lines of
standard error.  Exits with another code than 0, and prints no result,
without a CUDA card, with fewer cards than the cell asks for, or where
modules of JAX or the JAX package were loaded.
"""
import argparse
import json
import os
import sys
import time


def process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - started / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    start = time.monotonic() - process_age()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from iqbench.harness import run_cell
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      start, root=root)
    for name, v in result["check"].items():
        value = "not finite" if v["value"] is None else repr(v["value"])
        print(f"check {name}: {value} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
