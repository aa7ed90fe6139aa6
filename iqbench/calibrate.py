"""Readings for the limits of a cell's check: the numbers ``compare`` gives
for the program against the reference on many seeds, and for the control
(the reference at TF32 in the program's place) on some, and for the
program with a fault of ``faults.py`` planted on some, each seed a fresh
set-up at the cell's own sizes, a window of ``--seconds`` as a run's
(calls back to back until it has passed), in one process:

    python3 iqbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--fault tail_quarter --fault-seeds 1,2,3] \\
        [--seconds 10] [--out readings.jsonl]

Prints one JSON line per seed and side; not part of a benchmark run.
"""
import argparse
import contextlib
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from iqbench import faults, harness
    cell = harness.Cell(args.workload, root)
    harness.prepare_environment(cell.cfg, root)
    import torch
    harness.set_port_precision(cell.cfg)
    out = open(args.out, "a") if args.out else None
    seeds = [("program", int(s)) for s in args.seeds.split(",") if s]
    seeds += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    seeds += [("fault", int(s)) for s in args.fault_seeds.split(",") if s]
    for side, seed in seeds:
        t0 = time.time()
        planted = (faults.plant(args.fault) if side == "fault"
                   else contextlib.nullcontext())
        with planted:
            ctx = harness.Context(cell, seed, torch.device(args.device))
            driver = ctx.driver = cell.driver_class()(ctx)
            driver.warmup()
            deadline = time.perf_counter() + args.seconds
            calls = 0
            while not calls or time.perf_counter() < deadline:
                driver.step()
                calls += 1
            driver.finish()
        driver.release()
        if side == "control":
            got = harness.control_readings(driver)
        else:
            got = harness.readings(driver, lambda s: s["program"])
        line = json.dumps({"workload": args.workload, "side": side,
                           "fault": args.fault if side == "fault" else None,
                           "seed": seed, "calls": calls, "readings": got,
                           "limits": cell.limits,
                           "seconds": time.time() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del driver, ctx
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
