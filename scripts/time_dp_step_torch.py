#!/usr/bin/env python3
"""Time the port's data-parallel train step against the single step on
the card.

    python3 scripts/time_dp_step_torch.py [--models pointnet,pointconv,gcnn]
        [--backend nccl|gloo] [--world W] [--steps S]

Spawns W ranks on the first card (NCCL takes one rank a card, so W = 1
there; gloo takes any W) and, per family at batch 32 and 1024 points from
seeded weights, times S steps after two warm-up steps, host clock between
CUDA synchronisations: ``trainer.make_train_step`` on the whole batch
(world 1 only), ``make_dp_train_step``, and the replicas' checksum
(``assert_replicated``) alone.  Then ``torch.profiler`` over two DP steps:
per step, the count and host milliseconds of the all-reduces
(``c10d::allreduce_``) and of their autograd nodes, and the device's
busy milliseconds.  Prints one JSON line per family, then one with the
card's name and power limit as nvidia-smi prints them.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH, POINTS = 32, 1024


def host_ms(run, steps):
    """Mean host ms of run() over ``steps`` calls after two warm-ups."""
    import torch
    run()
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def profile_dp(step):
    """Per DP step: all-reduce count and host ms, autograd nodes' host ms,
    device busy ms (kernels' summed time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    events = {e.key: e for e in prof.key_averages()}

    def ms(key):
        return events[key].cpu_time_total / 2e3 if key in events else 0.0
    return {"allreduce_calls": events["c10d::allreduce_"].count / 2
            if "c10d::allreduce_" in events else 0,
            "allreduce_host_ms": ms("c10d::allreduce_"),
            "forward_node_host_ms": ms("AllReduceSum"),
            "backward_node_host_ms": ms("AllReduceSumBackward"),
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in events.values()
                                  if e.device_type == DeviceType.CUDA) / 2e3}


def rank(group, models, steps):
    import numpy as np
    import torch
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.models import build_model
    from interpret_quality_tpu_torch.parallel import (assert_replicated,
                                                      make_dp_train_step)
    from interpret_quality_tpu_torch.train.trainer import (make_optimizer,
                                                           make_train_step)
    dev = group.device
    ds = SyntheticClouds(BATCH, POINTS, 10, seed=7)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(BATCH)])).to(dev)
    y = torch.tensor([ds[i][1] for i in range(BATCH)]).to(dev)
    out = {}
    for name in models:
        torch.manual_seed(0)
        model = build_model(name, 10, 20).to(dev).train()
        optimizer, scheduler, _ = make_optimizer(model, name, 100, 1)
        gen = torch.Generator(device=dev).manual_seed(0)
        rec = {"model": name, "world": group.world}
        single = None
        if group.world == 1:
            single = make_train_step(model, optimizer, scheduler, name, gen)
            rec["single_ms"] = host_ms(lambda: single(x, y, BATCH), steps)
        dp = make_dp_train_step(model, optimizer, scheduler, name, group,
                                gen)
        rec["dp_ms"] = host_ms(lambda: dp(x, y, BATCH), steps)
        rec["checksum_ms"] = host_ms(lambda: assert_replicated(model, group),
                                     steps)
        rec.update(profile_dp(lambda: dp(x, y, BATCH)))
        out[name] = rec
        del model, optimizer, single, dp
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", default="pointnet,pointconv,gcnn")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        default="nccl")
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--steps", type=int, default=6)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the step on a GPU")
    from interpret_quality_tpu_torch.ops.cuda import build
    from interpret_quality_tpu_torch.parallel import spawn
    build.build(["neighbors", "fps"])          # the ranks only load them
    ranks = spawn(rank, args.world, args.backend, ["cuda:0"] * args.world,
                  args=(args.models.split(","), args.steps))
    for rec in ranks[0].values():
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "backend": args.backend}))


if __name__ == "__main__":
    main()
