"""The pose enumeration of ``attrib.stages.run_enum`` on the plan path:
per call, ``ShapleyEngine.enum_all_poses_plan`` over a block of poses of
one cloud with fresh orders from the seed, the orders in chunks of the
family's batch, the logits returned.

The clouds come from a pool fixed by the traffic file (``cloud_pool``:
one cloud of each class, the same for every seed), call i taking pool
cloud i mod the pool's size and the next block of its pose grid: a cloud's
shape sets how full PointNet++'s balls are, so a cloud drawn from the seed
would make the seed change the work.  The seed draws the orders and the
weights.

The check recomputes, for poses drawn from the seed among those the window
finished, the masked clouds, the plan, every logit and the Shapley values
with the plain reference (``gaps``).  It also judges the engine's last
stage on its own: the program's Shapley values against the reference's
reward and marginals of the program's own logits (``marginal_*``), which
near-ties in the forward cannot move."""
from __future__ import annotations

import numpy as np
import torch

from iqbench import gaps, inputs, work
from iqbench.reference import attribution as ref_attr
from iqbench.reference.common import precision
from iqbench.weights import seeded_state


class Driver:
    units = "forwards"

    def __init__(self, ctx):
        from interpret_quality_tpu_torch.attrib.perturbations import MODES
        from interpret_quality_tpu_torch.attrib.shapley import ShapleyEngine
        from interpret_quality_tpu_torch.models import build_model, make_forward_fn
        cfg, tr = ctx.cfg, ctx.traffic
        self.cfg, self.tr, self.ctx = cfg, tr, ctx
        self.seeds = inputs.child_seeds(ctx.seed, 4)
        self.state = seeded_state(cfg, self.seeds[0], ctx.device)
        model = build_model(cfg["family"], cfg["num_classes"], cfg.get("k", 20))
        model.load_state_dict(self.state, strict=True)
        self.model = model.to(ctx.device).eval()
        fwd = make_forward_fn(self.model)
        self.plan_fn = ctx.span("iqbench.plan", fwd.plan_fn)
        self.apply_fn = ctx.span("iqbench.forward", fwd.apply_plan_fn)
        self.engine = ShapleyEngine(
            ctx.span("iqbench.forward", fwd), cfg["num_regions"],
            tr["softmax_type"], cfg["assumed"]["shapley_batch_orders"],
            ctx.device)
        self.enum = ctx.span("iqbench.engine", self.engine.enum_all_poses_plan)
        self.disturb = MODES[tr["mode"]].disturb_fn
        self.grid = {"trans": inputs.trans_grid}[tr["mode"]]()
        rng = np.random.RandomState(tr["cloud_pool"]["seed"])
        self.pool = []
        for c in range(tr["cloud_pool"]["size"]):
            pc, label = inputs.synthetic_cloud(rng, cfg["num_points"],
                                               cfg["num_classes"],
                                               c % cfg["num_classes"])
            self.pool.append((pc, label, inputs.region_ids(
                pc, inputs.fps_np(pc, cfg["num_regions"]))))
        self.orders = {}
        self.pos = 0
        self.done = []                  # (call, sv, logits)

    def inputs(self, i: int):
        """Call i: (cloud, label, region ids, orders, first pose, poses)."""
        ppc = self.tr["poses_per_call"]
        blocks = -(-len(self.grid) // ppc)
        size = len(self.pool)
        first = (i // size) % blocks * ppc
        if i not in self.orders:
            rng = np.random.RandomState(inputs.child_seeds(self.seeds[1] + i, 1)[0])
            self.orders[i] = inputs.orders(rng, self.tr["orders_per_pose"],
                                           self.cfg["num_regions"])
        pc, label, region = self.pool[i % size]
        return pc, label, region, self.orders[i], first, min(ppc, len(self.grid) - first)

    def call(self, i: int, poses=None):
        pc, label, region, orders, first, n = self.inputs(i)
        return self.enum(self.disturb, pc, self.grid[first:first + (poses or n)],
                         label, region, orders, self.plan_fn, self.apply_fn,
                         return_logits=True)

    def warmup(self):
        self.call(0, poses=2)

    def step(self) -> int:
        sv, logits = self.call(self.pos)
        self.done.append((self.pos, sv, logits))
        self.pos += 1
        return logits.shape[0] * logits.shape[1]

    def finish(self):
        pass                        # every call ends in a host copy

    def release(self):
        del self.model, self.engine, self.enum, self.plan_fn, self.apply_fn

    # ------------------------------------------------------------- check
    def samples(self):
        rng = np.random.RandomState(self.seeds[2])
        poses = [(j, p) for j, (_, sv, _) in enumerate(self.done)
                 for p in range(len(sv))]
        pick = rng.choice(len(poses), min(self.tr["check_poses"], len(poses)),
                          replace=False)
        out = []
        for k in sorted(pick):
            j, p = poses[k]
            i, sv, logits = self.done[j]
            out.append({"call": i, "pose": self.inputs(i)[4] + p,
                        "program": {"sv": sv[p], "logits": logits[p]}})
        return out

    def masked(self, i: int, orders: np.ndarray) -> torch.Tensor:
        """The masked clouds of call i's cloud under ``orders``, as they are."""
        pc, _, region, _, _, _ = self.inputs(i)
        dev = self.ctx.device
        keep = torch.from_numpy(ref_attr.keep_matrix(orders)).to(dev)
        return ref_attr.mask(torch.from_numpy(pc).to(dev), keep,
                             torch.from_numpy(region).to(dev))

    def reference(self, sample, tf32: bool):
        """The reference's logits and Shapley values of a sample; with
        ``tf32`` the control: products in one TF32 pass, the reward and
        marginals in bfloat16."""
        _, label, _, orders, _, _ = self.inputs(sample["call"])
        t = torch.from_numpy(self.grid[sample["pose"]]).to(self.ctx.device)
        with torch.no_grad(), precision(tf32):
            logits = ref_attr.logits(self.cfg, self.state,
                                     self.masked(sample["call"], orders), t)
        dtype = torch.bfloat16 if tf32 else torch.float64
        return {"sv": ref_attr.shapley(logits, orders, label, dtype),
                "logits": logits.cpu().numpy(), "orders": orders,
                "label": label}

    @staticmethod
    def compare(program, reference):
        """Every candidate number (``gaps``); the cell's limits name those
        compared.  ``marginal_*`` holds the program's Shapley values against
        the reference's marginals of the program's own logits."""
        own = ref_attr.shapley(torch.from_numpy(np.asarray(program["logits"])),
                               reference["orders"], reference["label"])
        return dict(gaps.logit_gaps(program["logits"], reference["logits"]),
                    **gaps.value_gaps(program["sv"], reference["sv"], "shapley"),
                    **gaps.value_gaps(program["sv"], own, "marginal"))

    # -------------------------------------------------------------- work
    def work(self):
        """Per chunk of masked clouds the window forwarded: its counts
        (``work.chunk_counts``), the poses that forwarded it, and one plan."""
        chunk = self.cfg["assumed"]["shapley_batch_orders"]
        out = []
        for i, sv, _ in self.done:
            _, _, region, orders, _, _ = self.inputs(i)
            for s in range(0, len(orders), chunk):
                counts = work.chunk_counts(
                    self.cfg, self.masked(i, orders[s:s + chunk]),
                    work.enum_chunk_keep(orders[s:s + chunk]), region)
                out.append(dict(counts, forwards=len(sv), plans=1))
        return out
