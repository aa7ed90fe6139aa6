"""The interaction logits of ``attrib.interactions.run_interaction_logits``:
per cloud, random region pairs and for each ratio its contexts, one call of
``InteractionEngine.logits_for_pairs`` per ratio (the family's cells a
forward, 4 masked clouds a cell), the logits returned.  The ratios cycle in
order; after the last, the next cloud.

The check draws cells from the seed among those the window finished,
recomputes their four masked clouds and logits with the plain reference,
and compares the widest logit gap over the RMS of the reference's logits."""
from __future__ import annotations

import numpy as np
import torch

from iqbench import gaps, inputs, work
from iqbench.reference import attribution as ref_attr
from iqbench.reference.common import precision
from iqbench.weights import seeded_state

CACHED_CLOUDS = 4


class Driver:
    units = "forwards"

    def __init__(self, ctx):
        from interpret_quality_tpu_torch.attrib.interactions import InteractionEngine
        from interpret_quality_tpu_torch.models import build_model, make_forward_fn
        cfg, tr = ctx.cfg, ctx.traffic
        self.cfg, self.tr, self.ctx = cfg, tr, ctx
        self.seeds = inputs.child_seeds(ctx.seed, 4)
        self.state = seeded_state(cfg, self.seeds[0], ctx.device)
        model = build_model(cfg["family"], cfg["num_classes"], cfg.get("k", 20))
        model.load_state_dict(self.state, strict=True)
        self.model = model.to(ctx.device).eval()
        engine = InteractionEngine(
            ctx.span("iqbench.forward", make_forward_fn(self.model)),
            cfg["num_regions"], cfg["assumed"]["interaction_batch_contexts"],
            ctx.device)
        self.call = ctx.span("iqbench.engine", engine.logits_for_pairs)
        self.clouds = [self._cloud(c) for c in range(CACHED_CLOUDS)]
        self.pos = 0
        self.done = []              # (cloud, ratio index, logits)

    def _cloud(self, c: int):
        cfg, tr = self.cfg, self.tr
        rng = np.random.RandomState(inputs.child_seeds(self.seeds[1] + c, 1)[0])
        R = cfg["num_regions"]
        pc, label = inputs.synthetic_cloud(rng, cfg["num_points"],
                                           cfg["num_classes"])
        region = inputs.region_ids(pc, inputs.fps_np(pc, R))
        pairs = inputs.random_pairs(rng, R, tr["pairs_per_call"])
        ctxs = [inputs.contexts(rng, pairs, R, ratio, tr["max_contexts"])
                for ratio in tr["ratios"]]
        return pc, region, pairs, ctxs

    def _run(self, i: int):
        c, r = divmod(i, len(self.tr["ratios"]))
        pc, region, pairs, ctxs = self.clouds[c % CACHED_CLOUDS]
        return c % CACHED_CLOUDS, r, self.call(pc, region, pairs, ctxs[r])

    def warmup(self):
        # both forward sizes: a ratio with one context, one with a full call
        for i in (0, 2):
            self._run(i)

    def step(self) -> int:
        c, r, logits = self._run(self.pos)
        self.pos += 1
        self.done.append((c, r, logits))
        return logits.shape[0] * logits.shape[1]

    def finish(self):
        pass                        # every call ends in a host copy

    def release(self):
        del self.model, self.call

    # ------------------------------------------------------------- check
    def _keep(self, c: int, r: int) -> np.ndarray:
        _, _, pairs, ctxs = self.clouds[c]
        return ref_attr.interaction_keep(pairs, ctxs[r], self.cfg["num_regions"])

    def samples(self):
        """One sample: ``check_cells`` cells drawn over every finished call."""
        cells = [(i, p, k) for i, (_, _, lg) in enumerate(self.done)
                 for p in range(lg.shape[0]) for k in range(lg.shape[1] // 4)]
        rng = np.random.RandomState(self.seeds[2])
        pick = sorted(rng.choice(len(cells), min(self.tr["check_cells"],
                                                 len(cells)), replace=False))
        cells = [cells[j] for j in pick]
        program = np.concatenate([self.done[i][2][p, 4 * k:4 * k + 4]
                                  for i, p, k in cells])
        return [{"cells": cells, "program": {"logits": program}}]

    def reference(self, sample, tf32: bool):
        dev = self.ctx.device
        by_cloud = {}
        for i, p, k in sample["cells"]:
            c, r, _ = self.done[i]
            by_cloud.setdefault(c, []).append(self._keep(c, r)[p, k])
        out = {}
        with torch.no_grad(), precision(tf32):
            for c, keeps in by_cloud.items():
                pc, region, _, _ = self.clouds[c]
                masked = ref_attr.mask(torch.from_numpy(pc).to(dev),
                                       torch.from_numpy(np.stack(keeps)).to(dev),
                                       torch.from_numpy(region).to(dev))
                out[c] = iter(ref_attr.logits(self.cfg, self.state, masked)
                              .reshape(len(keeps), 4, -1).cpu().numpy())
        logits = [next(out[self.done[i][0]]) for i, _, _ in sample["cells"]]
        return {"logits": np.concatenate(logits)}

    @staticmethod
    def compare(program, reference):
        """Every candidate number (``gaps``); the cell's limits name those
        compared."""
        return gaps.logit_gaps(program["logits"], reference["logits"])

    # -------------------------------------------------------------- work
    def work(self):
        """Per forward of the window: its counts (``work.chunk_counts``)."""
        bs = self.cfg["assumed"]["interaction_batch_contexts"]
        out = []
        for c, r, _ in self.done:
            pc, region, _, _ = self.clouds[c]
            keep = self._keep(c, r).reshape(-1, 4, self.cfg["num_regions"])
            for s in range(0, len(keep), bs):
                rows = keep[s:s + bs].reshape(-1, keep.shape[-1])
                masked = ref_attr.mask(torch.from_numpy(pc).to(self.ctx.device),
                                       torch.from_numpy(rows).to(self.ctx.device),
                                       torch.from_numpy(region).to(self.ctx.device))
                out.append(dict(work.chunk_counts(self.cfg, masked, rows, region),
                                forwards=1, plans=0))
        return out
