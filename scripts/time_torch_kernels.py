#!/usr/bin/env python3
"""Time the PyTorch port's neighbour, FPS, ball-MLP and PointConv SA kernels
on one NVIDIA GPU at the main path's shapes, for one or more variants of the
CUDA sources.

    python3 scripts/time_torch_kernels.py [--csrc DIR ...] [--reps 3]
                           [--only knn,gather,fused,density,ball,pconv,fps]

``--only`` names: ``knn`` (iq_knn, GCNN's graph, on the route the shape
takes and on each of its two routes forced: ``xyz``, the cloud staged once
a block and a warp per query, and ``tiled``, the blocked selection kernel 3
shares), ``gather`` (iq_gather_extrema, GCNN's four
layers on their kNN indices, on the route each shape takes and on the row
route forced, with the route and the blocks one SM holds), ``fused``
(iq_knn_gather_extrema, DGCNN's four layers), ``density`` (iq_knn_density,
PointConv's two levels, by shape and on each route forced, with the share
of distinct query rows), ``ball``
(iq_ball_mlp3, PointNet++'s six branches), ``pconv`` (iq_pointconv_sa,
PointConv's two levels, on the kernel-6 indices) and ``fps`` (iq_fps, 1024 ->
512 -> 128, with the blocks one SM holds).

Each ``--csrc DIR`` is a directory holding ``neighbors.cu``, ``fps.cu``,
``groups.cu`` and ``knn_select.cuh`` (default: the package's own ``csrc/``).
To time a scratch variant of a kernel, copy ``csrc/`` into a directory that
git ignores (``build/variants/<name>/``), edit the copy, and pass both
directories: the variants are built and timed in turns inside one process,
on one card, so their times compare.  Inputs are those of ``chip_smoke.py``
(1650 masked clouds of 1024 points, seeded models); ``--unmasked`` swaps in
a batch without collapsed regions, where no row is a copy of another.  Prints one JSON line
per variant with the ptxas registers of every kernel and CUDA-event times
in ms (mean of ``--reps`` launches after a warm-up).  The only correctness
check here is the tie rule (kNN indices of exact-duplicate clouds equal to
``knn_plain``'s); ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
the kernels against their plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def registers(report: str):
    """{kernel: (registers, stack frame, spill stores, spill loads)} of a
    ptxas report, sizes in bytes."""
    out, name, spills = {}, None, (0, 0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spills = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            # "void (anonymous namespace)::kernel<1, 32>(float const*, ...)"
            # -> "kernel<1, 32>"
            full = subprocess.run(["c++filt", name], capture_output=True,
                                  text=True).stdout.strip()
            short = full.replace("(anonymous namespace)::", "").split("(")[0]
            short = short.removeprefix("void ")
            out[short or name] = (int(m.group(1)), *spills)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="knn,gather,fused,density,ball,pconv,fps")
    ap.add_argument("--unmasked", action="store_true",
                    help="time on a batch without collapsed regions (the "
                         "eval cloud at 1650 scales): no row is a copy of "
                         "another, so nothing is skipped")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from interpret_quality_tpu_torch.models.common import fold_stack
    from interpret_quality_tpu_torch.ops.cuda import build
    from interpret_quality_tpu_torch.ops.cuda import fps as fp
    from interpret_quality_tpu_torch.ops.cuda import groups as gr
    from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
    from interpret_quality_tpu_torch.ops.geometry import (compute_density,
                                                          index_points)
    from interpret_quality_tpu_torch.ops.precision import set_matmul_precision
    set_matmul_precision("highest")
    only = set(args.only.split(","))
    device = torch.device("cuda")
    variants = args.csrc or [build.CSRC]
    smi = cs.nvidia_smi_line()

    def use(csrc):
        build.CSRC = os.path.abspath(csrc)
        build.load.cache_clear()
        for mod in (nb, fp, gr):
            mod._lib.cache_clear()
        return {k: registers(v) for k, v in build.build().items()}

    use(build.CSRC)
    masked = cs.coalition_batch(device)
    if args.unmasked:
        from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
        x = torch.from_numpy(SyntheticClouds(30, cs.N, 10, seed=1)[0][0]).to(device)
        scales = 1 + 0.1 * torch.linspace(-1, 1, masked.shape[0], device=device)
        masked = (x[None] * scales[:, None, None]).contiguous()
    with torch.inference_mode():
        inputs = cs.layer_inputs(masked, device)
        layers = inputs["dgcnn"][0]
        gcnn_values = [a for _, a in inputs["gcnn"][0]]
        gcnn_idx = inputs["gcnn"][1]
        del inputs
        branches, ball_rows, dens, pconvs, fps_levels = [], [], [], [], []
        if "ball" in only:
            # the six PointNet++ branches, on the inputs a forward gives them
            model = cs.seeded_model("pointnet2", device)
            xyz, points = masked, None
            for sa in (model.sa1, model.sa2):
                new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
                D = 0 if points is None else points.shape[-1]
                outs = []
                for convs, bns, radius, k in zip(sa.conv_blocks, sa.bn_blocks,
                                                 sa.radius_list, sa.nsample_list):
                    (a1, b1), (a2, b2), (a3, b3) = fold_stack(convs, bns)
                    uf = None if points is None else torch.matmul(points, a1[:D])
                    call = (new_xyz, xyz, uf, b1, a1[D:], a2, b2, a3, b3)
                    branches.append((call, dict(radius=radius, k=k)))
                    ball_rows.append(sum(int(torch.clamp(
                        (((xyz[sl][:, None] - new_xyz[sl][:, :, None]) ** 2).sum(-1)
                         <= radius ** 2).sum(-1), 1, k).sum())
                        for sl in cs.chunks(xyz.shape[0], 66)))
                    outs.append(gr.fused_ball_mlp3(*call, radius=radius, k=k))
                xyz, points = new_xyz, torch.cat(outs, dim=-1)
        if only & {"density", "pconv", "fps"}:
            # the two PointConv levels: kernel 6's inputs, kernel 7's on its indices
            pconv = cs.seeded_model("pointconv", device)
            xyz, points = masked, None
            for sa in (pconv.sa1, pconv.sa2):
                inv = 1.0 / compute_density(xyz, sa.bandwidth)
                fps_levels.append((xyz, sa.npoint))
                new_xyz = index_points(xyz, fp.fps(xyz, sa.npoint))
                dens.append((new_xyz, xyz, inv, sa.nsample))
                if "pconv" in only:
                    idx, den, dmax = gr.knn_with_density(*dens[-1])
                    (a1, b1), (a2, b2), (a3, b3) = fold_stack(sa.mlp_convs,
                                                              sa.mlp_bns)
                    src = xyz if points is None else torch.cat([xyz, points], -1)
                    call = (idx, den, dmax, new_xyz, torch.matmul(src, a1) + b1,
                            xyz, torch.matmul(new_xyz, a1[:3]), a2, b2, a3, b3,
                            fold_stack(sa.densitynet.mlp_convs,
                                       sa.densitynet.mlp_bns),
                            fold_stack(sa.weightnet.mlp_convs,
                                       sa.weightnet.mlp_bns))
                    pconvs.append((call, sa.nsample))
                    points = sa._head(gr.fused_pointconv_sa(*call, k=sa.nsample))
                xyz = new_xyz
        torch.cuda.empty_cache()

        for rnd in range(2 if len(variants) > 1 else 1):
            for csrc in (variants if rnd == 0 else variants[::-1]):
                regs = use(csrc)
                rec = {"csrc": os.path.relpath(build.CSRC, REPO), "round": rnd,
                       "batch": "unmasked" if args.unmasked else "masked",
                       "nvidia_smi": smi, "registers": regs}
                if "knn" in only:
                    # exact ties: duplicate clouds must give knn_plain's indices
                    g = torch.Generator().manual_seed(0)
                    for C in (3, 64, 128):
                        dup = torch.randn(8, 128, C, generator=g).repeat(
                            1, 8, 1).contiguous().to(device)
                        rec[f"duplicate_cloud_indices_equal_C{C}"] = torch.equal(
                            nb.knn(dup, dup, cs.K), nb.knn_plain(dup, dup, cs.K))
                    rec["knn_ms"] = cs.cuda_ms(
                        lambda: nb.knn(masked, masked, cs.K), args.reps)
                    rec["knn_route"] = nb.knn_route(cs.N, 3, cs.K)
                    rec["knn_route_ms"] = {
                        name: cs.cuda_ms(lambda: nb._knn(
                            masked, masked, cs.K, nb.KNN_ROUTES[name]), args.reps)
                        for name in ("xyz", "tiled")}
                if "gather" in only:
                    # bit-equal to the plain version on the first chunk
                    sl = next(cs.chunks(masked.shape[0]))
                    rec["gather_extrema_bit_equal"] = [all(
                        torch.equal(got[sl], want) for got, want in zip(
                            nb.gather_extrema(gcnn_idx, a),
                            nb.gather_extrema_plain(gcnn_idx[sl], a[sl])))
                        for a in gcnn_values]
                    rec["gather_extrema_route"] = [nb.gather_extrema_route(
                        a.shape[1], a.shape[2], cs.K) for a in gcnn_values]
                    rec["gather_extrema_ms"] = [
                        cs.cuda_ms(lambda: nb.gather_extrema(gcnn_idx, a),
                                   args.reps) for a in gcnn_values]
                    rec["gather_extrema_rows_route_ms"] = [
                        cs.cuda_ms(lambda: nb._gather_extrema(
                            gcnn_idx, a, nb.ROUTES["rows"]), args.reps)
                        for a in gcnn_values]
                if "fused" in only:
                    rec["knn_gather_extrema_ms"] = [
                        cs.cuda_ms(lambda: nb.knn_gather_extrema(xs, a, cs.K),
                                   args.reps) for xs, a in layers]
                if "density" in only:
                    rec["density_distinct_query_rows"] = [
                        cs.distinct_row_count(d[0]) / d[0].shape[0] / d[0].shape[1]
                        for d in dens]
                    rec["knn_with_density_ms"] = [
                        cs.cuda_ms(lambda: gr.knn_with_density(*d), args.reps)
                        for d in dens]
                    rec["knn_with_density_route"] = [gr.knn_density_route(
                        d[1].shape[1], 3, d[3]) for d in dens]
                    rec["knn_with_density_route_ms"] = [{
                        name: cs.cuda_ms(lambda: gr._knn_with_density(
                            *d, nb.KNN_ROUTES[name]), args.reps)
                        for name in ("xyz", "tiled")} for d in dens]
                if "ball" in only:
                    rec["fused_ball_mlp3_filled_rows"] = ball_rows
                    rec["fused_ball_mlp3_ms"] = [
                        cs.cuda_ms(lambda: gr.fused_ball_mlp3(*call, **kw),
                                   args.reps) for call, kw in branches]
                if "pconv" in only:
                    # the wrapper's DensityNet (plain PyTorch) is timed apart
                    rec["density_scale_ms"] = [
                        cs.cuda_ms(lambda: gr.density_scale(
                            call[1], call[2], call[11]), args.reps)
                        for call, _ in pconvs]
                    rec["fused_pointconv_sa_ms"] = [
                        cs.cuda_ms(lambda: gr.fused_pointconv_sa(*call, k=k),
                                   args.reps) for call, k in pconvs]
                if "fps" in only:
                    rec["fps_ms"] = [
                        cs.cuda_ms(lambda: fp.fps(x, npoint), args.reps)
                        for x, npoint in fps_levels]
                    rec["fps_occupancy"] = [fp.fps_occupancy(x.shape[1])
                                            for x, _ in fps_levels]
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
