"""The port's interaction pipeline against the JAX package's.

Exact where both run the same host numpy or the same boolean algebra:
interaction masks and masked batches, the engine's keep rows (also for the
empty context of m = 0 and the full one of m = R - 2), the pair and context
streams after the same ``set_random``, single-region pairs, ball-query
neighbours and ranks.  rtol 1e-4 / atol 1e-4 where f32 forwards sum in
another order (logits, and the interactions scored from them); rtol 1e-6
for scoring the same logits in float64 on both sides.

GCNN carries the forward: its one graph is built from xyz, so no
feature-space near tie can flip a neighbour between the two packages (see
test_torch_engine.py).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.attrib import coalitions as jco
from interpret_quality_tpu.attrib import interactions as jint
from interpret_quality_tpu.attrib import stages as jstages
from interpret_quality_tpu.config import ExperimentConfig as JConfig
from interpret_quality_tpu.utils import region_geom as jgeom
from interpret_quality_tpu.utils import rng as jrng
from interpret_quality_tpu_torch.attrib import coalitions as tco
from interpret_quality_tpu_torch.attrib import interactions as tint
from interpret_quality_tpu_torch.attrib import stages as tstages
from interpret_quality_tpu_torch.cli import cal_interactions as cal_cli
from interpret_quality_tpu_torch.config import ExperimentConfig as TConfig
from interpret_quality_tpu_torch.models.convert import state_dict_from_jax
from interpret_quality_tpu_torch.utils import region_geom as tgeom
from interpret_quality_tpu_torch.utils import rng as trng

from test_torch_engine import both_models
from test_torch_models import random_variables

TOL = dict(rtol=1e-4, atol=1e-4)
N, R = 128, 8


def _cloud(seed=3):
    rng = np.random.RandomState(seed)
    cloud = rng.randn(N, 3).astype(np.float32)
    cloud -= cloud.mean(axis=0)
    return cloud / np.sqrt((cloud ** 2).sum(-1)).max()


def _contexts(rng, pairs, m, C):
    return np.stack([np.stack([rng.choice(
        [r for r in range(R) if r not in p], m, replace=False)
        for _ in range(C)]) for p in pairs])                   # (P, C, m)


def test_interaction_masks_and_batches_match():
    rng = np.random.RandomState(0)
    ck = rng.rand(5, R) < 0.4
    got = tco.interaction_masks(torch.from_numpy(ck), 2, 6)
    want = jco.interaction_masks(jnp.asarray(ck), jnp.asarray(2), jnp.asarray(6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    cloud = _cloud()
    region_id = rng.randint(0, R, N)
    got = tco.masked_interaction_batch(
        torch.from_numpy(cloud), torch.from_numpy(cloud.mean(0)), got,
        torch.from_numpy(region_id))
    want = jco.masked_interaction_batch(
        jnp.asarray(cloud), jnp.asarray(cloud.mean(0)), want,
        jnp.asarray(region_id))
    assert got.shape == (20, N, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [0, 3, R - 2])
def test_keep_rows_match(m):
    rng = np.random.RandomState(m)
    pairs = np.array([[0, 5], [3, 7], [6, 2]])
    ctx = _contexts(rng, pairs, m, 1 if m in (0, R - 2) else 6)
    teng = tint.InteractionEngine(None, R, device="cpu")
    jeng = jint.InteractionEngine.__new__(jint.InteractionEngine)
    jeng.num_regions = R
    got = teng._keep_rows_np(pairs, ctx)
    np.testing.assert_array_equal(got, jeng._keep_rows_np(pairs, ctx))
    # each row is the canonical interaction mask of its (pair, context)
    for p, (i, j) in enumerate(pairs):
        ck = np.zeros((ctx.shape[1], R), bool)
        for c in range(ctx.shape[1]):
            ck[c, ctx[p, c]] = True
        np.testing.assert_array_equal(
            got.reshape(3, ctx.shape[1], 4, R)[p],
            tco.interaction_masks(torch.from_numpy(ck), i, j).numpy())


def test_pair_and_context_streams_match(tmp_path):
    """Same seed, same draws from the global numpy stream, in the same
    order: random pairs, then contexts (sampled and enumerated)."""
    out = {}
    for pkg, mod, rng_mod in (("jax", jint, jrng), ("torch", tint, trng)):
        rng_mod.set_random(5)
        d = str(tmp_path / pkg) + "/"
        os.makedirs(d)
        pairs = mod.gen_pair_random(32, 20)
        mod.gen_context(pairs, d, 32, ratios=(0.0, 0.1, 0.5, 1.0),
                        num_save_context_max=100)
        out[pkg] = (pairs, {f: np.load(d + f) for f in sorted(os.listdir(d))})
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1].keys() == out["jax"][1].keys()
    for f, arr in out["torch"][1].items():
        np.testing.assert_array_equal(arr, out["jax"][1][f], err_msg=f)
    assert out["torch"][1]["ratio0_context_list.npy"].shape == (20, 1, 0)
    assert out["torch"][1]["ratio100_context_list.npy"].shape == (20, 1, 30)
    assert out["torch"][1]["ratio10_context_list.npy"].shape == (20, 100, 3)


def test_region_geometry_and_ranks_match():
    rng = np.random.RandomState(2)
    cloud = _cloud(4)
    region_id = rng.randint(0, R, N)
    region_id[region_id == 5] = 4                   # region 5 is empty
    got = tgeom.region_ball_neighbors(cloud, region_id, R, 0.25)
    want = jgeom.region_ball_neighbors(cloud, region_id, R, 0.25)
    np.testing.assert_array_equal(got, want)
    assert not got[5].any() and not got[:, 5].any()
    for region in range(R):
        np.testing.assert_array_equal(
            tint.gen_pair_single_region(region, got, R),
            jint.gen_pair_single_region(region, want, R))
    values = rng.randn(R)
    np.testing.assert_array_equal(trng.cal_rank(values), jrng.cal_rank(values))


def test_logits_for_pairs_match_with_a_short_last_chunk():
    """15 (pair, context) cells at 4 per forward: the last forward holds 3."""
    jfwd, fwd = both_models("gcnn")
    cloud = _cloud()
    rng = np.random.RandomState(7)
    region_id = rng.randint(0, R, N)
    pairs = np.array([[0, 5], [3, 7], [1, 2]])
    ctx = _contexts(rng, pairs, 2, 5)
    got = tint.InteractionEngine(fwd, R, batch_contexts=4, device="cpu"
                                 ).logits_for_pairs(cloud, region_id, pairs, ctx)
    want = jint.InteractionEngine(jfwd, R, batch_contexts=4).logits_for_pairs(
        cloud, region_id, pairs, ctx)
    assert got.shape == (3, 20, 10)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        tint.compute_order_interaction(got, 2),
        jint.compute_order_interaction(got, 2), rtol=1e-6)


@pytest.mark.parametrize("softmax_type", ["modified", "normal"])
def test_compute_order_interaction_matches(softmax_type):
    logits = np.random.RandomState(1).randn(4, 24, 10).astype(np.float32) * 3
    got = tint.compute_order_interaction(logits, 3, softmax_type)
    assert got.shape == (4, 6)
    np.testing.assert_allclose(
        got, jint.compute_order_interaction(logits, 3, softmax_type), rtol=1e-6)


def _pairwise_forward(region_id, center, w_pair, pair):
    """logits[0] = sum_j w_j f_j + w_pair f_i f_j, f_j the share of region
    j's points away from the centre (the JAX package's analytic test)."""
    onehot = torch.nn.functional.one_hot(torch.from_numpy(region_id), R).float()
    weights = torch.arange(1.0, R + 1.0) / R
    i, j = pair

    def forward(x):
        away = ((x - torch.from_numpy(center)).abs() > 1e-3).any(-1).float()
        frac = (away @ onehot) / onehot.sum(0)
        score = frac @ weights + w_pair * frac[:, i] * frac[:, j]
        return torch.stack([score, torch.zeros_like(score)], -1)
    return forward


def test_interaction_zero_for_additive_and_wij_for_pairwise():
    rng = np.random.RandomState(0)
    data = rng.randn(80, 3).astype(np.float32) + 4.0
    region_id = rng.randint(0, R, 80)
    region_id[:R] = np.arange(R)
    engine = tint.InteractionEngine(
        _pairwise_forward(region_id, data.mean(0), 0.7, (2, 5)), R,
        batch_contexts=4, device="cpu")
    ctx = np.array([[[0, 1], [3, 4], [6, 7], [1, 4], [3, 7]],
                    [[2, 3], [4, 5], [6, 7], [2, 6], [5, 7]]])
    logits = engine.logits_for_pairs(data, region_id, np.array([[2, 5], [0, 1]]),
                                     ctx)
    inter = tint.compute_order_interaction(logits, 0, "modified")
    np.testing.assert_allclose(inter[0], 0.7, atol=1e-4)
    np.testing.assert_allclose(inter[1], 0.0, atol=1e-4)


# ------------------------------------------------------ whole pipeline
SMALL = dict(num_points=N, num_regions=R, num_samples_save=10, num_samples=10,
             shapley_batch_size=5, interaction_batch_size=16)
RATIOS = (0.0, 0.5, 1.0)
EXACT = ("fps_", "region_id.npy", "all_orders.npy", "trans_vector.npy",
         "trans_distance.npy", "region_pair_list.npy", "_context_list.npy",
         "pose_idx.npy", "transform_params.npy", "pred_labels.npy")
SKIP = ("log.txt", "orders_mode.txt")


def _run(stages, interactions, cfg, workdir, monkeypatch):
    monkeypatch.chdir(workdir)          # save_fps writes into the cwd
    one = dict(synthetic=True, sample_indices=[0])
    stages.save_fps(cfg, synthetic=True)
    stages.run_shapley_init(cfg, **one)
    stages.run_enum(cfg, "trans", max_poses=2, **one)
    interactions.run_gen_pair(cfg, "trans", ratios=RATIOS, num_pairs_random=6,
                              num_save_context_max=5, **one)
    interactions.run_interaction_logits(cfg, "trans", ratios=RATIOS, **one)


def _files(root):
    return {os.path.relpath(os.path.join(d, n), root)
            for d, _, names in os.walk(root) for n in names if n not in SKIP}


def _load(path):
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu").numpy()
    if path.endswith(".txt"):
        with open(path) as f:
            return f.read()
    return np.load(path)


def test_interaction_pipeline_matches_jax(tmp_path, monkeypatch):
    """save_fps -> init -> enum(trans, 2 poses) -> gen_pair ->
    interaction_logits -> cal_interactions in both packages, from one .t7,
    into their own directories; the port's cal_interactions runs through
    its CLI and initialises no CUDA."""
    _, variables = random_variables("gcnn", seed=6)
    t7 = str(tmp_path / "model_best.t7")
    torch.save(state_dict_from_jax("gcnn", variables), t7)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jcfg = JConfig(model="gcnn", model_path=t7,
                   checkpoints_root=str(jdir / "ck"), **SMALL)
    tcfg = TConfig(model="gcnn", model_path=t7, device="cpu",
                   checkpoints_root=str(tdir / "ck"), **SMALL)
    _run(jstages, jint, jcfg, jdir, monkeypatch)
    jint.run_cal_interactions(jcfg, "trans", synthetic=True, ratios=RATIOS,
                              sample_indices=[0])
    _run(tstages, tint, tcfg, tdir, monkeypatch)
    cal_cli.main(["--model", "gcnn", "--mode", "trans", "--synthetic",
                  "--samples", "0", "--checkpoints_root", str(tdir / "ck"),
                  "--num_points", str(N), "--num_regions", str(R),
                  "--ratio", *map(str, RATIOS)])
    assert not torch.cuda.is_initialized()

    files = _files(jdir)
    assert files == _files(tdir)
    inter = "ck/" + tcfg.exp_folder[len(tcfg.checkpoints_root) + 1:] \
        + "synthetic_00/interaction_seed1/"
    for f in ("trans_adv/pred_labels.txt", "normal/ratio50_all_logits.pt",
              "normal/ratio100_pred_interaction.npy",
              "trans_adv/ratio0_pred_interaction.npy"):
        assert inter + f in files, f
    ranks = sorted(os.listdir(str(tdir / inter / "trans_adv_single_region")))
    assert sorted(int(d[10:12]) for d in ranks) == list(range(1, R + 1))
    assert all(d == "range_rank%02d_region%02d" % (int(d[10:12]), int(d[-2:]))
               for d in ranks)
    for rel in sorted(files):
        want, got = _load(str(jdir / rel)), _load(str(tdir / rel))
        if isinstance(want, str) or os.path.basename(rel).endswith(EXACT):
            np.testing.assert_array_equal(got, want, err_msg=rel)
        else:
            assert got.shape == want.shape, rel
            np.testing.assert_allclose(got, want, err_msg=rel, **TOL)
