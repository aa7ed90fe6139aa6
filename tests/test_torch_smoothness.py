"""The port's smoothness enumeration against the JAX package's.

Exact for the host numpy PCA (both packages run the same numpy).  One
constrained step (autograd here, ``jax.grad`` there): rtol 1e-5 /
atol 1e-6, f32 sums in another order.  A whole epoch of all regions:
rtol 1e-4 / atol 1e-5 and the same regions still active, against the JAX
epoch and against the port's own sequential ``update_region``.  The
pipelines of both packages on GCNN: rtol 1e-4 / atol 1e-4, on synthetic
cloud 1, whose eight regions hold 7 to 29 points each.  A region of three
points (cloud 0 has one) is planar: its smallest variance is f32 rounding
noise, and its scattering trajectory follows that noise, so the two
packages step it apart (by ~7e-4 there), as they would any degenerate
region.

The modules are imported whole: the smoothness module defines the
reference's ``test_all_region``, which pytest would collect from this
file's namespace.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.attrib import smoothness as jsm
from interpret_quality_tpu.attrib import stages as jstages
from interpret_quality_tpu.config import ExperimentConfig as JConfig
from interpret_quality_tpu_torch.attrib import smoothness as tsm
from interpret_quality_tpu_torch.attrib import stages as tstages
from interpret_quality_tpu_torch.config import ExperimentConfig as TConfig
from interpret_quality_tpu_torch.models.convert import state_dict_from_jax

from test_torch_models import random_variables

MODES = ("linearity", "planarity", "scattering")
OBJECTIVES = ("inc", "dec")


def test_pca_helpers_match_exactly():
    rng = np.random.RandomState(0)
    for pts in (rng.randn(50, 3).astype(np.float32) * np.array([3.0, 1.0, 0.2]),
                rng.randn(7, 3), rng.randn(1, 3), np.full((4, 3), np.nan)):
        for got, want in zip(tsm.principal_orientations(pts),
                             jsm.principal_orientations(pts)):
            np.testing.assert_array_equal(got, want)
        for mode in MODES:
            assert (tsm.region_smoothness_np(pts, mode)
                    == jsm.region_smoothness_np(pts, mode))


def _region(rng, n, n_region, loose):
    cloud = rng.randn(n, 3).astype(np.float32)
    mask = np.zeros(n, np.float32)
    mask[:n_region] = 1.0
    pts = cloud[:n_region]
    ori = np.stack(tsm.principal_orientations(pts)).astype(np.float32)
    v = np.array([np.var(pts @ o, ddof=1) for o in ori])
    if loose:
        bounds = np.stack([v + 10.0, v - 10.0])
    else:           # the middle variance already sits past its upper bound
        bounds = np.stack([v + np.array([0.003, -0.001, 0.003]), v - 0.003])
    return cloud, mask, ori, bounds.astype(np.float32)


@pytest.mark.parametrize("loose", [True, False])
@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("mode", MODES)
def test_smoothness_step_matches_jax(mode, objective, loose):
    rng = np.random.RandomState(2)
    cloud, mask, ori, bounds = _region(rng, 64, 24, loose)
    data = cloud + 0.02 * rng.randn(*cloud.shape).astype(np.float32) * mask[:, None]
    args = (data, cloud, mask, ori, bounds)
    got = tsm.smoothness_step(*[torch.from_numpy(a) for a in args], mode,
                              objective)
    want = jsm.smoothness_step(*[jnp.asarray(a) for a in args], mode, objective)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5,
                               atol=1e-6)
    assert int(got[2]) == int(want[2]) and bool(got[3]) == bool(want[3])
    assert np.abs(got[0].numpy()[24:] - data[24:]).max() == 0
    disp = np.linalg.norm(got[0].numpy() - cloud, axis=1)
    assert disp.max() <= tsm.DIST_THRESHOLD + 1e-6


def _epoch_inputs(mode, N=96, R=4):
    """The JAX package's epoch-test setup: four regions of 24 points."""
    rng = np.random.RandomState(0)
    data = rng.randn(N, 3).astype(np.float32) * 0.2
    region_id = np.repeat(np.arange(R), N // R)
    masks, orients, bounds, smooth_prev = [], [], [], []
    for r in range(R):
        pts = data[region_id == r]
        ori = np.stack(tsm.principal_orientations(pts)).astype(np.float32)
        v = np.array([np.var(pts @ o, ddof=1) for o in ori])
        masks.append((region_id == r).astype(np.float32))
        orients.append(ori)
        bounds.append(np.stack([v + tsm.VAR_THRESHOLD,
                                v - tsm.VAR_THRESHOLD]).astype(np.float32))
        smooth_prev.append(tsm.region_smoothness_np(pts, mode))
    return data, [np.stack(a) for a in (masks, orients, bounds)], \
        np.array(smooth_prev, np.float32)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("mode", MODES)
def test_epoch_matches_jax_and_sequential(mode, objective):
    data, (masks, orients, bounds), sm = _epoch_inputs(mode)
    step = tsm.ENUM_STEP if objective == "inc" else -tsm.ENUM_STEP
    got = tsm.smoothness_epoch_all_regions(
        *[torch.from_numpy(a) for a in (data, data, masks, orients, bounds, sm)],
        torch.ones(4, dtype=torch.bool), torch.from_numpy(sm + np.float32(step)),
        mode, objective)
    want = jsm.smoothness_epoch_all_regions(
        *[jnp.asarray(a) for a in (data, data, masks, orients, bounds, sm)],
        jnp.ones((4,), bool), jnp.asarray(sm) + step, mode, objective)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))

    seq, seq_smooth, seq_active = data.copy(), [], []
    for r in range(4):
        seq, s, keep = tsm.update_region(seq, data, masks[r], orients[r],
                                         bounds[r], float(sm[r]), mode, objective)
        seq_smooth.append(s)
        seq_active.append(keep)
    np.testing.assert_allclose(got[0].numpy(), seq, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), seq_smooth, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), seq_active)


def test_degenerate_single_point_region():
    """A single-point region neither crashes the host PCA nor poisons the
    epoch: it never moves and stays inactive."""
    one = np.array([[0.3, -0.1, 0.2]], np.float32)
    assert np.allclose(np.stack(tsm.principal_orientations(one)), np.eye(3))
    assert tsm.region_smoothness_np(one, "linearity") == 0.0
    rng = np.random.RandomState(3)
    pts = rng.randn(33, 3).astype(np.float32) * 0.2
    region_id = np.zeros(33, np.int64)
    region_id[-1] = 1
    masks, orients, bounds, smooth_prev, usable = [], [], [], [], []
    for r in range(2):
        p = pts[region_id == r]
        o = np.stack(tsm.principal_orientations(p))
        v = (np.array([np.var(p @ oo, ddof=1) for oo in o])
             if p.shape[0] >= 2 else np.zeros(3))
        masks.append((region_id == r).astype(np.float32))
        orients.append(o.astype(np.float32))
        bounds.append(np.stack([v + tsm.VAR_THRESHOLD,
                                v - tsm.VAR_THRESHOLD]).astype(np.float32))
        smooth_prev.append(tsm.region_smoothness_np(p, "linearity"))
        usable.append(p.shape[0] >= 2)
    sm = torch.tensor(smooth_prev, dtype=torch.float32)
    out, smooth, active = tsm.smoothness_epoch_all_regions(
        torch.from_numpy(pts), torch.from_numpy(pts),
        *[torch.from_numpy(np.stack(a)) for a in (masks, orients, bounds)],
        sm, torch.tensor(usable), sm + tsm.ENUM_STEP, "linearity", "inc")
    assert torch.isfinite(out).all() and torch.isfinite(smooth).all()
    assert torch.equal(out[-1], torch.from_numpy(pts[-1]))
    assert not bool(active[1])


SMALL = dict(num_points=128, num_regions=8, num_samples_save=10,
             num_samples=10, shapley_batch_size=5)


def _run(stages, smoothness, cfg, workdir, monkeypatch):
    monkeypatch.chdir(workdir)          # save_fps writes into the cwd
    stages.save_fps(cfg, synthetic=True)
    stages.run_shapley_init(cfg, synthetic=True, sample_indices=[1])
    smoothness.run_smoothness(cfg, synthetic=True, sample_indices=[1],
                              max_epochs=2)


def test_smoothness_pipeline_matches_jax(tmp_path, monkeypatch):
    _, variables = random_variables("gcnn", seed=6)
    t7 = str(tmp_path / "model_best.t7")
    torch.save(state_dict_from_jax("gcnn", variables), t7)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    _run(jstages, jsm, JConfig(model="gcnn", model_path=t7,
                               checkpoints_root=str(jdir / "ck"), **SMALL),
         jdir, monkeypatch)
    _run(tstages, tsm, TConfig(model="gcnn", model_path=t7, device="cpu",
                               checkpoints_root=str(tdir / "ck"), **SMALL),
         tdir, monkeypatch)

    def files(root):
        return {os.path.relpath(os.path.join(d, n), root)
                for d, _, names in os.walk(root) for n in names
                if "_all/allregion_" in d and n != "log.txt"}
    got_files = files(tdir)
    assert got_files == files(jdir) and len(got_files) == 3 * 2 * 5
    for rel in sorted(got_files):
        load = ((lambda p: torch.load(p).numpy()) if rel.endswith(".pt")
                else np.load)
        got, want = load(str(tdir / rel)), load(str(jdir / rel))
        assert got.shape == want.shape, rel
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=rel)
