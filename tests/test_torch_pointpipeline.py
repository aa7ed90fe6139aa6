"""Both packages run the pipeline for PointNet++, PointConv and PointNet and
write the same artifact tree (in the manner of test_torch_pipeline.py).

One reference-layout ``.t7`` is written from the port's state dict (random
weights with random BN statistics and scales of both signs).  Each package
runs save_fps -> run_shapley_init and, for PointNet++ and PointConv,
run_enum(trans) on the plan path, on the synthetic eval set at a small size
(128 points, 4 regions, 2 orders), into its own directory.  The
architectures' own sizes stay (512 and 128 centres, balls of up to 128
slots), so FPS runs with npoint > N, as it must then.

Compared exactly: FPS indices, region ids, permutations, pose files and
the set of files written; within rtol 1e-4, atol 1e-4 (f32 sums in another
order, BatchNorm folded into the layers on the port's side): norm factors,
per-order and snapshot Shapley values, enum Shapley values and logits.
"""
import numpy as np
import pytest
import torch

from interpret_quality_tpu.attrib import stages as jstages
from interpret_quality_tpu.config import ExperimentConfig as JConfig
from interpret_quality_tpu_torch.attrib import stages as tstages
from interpret_quality_tpu_torch.config import ExperimentConfig as TConfig
from interpret_quality_tpu_torch.models.convert import state_dict_from_jax

from test_torch_models import random_variables
from test_torch_pipeline import EXACT, TOL, _files, _load

SMALL = dict(num_points=128, num_regions=4, num_samples_save=2,
             num_samples=2, shapley_batch_size=1)


def _run(stages, cfg, workdir, monkeypatch, enum: bool):
    monkeypatch.chdir(workdir)          # save_fps writes into the cwd
    stages.save_fps(cfg, synthetic=True)
    stages.run_shapley_init(cfg, synthetic=True, sample_indices=[0])
    if enum:
        stages.run_enum(cfg, "trans", synthetic=True, sample_indices=[0],
                        max_poses=1)


@pytest.mark.parametrize("name", ["pointnet2", "pointconv", "pointnet"])
def test_artifact_trees_match(name, tmp_path, monkeypatch):
    _, variables = random_variables(name, seed=6)
    t7 = str(tmp_path / "model_best.t7")
    torch.save(state_dict_from_jax(name, variables), t7)
    enum = name != "pointnet"

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    _run(jstages, JConfig(model=name, model_path=t7,
                          checkpoints_root=str(jdir / "ck"), **SMALL),
         jdir, monkeypatch, enum)
    _run(tstages, TConfig(model=name, model_path=t7, device="cpu",
                          checkpoints_root=str(tdir / "ck"), **SMALL),
         tdir, monkeypatch, enum)

    files = _files(jdir)
    assert files == _files(tdir)
    assert any(f.endswith("region_shapley/0_2.npy") for f in files)
    assert any(f.endswith("trans_all/all_logits.pt") for f in files) == enum
    for rel in sorted(files):
        want, got = _load(str(jdir / rel)), _load(str(tdir / rel))
        assert got.shape == want.shape, rel
        if rel.split("/")[-1].startswith(EXACT):
            np.testing.assert_array_equal(got, want, err_msg=rel)
        else:
            np.testing.assert_allclose(got, want, err_msg=rel, **TOL)
