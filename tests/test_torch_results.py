"""The port's results stage against the JAX package's: the tables
(sensitivity, correlation, smoothness with the Knife skip) and the plot
helpers read one seeded artifact tree and must give equal numbers; and one
run of the port's own CLIs on GCNN at 64 points on the CPU, from save_fps
to result and plot_interaction, writes a tree that the tables and plots
read (the north star's "artifact tree that the table and plot code
reads").
"""
import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from interpret_quality_tpu.attrib.interactions import RATIOS as JRATIOS
from interpret_quality_tpu.config import ExperimentConfig as JConfig
from interpret_quality_tpu.results import plots as jplots
from interpret_quality_tpu.results import tables as jtables
from interpret_quality_tpu.results import visualization as jvis
from interpret_quality_tpu_torch.attrib.interactions import RATIOS
from interpret_quality_tpu_torch.config import ExperimentConfig
from interpret_quality_tpu_torch.results import plots as tplots
from interpret_quality_tpu_torch.results import tables as ttables
from interpret_quality_tpu_torch.results import visualization as tvis

N, R, POSES = 64, 8, 5
NAMES = ["Bag_aaa", "Knife_bbb", "Cap_ccc", "Mug_ddd"]


def _configs(root, dataset="shapenet"):
    kw = dict(model="pointnet", dataset=dataset, num_points=N, num_regions=R,
              checkpoints_root=str(root))
    return JConfig(**kw), ExperimentConfig(device="cpu", **kw)


@pytest.fixture()
def table_tree(tmp_path):
    """region_id, the three pose enumerations and the three smoothness
    modes (inc and dec) per sample, and the clouds."""
    jcfg, tcfg = _configs(tmp_path)
    assert jcfg.exp_folder == tcfg.exp_folder
    rng = np.random.RandomState(0)
    clouds = []
    for name in NAMES:
        base = tcfg.exp_folder + name + "/"
        for sub in ["trans_all", "rotate_all", "scale_all"] + [
                f"{m}_all/allregion_{o}" for m in ttables.SMOOTH_MODES
                for o in ("inc", "dec")]:
            os.makedirs(base + sub)
            np.save(base + sub + "/region_shapley_value.npy",
                    rng.randn(POSES, R).astype(np.float32))
        np.save(base + "region_id.npy", rng.permutation(np.arange(N) % R))
        clouds.append((rng.rand(N, 3).astype(np.float32), 0))
    return jcfg, tcfg, clouds


def test_tables_match_jax(table_tree):
    jcfg, tcfg, clouds = table_tree
    for mode in ttables.MODES_ALL:
        got = ttables.cal_sensitivity_all_pc(tcfg, mode, NAMES)
        want = jtables.cal_sensitivity_all_pc(jcfg, mode, NAMES)
        assert got.shape == (len(NAMES), R)
        np.testing.assert_array_equal(got, want)
    for mode in ("trans", "rotate", "scale"):
        np.testing.assert_array_equal(
            ttables.cal_mean_sv_intensity(tcfg, mode, NAMES),
            jtables.cal_mean_sv_intensity(jcfg, mode, NAMES))
        assert ttables.cal_correlation_coef(tcfg, mode, NAMES) == \
            jtables.cal_correlation_coef(jcfg, mode, NAMES)
    for mode in ("trans", "rotate"):
        got = ttables.cal_shapley_smoothness_metric(tcfg, mode, clouds, NAMES)
        assert got == jtables.cal_shapley_smoothness_metric(jcfg, mode,
                                                            clouds, NAMES)
        assert np.isfinite(got).all()
        # the Knife sample is skipped: leaving it out changes nothing
        keep = [0, 2, 3]
        assert got == ttables.cal_shapley_smoothness_metric(
            tcfg, mode, [clouds[i] for i in keep], [NAMES[i] for i in keep])
    data, _ = clouds[0]
    region_id = np.load(tcfg.exp_folder + NAMES[0] + "/region_id.npy")
    sv = np.random.RandomState(1).randn(POSES, R)
    for got, want in zip(
            ttables.cal_shapley_smoothness_metric_single_pc(data, sv, region_id, R),
            jtables.cal_shapley_smoothness_metric_single_pc(data, sv, region_id, R)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture()
def interaction_tree(tmp_path):
    """ratio<r>_{gt,pred}_interaction.npy at the normal and adversarial
    poses and in a rank-1 single-region folder, for the selected samples
    of ModelNet10 (and an empty rank-2 folder, which the plots skip)."""
    assert list(RATIOS) == list(JRATIOS)
    jcfg, tcfg = _configs(tmp_path / "ck", dataset="modelnet10")
    rng = np.random.RandomState(1)
    names = [f"synthetic_{i:02d}" for i in range(30)]
    for i in tplots.selected_sample_indices("modelnet10"):
        base = tcfg.exp_folder + f"{names[i]}/interaction_seed{tcfg.seed}/"
        os.makedirs(base + "rotate_adv_single_region/range_rank02_region05")
        for sub in ("normal", "rotate_adv",
                    "rotate_adv_single_region/range_rank01_region03/normal"):
            os.makedirs(base + sub)
            for ratio in RATIOS:
                for t in ("gt", "pred"):
                    np.save(base + sub + "/ratio%d_%s_interaction.npy"
                            % (int(ratio * 100), t),
                            rng.randn(5, 7).astype(np.float32))
    return jcfg, tcfg, names


def test_plot_helpers_match_jax(interaction_tree, tmp_path):
    jcfg, tcfg, names = interaction_tree
    for out_type in ("gt", "pred"):
        for got, want in zip(
                tplots.get_interaction_normal_adv_pose(tcfg, "rotate", names,
                                                       out_type),
                jplots.get_interaction_normal_adv_pose(jcfg, "rotate", names,
                                                       out_type)):
            assert got.shape == (10, len(RATIOS))
            np.testing.assert_array_equal(got, want)
        for got, want in zip(
                tplots.get_interaction_single_region(tcfg, "rotate", names,
                                                     out_type),
                jplots.get_interaction_single_region(jcfg, "rotate", names,
                                                     out_type)):
            assert got.shape == (10, 1, len(RATIOS))
            np.testing.assert_array_equal(got, want)
    figs = {}
    for tag, mod, cfg in (("jax", jplots, jcfg), ("torch", tplots, tcfg)):
        root = str(tmp_path / tag / "figures")
        outs = [mod.plot_normal_vs_adv(cfg, "rotate", names, fig_root=root),
                mod.plot_single_region_vs_normal_avg(cfg, "rotate", names,
                                                     fig_root=root),
                mod.plot_all_models(root, datasets=("modelnet10",),
                                    model_names=("pointnet", "dgcnn"))]
        assert all(os.path.getsize(p) > 0 for p in outs)
        figs[tag] = root
    # the aggregates the composite figure reads are the same arrays
    agg = "/interaction_final_modelnet10/"
    npys = sorted(f for f in os.listdir(figs["torch"] + agg)
                  if f.endswith(".npy"))
    assert len(npys) == 6
    assert npys == sorted(f for f in os.listdir(figs["jax"] + agg)
                          if f.endswith(".npy"))
    for f in npys:
        np.testing.assert_array_equal(np.load(figs["torch"] + agg + f),
                                      np.load(figs["jax"] + agg + f))


def test_composite_plot_of_one_model(interaction_tree, tmp_path):
    """One model's column: the JAX package's plot_all_models indexes a row
    where np.atleast_2d left a column and raises; the port's draws it."""
    jcfg, tcfg, names = interaction_tree
    root = str(tmp_path / "figures")
    tplots.plot_single_region_vs_normal_avg(tcfg, "rotate", names,
                                            fig_root=root)
    with pytest.raises(IndexError):
        jplots.plot_all_models(root, datasets=("modelnet10",),
                               model_names=("pointnet",))
    out = tplots.plot_all_models(root, datasets=("modelnet10",),
                                 model_names=("pointnet",))
    assert os.path.getsize(out) > 0


def test_visualization_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    data = rng.randn(N, 3).astype(np.float32)
    region_id = rng.randint(0, R, N)
    values = rng.randn(R).astype(np.float32)
    for x in (0.0, 0.3, 1.0):
        assert tvis.red_gray_blue_cmp(x) == jvis.red_gray_blue_cmp(x)
        assert tvis.turbo_cmp(x) == jvis.turbo_cmp(x)
    out = tvis.scatter_regions(data, values, region_id,
                               str(tmp_path / "regions.png"), title="t",
                               cmap=tvis.red_gray_blue_cmp, region_bold=2)
    assert os.path.getsize(out) > 1000
    out = tvis.visualize_fps_center(data, np.arange(R), str(tmp_path / "fps.png"))
    assert os.path.getsize(out) > 1000


def test_results_package_does_not_import_matplotlib():
    import subprocess
    import sys
    code = ("import sys, interpret_quality_tpu_torch.results, "
            "interpret_quality_tpu_torch.cli.result; "
            "assert 'matplotlib' not in sys.modules")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   env=dict(os.environ, PYTHONPATH=repo), timeout=120)


# ------------------------------------------------ the port's CLIs end to end
FLOAT = re.compile(r"[-+]?(?:\d+\.\d+|nan|inf)")


def _cli(name, argv):
    import importlib
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.import_module(
            f"interpret_quality_tpu_torch.cli.{name}").main(argv)
    return out.getvalue()


def test_port_clis_write_a_tree_that_results_read(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)                # save_fps writes into the cwd
    common = ["--model", "gcnn", "--synthetic", "--allow_random_init",
              "--device", "cpu", "--checkpoints_root", str(tmp_path / "ck"),
              "--num_points", str(N), "--num_regions", str(R),
              "--num_samples_save", "6", "--num_samples", "6",
              "--shapley_batch_size", "3", "--interaction_batch_size", "16",
              "--samples", "0,1"]
    _cli("save_fps", common)
    _cli("shapley_value", common)
    _cli("enum", common + ["--mode", "trans", "--max_poses", "3"])
    _cli("smoothness_enum", common + ["--modes", "linearity",
                                      "--max_epochs", "2"])
    inter = common + ["--mode", "trans"]
    _cli("gen_pair", inter + ["--num_pairs_random", "2",
                              "--num_save_context_max", "2"])
    _cli("interaction_logits", inter)
    _cli("cal_interactions", inter)
    rows = {}
    for mode in ("sensitivity", "correlation", "smoothness"):
        text = _cli("result", common + ["--result_mode", mode])
        rows[mode] = [FLOAT.findall(line) for line in text.splitlines()]
    # sensitivity: the trans enumeration and the linearity smoothness run
    assert [len(r) for r in rows["sensitivity"]] == [2, 2]
    assert [len(r) for r in rows["correlation"]] == [2]
    assert [len(r) for r in rows["smoothness"]] == [2]
    values = np.array([float(v) for r in rows.values() for line in r
                       for v in line])
    assert np.isfinite(values).all(), rows
    fig_root = str(tmp_path / "figures")
    for plot_mode in ("normal_vs_adv", "single_region_vs_normal_avg"):
        path = _cli("plot_interaction", inter + [
            "--plot_mode", plot_mode, "--fig_root", fig_root]).strip()
        assert os.path.getsize(path) > 0
    agg = f"{fig_root}/interaction_final_modelnet10/gcnn_modelnet10_"
    for tag in ("mean_inter_normal", "mean_inter_adv",
                "mean_inter_single_region"):
        arr = np.load(agg + tag + ".npy")
        assert arr.shape[0] == 2 and arr.shape[-1] == len(RATIOS)
        assert np.isfinite(arr).all()
    assert not torch.cuda.is_initialized()
