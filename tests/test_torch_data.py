"""The port's datasets, augmentations and native host helpers against the
JAX package's, on fixture trees written under ``tmp_path``.

Both packages read the same files, so the eval sets must give the same
items, labels and folder names and bit-equal clouds; the training sets
draw from numpy's global stream, so after the same ``np.random.seed`` they
must give bit-equal clouds too.  The native helpers run twice: on a private
build of ``native/iqtpu_host.cpp`` (the flags of ``scripts/build_native.sh``)
and on their numpy fallback (``IQTPU_NO_NATIVE=1``).
"""
import json
import os
import subprocess

import numpy as np
import pytest

from interpret_quality_tpu.data import augment as jaug
from interpret_quality_tpu.data import datasets as jds
from interpret_quality_tpu.data import native as jnative
from interpret_quality_tpu_torch.data import augment as taug
from interpret_quality_tpu_torch.data import datasets as tds
from interpret_quality_tpu_torch.data import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELNET_NAMES = ["chair_0001", "toilet_0003", "night_stand_0007"]
SHAPENET = {"02773838": ["aaaa0001", "aaaa0002"],      # Bag
            "03624134": ["bbbb0001"],                  # Knife
            "03642806": ["cccc0001"]}                  # Laptop


def write_modelnet(root, names, rows=300, seed=2):
    """modelnet10_numpy/<class>/<name>.npy (rows x 6) and the train list."""
    ddir = os.path.join(root, "modelnet10_numpy")
    rng = np.random.RandomState(seed)
    for name in names:
        os.makedirs(os.path.join(ddir, name[:-5]), exist_ok=True)
        np.save(os.path.join(ddir, name[:-5], name + ".npy"),
                rng.randn(rows, 6).astype(np.float32))
    with open(os.path.join(ddir, "modelnet10_train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def write_shapenet(root, uuids, rows=400, seed=7):
    """<cat>/points/<uuid>.pts and the shuffled train split; returns the
    split's entries."""
    base = os.path.join(root, "shapenetcore_partanno_segmentation_benchmark_v0")
    rng = np.random.RandomState(seed)
    rel = []
    for cat, ids in uuids.items():
        os.makedirs(os.path.join(base, cat, "points"), exist_ok=True)
        for uuid in ids:
            pts = (rng.randn(rows, 3) * [1.0, 0.5, 2.0]).astype(np.float32)
            np.savetxt(os.path.join(base, cat, "points", uuid + ".pts"), pts,
                       fmt="%.6f")
            rel.append(f"shape_data/{cat}/{uuid}")
    os.makedirs(os.path.join(base, "train_test_split"), exist_ok=True)
    with open(os.path.join(base, "train_test_split",
                           "shuffled_train_file_list.json"), "w") as f:
        json.dump(rel, f)
    return rel


@pytest.fixture()
def trees(tmp_path):
    """A data root with both datasets and a misc dir naming their samples."""
    root, misc = str(tmp_path / "data"), tmp_path / "misc"
    misc.mkdir()
    write_modelnet(root, MODELNET_NAMES)
    rel = write_shapenet(root, SHAPENET)
    (misc / "modelnet10_train_final30.txt").write_text(
        "\n".join(MODELNET_NAMES) + "\n")
    (misc / "shapenet_train_selected.json").write_text(json.dumps(rel))
    return root, str(misc)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """A private build of the host library, so no other test's build of
    build/libiqtpu_host.so is raced."""
    out = str(tmp_path_factory.mktemp("native") / "libiqtpu_host.so")
    subprocess.run(["g++", "-O3", "-march=native", "-ffp-contract=off",
                    "-shared", "-fPIC",
                    os.path.join(REPO, "native", "iqtpu_host.cpp"), "-o", out],
                   check=True)
    return out


@pytest.fixture(params=["library", "numpy"])
def host_path(request, native_lib, monkeypatch):
    """Both packages' native helpers on the library, or on numpy."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_SO_PATH", native_lib)
        monkeypatch.setattr(mod, "_lib", None)
    if request.param == "numpy":
        monkeypatch.setenv("IQTPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("IQTPU_NO_NATIVE", raising=False)
    yield request.param
    for mod in (jnative, tnative):
        mod._lib = None
    assert tnative.available() == jnative.available()


def test_native_helpers_match_jax(host_path, tmp_path):
    assert tnative.available() == (host_path == "library")
    rng = np.random.RandomState(3)
    pts = rng.randn(517, 3).astype(np.float32)
    path = str(tmp_path / "cloud.pts")
    with open(path, "w") as f:
        for p in pts:
            f.write(f"{p[0]:.7g} {p[1]:.7g} {p[2]:.7g} 0.5 1\n")   # + normals
    got, want = tnative.parse_pts(path), jnative.parse_pts(path)
    assert got.shape == (517, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnative.parse_pts(path, cols=5),
                                  jnative.parse_pts(path, cols=5))
    idx = tnative.fps(pts, 64)
    np.testing.assert_array_equal(idx, jnative.fps(pts, 64))
    np.testing.assert_array_equal(idx, tds.farthest_point_sample_np(pts, 64))
    batch = rng.randn(3, 200, 3).astype(np.float32)
    np.testing.assert_array_equal(tnative.fps_batch(batch, 16),
                                  jnative.fps_batch(batch, 16))
    np.testing.assert_array_equal(tnative.region_assign(pts, pts[idx[:32]]),
                                  jnative.region_assign(pts, pts[idx[:32]]))


@pytest.mark.parametrize("dataset", ["modelnet10", "shapenet"])
def test_eval_sets_match_jax(dataset, trees, host_path):
    root, misc = trees
    ours = tds.make_eval_dataset(dataset, root, 128, misc)
    theirs = jds.make_eval_dataset(dataset, root, 128, misc)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.items == theirs.items and len(ours) > 1
    assert tds.get_folder_name_list(dataset, misc) == \
        jds.get_folder_name_list(dataset, misc)
    for i in range(len(ours)):
        (pc, label), (want, wlabel) = ours[i], theirs[i]
        assert label == wlabel and pc.dtype == np.float32
        assert pc.shape == (128, 3)
        np.testing.assert_array_equal(pc, want)
    if dataset == "modelnet10":      # the first 128 rows of the file
        path, _ = ours.items[0]
        np.testing.assert_array_equal(ours[0][0], np.load(path)[:128, :3])


@pytest.mark.parametrize("dataset", ["modelnet10", "shapenet"])
def test_train_sets_match_jax(dataset, trees, host_path):
    root, _ = trees
    flags = dict(drop_point=True, rot_y=True, rot_all=True)
    if dataset == "modelnet10":
        ours = tds.ModelNetTrain(root, 64, "train", **flags)
        theirs = jds.ModelNetTrain(root, 64, "train", **flags)
    else:
        ours = tds.ShapeNetTrain(root, 64, "train", **flags)
        theirs = jds.ShapeNetTrain(root, 64, "train", **flags)
    assert ours.items == theirs.items and ours.train and len(ours) == 3 + (
        dataset == "shapenet")
    for i in range(len(ours)):
        np.random.seed(17 + i)
        pc, label = ours[i]
        np.random.seed(17 + i)
        want, wlabel = theirs[i]
        assert label == wlabel and pc.dtype == np.float32
        np.testing.assert_array_equal(pc, want)


@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_pad_the_tail_as_jax(trees, shuffle):
    root, _ = trees
    ours = tds.ShapeNetTrain(root, 32, "train")
    theirs = jds.ShapeNetTrain(root, 32, "train")
    np.random.seed(4)
    got = list(ours.batches(3, shuffle=shuffle, rng=np.random.RandomState(4)))
    np.random.seed(4)
    want = list(theirs.batches(3, shuffle=shuffle,
                               rng=np.random.RandomState(4)))
    assert [v for *_, v in got] == [v for *_, v in want] == [3, 1]
    for (d, lab, _), (wd, wlab, _) in zip(got, want):
        assert d.shape == (3, 32, 3) and lab.dtype == np.int32
        np.testing.assert_array_equal(lab, wlab)
        np.testing.assert_array_equal(d, wd)
    assert (got[-1][1] == got[-1][1][0]).all()      # the tail repeats its item


AUGMENTATIONS = ["translate_pointcloud", "jitter_pointcloud",
                 "scale_pointcloud", "rotate_perturbation_point_cloud",
                 "rotate_point_cloud_z", "rotate_point_cloud_y",
                 "random_dropout_pointcloud"]


@pytest.mark.parametrize("name", AUGMENTATIONS)
def test_augmentations_match_jax(name):
    pc = np.random.RandomState(5).randn(100, 3).astype(np.float32)
    np.random.seed(9)
    got = getattr(taug, name)(pc)
    np.random.seed(9)
    want = getattr(jaug, name)(pc)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if name == "random_dropout_pointcloud":
        np.testing.assert_array_equal(pc, np.random.RandomState(5).randn(
            100, 3).astype(np.float32))          # the input is left alone


@pytest.mark.parametrize("train", [False, True])
def test_synthetic_clouds_match_jax(train):
    flags = dict(train=train, drop_point=train, rot_y=train, rot_all=train)
    ours = tds.SyntheticClouds(6, 96, 10, seed=3, **flags)
    theirs = jds.SyntheticClouds(6, 96, 10, seed=3, **flags)
    np.random.seed(1)
    got = [ours[i] for i in range(6)] + list(ours.batches(4))
    np.random.seed(1)
    want = [theirs[i] for i in range(6)] + list(theirs.batches(4))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    # eval clouds leave the global stream alone; training clouds draw on it
    np.random.seed(2)
    ours[0]
    untouched = np.random.rand() == np.random.RandomState(2).rand()
    assert untouched == (not train)


def test_misc_files_are_the_jax_packages():
    port = os.path.join(REPO, "interpret_quality_tpu_torch", "misc")
    jax_misc = os.path.join(REPO, "interpret_quality_tpu", "misc")
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_misc))
    for name in os.listdir(jax_misc):
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(jax_misc, name), "rb") as b:
            assert a.read() == b.read(), name
    for dataset in ("modelnet10", "shapenet"):
        assert tds.get_folder_name_list(dataset) == \
            jds.get_folder_name_list(dataset)


@pytest.mark.parametrize("dataset", ["modelnet10", "shapenet"])
def test_resolve_dataset_reads_the_real_eval_set(dataset, tmp_path):
    """``synthetic=False`` gives the eval set of the package's own sample
    lists under ``data_root``, with the JAX package's folder names."""
    from interpret_quality_tpu.config import ExperimentConfig as JConfig
    from interpret_quality_tpu.pipeline import resolve_dataset as jresolve
    from interpret_quality_tpu_torch.config import ExperimentConfig
    from interpret_quality_tpu_torch.pipeline import resolve_dataset
    root = str(tmp_path / "data")
    names = tds.get_folder_name_list(dataset)
    if dataset == "modelnet10":
        write_modelnet(root, names, rows=80)
    else:
        uuids = {}
        for cat, uuid in tds._read_shapenet_selected():
            uuids.setdefault(cat, []).append(uuid)
        write_shapenet(root, uuids, rows=90)
    cfg = ExperimentConfig(model="gcnn", dataset=dataset, data_root=root,
                           num_points=64, device="cpu")
    ds, got_names = resolve_dataset(cfg, synthetic=False)
    jds_, want_names = jresolve(JConfig(model="gcnn", dataset=dataset,
                                        data_root=root, num_points=64))
    assert got_names == want_names == names and len(ds) == 30
    for i in (0, 29):
        np.testing.assert_array_equal(ds[i][0], jds_[i][0])
        assert ds[i][1] == jds_[i][1]
