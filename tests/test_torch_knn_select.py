"""The JAX package's kNN selection settings in the port: ``IQTPU_KNN_SELECT``
(two_pass, argmin, packed, succ, hier, bf16), ``IQTPU_KNN_LAYOUT`` (qn, nq)
and ``IQTPU_ENUM_PLAN``.

Each setting is one of three selection classes (``config.knn_select_class``),
an exact (key, index) selection on a key made from the f32 distance
(``ops.precision.selection_keys``): the distance (exact), its bits with
the low (N - 1).bit_length() cleared (packed), or its bf16 rounding (bf16).
Kernel 3 at layout nq is always packed.  The port's plain kNN, kNN-extrema
and kNN-density are held against the Pallas functions in interpret mode at
each setting, on one batch of four cases: a 4-way-tied cloud (JAX's
``tests/test_knn_select.py`` fixture), two masked coalitions of a cloud on a
1/64 grid (exact distances on both sides), JAX's truncation example (two
distances one ulp apart: packed and bf16 merge them) and a pair of
distances 2^-9 apart (bf16 merges them, packed does not).

Tolerances:
  * the Pallas kernels' indices exactly equal to a stable sort of the
    class's keys of their own distances (the class's claim, held on the
    JAX side alone);
  * indices exactly equal, apart from rows where the two sides' f32
    distances give different keys (a distance on the other side of a
    truncation or rounding boundary): the test recomputes both sides'
    distances (the Pallas kernels' own tile function), counts such rows,
    and excuses a differing row only there;
  * kernel 3's extrema within 5e-5 at parts=2 (the JAX side carries values
    as a bf16 hi/lo pair, about 2^-16 relative) and exactly equal at
    parts=1 (both sides round each value to bf16), on rows with the same
    neighbours;
  * kernel 6's indices, densities and density max exactly equal;
  * the slice: GCNN's Shapley values and logits through a packed plan
    within rtol 1e-4 / atol 1e-4 (tests/test_torch_engine.py's tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.attrib import shapley as jsh
from interpret_quality_tpu.attrib import stages as jstages
from interpret_quality_tpu.config import ExperimentConfig as JConfig
from interpret_quality_tpu.models import make_forward_fn as j_forward
from interpret_quality_tpu.ops.pallas import knn_pallas, knn_with_density
from interpret_quality_tpu.ops.pallas import neighbors as jnb
from interpret_quality_tpu_torch import config
from interpret_quality_tpu_torch.attrib import shapley as tsh
from interpret_quality_tpu_torch.attrib import stages as tstages
from interpret_quality_tpu_torch.attrib.coalitions import (
    keep_matrix_from_orders, masked_coalitions)
from interpret_quality_tpu_torch.attrib.perturbations import MODES
from interpret_quality_tpu_torch.config import ExperimentConfig as TConfig
from interpret_quality_tpu_torch.models import (build_model, dgcnn,
                                                make_forward_fn, registry)
from interpret_quality_tpu_torch.models.convert import state_dict_from_jax
from interpret_quality_tpu_torch.ops import precision as pr
from interpret_quality_tpu_torch.ops.cuda import emulation as em
from interpret_quality_tpu_torch.ops.cuda import groups as gr
from interpret_quality_tpu_torch.ops.cuda import neighbors as nb
from interpret_quality_tpu_torch.ops.geometry import (sorted_topk_indices,
                                                      square_distance)

from test_torch_models import random_variables

SELECTS = sorted(config.KNN_SELECT_CLASSES)
B, N, C, F, K, S6 = 6, 64, 4, 8, 7, 32
EXTREMA_TOL = dict(rtol=5e-5, atol=5e-5)
TRUNCATION = [np.nextafter(np.float32(5.0), np.float32(6.0)), 5.0, 1.0, 2.0,
              7.0, 8.0, 9.0, 10.0]        # tests/test_knn_select.py:69-84
MERGE = [1.001, 1.0, 0.5, 0.7, 3.0, 4.0, 5.0, 6.0]   # 1.002001 vs 1.0


def _line_cloud(xs):
    """The example's points on the x axis, the origin at row 8, the other
    rows far out (x = 20, 21, ...): (N, C)."""
    x = np.zeros((N, C), np.float32)
    x[:8, 0] = xs
    x[9:, 0] = 20.0 + np.arange(N - 9)
    return x


@pytest.fixture(scope="module")
def batch():
    """(queries, database): (B, N, C) each.  Clouds 0-1 the tied cloud,
    2-3 masked coalitions on a 1/64 grid (queries = database), 4 the
    truncation example and 5 the bf16 merge, queried from the origin."""
    rng = np.random.RandomState(3)
    base = rng.randn(2, 16, C).astype(np.float32)
    tied = np.concatenate([base] * 4, axis=1)
    rng = np.random.RandomState(7)
    grid = (np.round(rng.randn(N, 3) * 16) / 64).astype(np.float32)
    centre = np.round(grid.mean(0) * 64) / 64
    region_id = np.arange(N) % 4
    keep = keep_matrix_from_orders(np.array([[2, 0, 3, 1]]))
    masked = masked_coalitions(torch.from_numpy(grid),
                               torch.from_numpy(centre.astype(np.float32)),
                               torch.from_numpy(keep),
                               torch.from_numpy(region_id)).numpy()[1:3]
    masked = np.concatenate([masked, np.zeros((2, N, C - 3), np.float32)], -1)
    lines = np.stack([_line_cloud(TRUNCATION), _line_cloud(MERGE)])
    db = np.concatenate([tied, masked, lines])
    q = np.concatenate([tied, masked, np.zeros_like(lines)])
    return q, db


def _jax_dist(q, db, layout="qn"):
    """The Pallas kernels' distance tiles, cloud by cloud, at the kernels'
    block shapes (one block of queries here)."""
    qn = jax.jit(jnb._dist_tile)

    @jax.jit
    def nq(xdb, xqt):                  # _extrema_kernel_nq's distances
        inner = jax.lax.dot_general(xdb, xqt, (((1,), (0,)), ((), ())),
                                    precision=jax.lax.Precision.HIGHEST,
                                    preferred_element_type=jnp.float32)
        d2 = jnp.sum(xdb * xdb, axis=1, keepdims=True)
        q2 = jnp.sum(xqt * xqt, axis=0, keepdims=True)
        return (d2 - 2.0 * inner + q2).T
    if layout == "qn":
        return np.stack([np.asarray(qn(q[b], db[b].T)) for b in range(len(q))])
    return np.stack([np.asarray(nq(db[b], q[b].T)) for b in range(len(q))])


def _excusable(q, db, cls, layout="qn"):
    """Rows (B, S) where a key differs between the two sides' distances at
    a column whose key lies at or below the row's k-th key on either side.
    Elsewhere both sides' k smallest keys, and so their selections, are
    the same."""
    port = square_distance(torch.from_numpy(q), torch.from_numpy(db),
                           "highest")
    jax_d = torch.from_numpy(_jax_dist(q, db, layout))
    keys = [pr.selection_keys(d, cls) for d in (port, jax_d)]
    near = torch.zeros(keys[0].shape, dtype=torch.bool)
    for key in keys:
        near |= key <= key.sort(-1).values[..., K - 1:K]
    return ((keys[0] != keys[1]) & near).any(-1).numpy()


def _own_keys_selection(q, db, cls):
    """The k smallest keys of the Pallas kernels' own distances at the
    class, ties to the lowest index: what the class claims they select."""
    keys = pr.selection_keys(torch.from_numpy(_jax_dist(q, db)), cls)
    return torch.sort(keys, dim=-1, stable=True).indices[..., :K].int().numpy()


def _check_rows(differ, excusable, what):
    """A row may differ only where it is excusable; the grid clouds (2-3)
    have exact distances on both sides, so none of theirs is."""
    assert not (differ & ~excusable).any(), (
        what, np.argwhere(differ & ~excusable)[:5])
    assert not excusable[2:4].any(), (what, np.argwhere(excusable[2:4])[:5])
    print(f"{what}: {int(differ.sum())} rows differ, "
          f"{int(excusable.sum())} of {excusable.size} excusable")


# ----------------------------------------------------------- kernel 1
@pytest.mark.parametrize("select", SELECTS)
def test_knn_plain_equals_pallas(batch, select):
    q, db = batch
    cls = config.knn_select_class(select)
    got = nb.knn(torch.from_numpy(q), torch.from_numpy(db), K,
                 select=select).numpy()
    want = np.asarray(knn_pallas(jnp.asarray(q), jnp.asarray(db), K,
                                 select=select, interpret=True))
    np.testing.assert_array_equal(want, _own_keys_selection(q, db, cls))
    _check_rows((got != want).any(-1), _excusable(q, db, cls), select)
    # the example clouds' distances are exact on both sides
    np.testing.assert_array_equal(got[2:], want[2:])
    merged = cls != "exact"
    assert list(got[4, 0, 3:5]) == ([0, 1] if merged else [1, 0])
    assert list(got[5, 0, 3:5]) == ([0, 1] if cls == "bf16" else [1, 0])


# ----------------------------------------------------------- kernel 3
@pytest.mark.parametrize("layout", config.KNN_LAYOUTS)
@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("select", SELECTS)
def test_knn_gather_extrema_plain_equals_pallas(batch, select, parts, layout,
                                                monkeypatch):
    """The port's wrapper on the CPU with ``select`` named follows the
    process's layout, as the JAX function does."""
    _, db = batch
    monkeypatch.setenv("IQTPU_KNN_LAYOUT", layout)
    cls = config.knn_select_class(select, layout, "knn_gather_extrema")
    a = np.random.RandomState(4).randn(B, N, F).astype(np.float32)
    got = nb.knn_gather_extrema(torch.from_numpy(db), torch.from_numpy(a), K,
                                parts=parts, select=select)
    want = jnb._knn_gather_extrema(jnp.asarray(db), jnp.asarray(a), K,
                                   block_q=N, parts=parts, select=select,
                                   layout=layout, interpret=True)
    tol = EXTREMA_TOL if parts == 2 else dict(rtol=0, atol=0)
    differ = np.zeros((B, N), bool)
    for g, w in zip(got, want):
        w = np.asarray(w)
        differ |= ~np.isclose(g.numpy(), w, **tol).all(-1)
    _check_rows(differ, _excusable(db, db, cls, layout),
                (select, parts, layout))
    idx = sorted_topk_indices(square_distance(
        torch.from_numpy(db), torch.from_numpy(db), "highest"), K, cls)
    for g, w in zip(got, nb.gather_extrema_plain(idx, torch.from_numpy(a),
                                                 parts)):
        assert torch.equal(g, w)


# ----------------------------------------------------------- kernel 6
@pytest.mark.parametrize("select", SELECTS)
def test_knn_with_density_plain_equals_pallas(batch, select):
    q, db = batch
    q, db = q[:, :S6, :3].copy(), db[..., :3].copy()
    cls = config.knn_select_class(select)
    inv = np.random.RandomState(5).rand(B, N).astype(np.float32)
    got = gr.knn_with_density(torch.from_numpy(q), torch.from_numpy(db),
                              torch.from_numpy(inv), K, select=select)
    want = [np.asarray(w) for w in knn_with_density(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(inv), K, select=select,
        interpret=True)]
    np.testing.assert_array_equal(want[0], _own_keys_selection(q, db, cls))
    differ = (got[0].numpy() != want[0]).any(-1)
    _check_rows(differ, _excusable(q, db, cls), select)
    same = ~differ
    np.testing.assert_array_equal(got[1].numpy()[same], want[1][same])
    np.testing.assert_array_equal(got[2].numpy()[same], want[2][same])
    merged = cls != "exact"
    assert list(got[0][4, 0, 3:5].numpy()) == ([0, 1] if merged else [1, 0])


# ------------------------------------------------ the xyz route's emulation
@pytest.mark.parametrize("cls", ["exact", "packed", "bf16"])
@pytest.mark.parametrize("k", [7, 32, 64])
def test_select_knn_xyz_at_each_class(cls, k):
    """The xyz route's selection, step for step, at each class: equal to a
    stable sort of the same keys on a random cloud, and to the plain
    version on the 1/64 grid (exact distances: the chain and the product
    agree).  k = 32 hands the list two keys a lane, k = 64 two list
    registers (kernel 6's SA2)."""
    rng = np.random.RandomState(11)
    rnd = torch.from_numpy(rng.randn(3, N, 3).astype(np.float32))
    grid = torch.from_numpy((np.round(rng.randn(3, N, 3) * 8) / 64
                             ).astype(np.float32))
    got = em.select_knn_xyz(rnd, rnd, k, cls).idx
    keys = em.square_distance_chain(rnd, rnd, cls) + 0.0
    assert torch.equal(got, torch.sort(keys, dim=-1, stable=True).indices[
        ..., :k].int())
    assert torch.equal(em.select_knn_xyz(grid, grid, k, cls).idx,
                       gr.knn_with_density_plain(grid, grid, torch.ones(3, N),
                                                 k, cls)[0])


# ------------------------------------------------------------- settings
def test_selection_classes():
    assert {s: config.knn_select_class(s) for s in SELECTS} == {
        "argmin": "exact", "bf16": "bf16", "hier": "packed",
        "packed": "packed", "succ": "packed", "two_pass": "exact"}
    for s in SELECTS:
        assert config.knn_select_class(s, "nq", "knn_gather_extrema") == \
            "packed"
        assert config.knn_select_class(s, "nq") == config.knn_select_class(s)
    for bad in (("greedy",), ("packed", "kn"), ("packed", "qn", "fps")):
        with pytest.raises(ValueError):
            config.knn_select_class(*bad)


def test_packed_keys_clear_the_index_bits():
    d = torch.tensor([[-1e-7, 0.0, 25.0, float(TRUNCATION[0]) ** 2, 1.0]])
    d = torch.cat([d, torch.zeros(1, 3)], -1)            # N = 8: 3 bits
    keys = pr.selection_keys(d, "packed")
    assert keys[0, 0] == 0.0 and not torch.signbit(keys[0, 0])
    assert keys[0, 2] == keys[0, 3] == 25.0
    bits = keys.view(torch.int32)
    assert int((bits & 7).abs().sum()) == 0
    assert pr.selection_keys(torch.tensor([1.002001, 1.0]), "bf16")[0] == 1.0
    with pytest.raises(ValueError):
        pr.selection_keys(d.double(), "packed")


def test_unknown_settings_raise(monkeypatch):
    x = torch.randn(1, 16, 3)
    with pytest.raises(ValueError):
        nb.knn(x, x, 4, select="greedy")
    monkeypatch.setenv("IQTPU_KNN_SELECT", "greedy")
    with pytest.raises(ValueError):
        nb.knn(x, x, 4)
    with pytest.raises(ValueError):
        config.knn_select()
    monkeypatch.setenv("IQTPU_KNN_SELECT", "packed")
    monkeypatch.setenv("IQTPU_KNN_LAYOUT", "kn")
    with pytest.raises(ValueError):
        nb.knn_gather_extrema(x, x, 4)


def test_cpu_tensors_stay_exact_under_the_variable(monkeypatch):
    """On the CPU ``select=None`` is exact whatever the process's setting
    (the JAX package's CPU path is XLA's top_k); a named setting holds."""
    db = torch.from_numpy(_line_cloud(TRUNCATION)[None, :, :3].copy())
    q = torch.zeros_like(db)
    a = torch.randn(1, N, F)
    inv = torch.rand(1, N)
    monkeypatch.setenv("IQTPU_KNN_SELECT", "packed")
    monkeypatch.setenv("IQTPU_KNN_LAYOUT", "nq")
    exact = nb.knn_plain(q, db, K)
    assert torch.equal(nb.knn(q, db, K), exact)
    assert not torch.equal(nb.knn(q, db, K, select="packed"), exact)
    assert torch.equal(gr.knn_with_density(q, db, inv, K)[0], exact)
    for g, w in zip(nb.knn_gather_extrema(db, a, K),
                    nb.knn_gather_extrema_plain(db, a, K)):
        assert torch.equal(g, w)
    assert torch.equal(nb.knn_gather_extrema(db, a, K, select="two_pass")[0],
                       nb.knn_gather_extrema_plain(db, a, K, cls="packed")
                       [0])


def test_graph_knn_is_exact(monkeypatch):
    """The un-fused path's graphs (training, the BIM attack) take exact
    selection at every setting, as the JAX package's XLA top_k does."""
    seen = []

    def record(query, database, k, select=None):
        seen.append(select)
        return nb.knn(query, database, k, select=select)
    monkeypatch.setattr(dgcnn, "knn", record)
    monkeypatch.setenv("IQTPU_KNN_SELECT", "bf16")
    model = build_model("dgcnn", 10, 4)
    model(torch.randn(2, 16, 3), fused=False)
    assert seen == ["two_pass"] * 4


# ------------------------------------------------------------ the slice
def test_gcnn_shapley_through_a_packed_plan_matches_jax():
    """GCNN's Shapley values for one pose through a packed plan: the
    port's ``knn(select="packed")`` against the JAX model's un-fused path
    on a plan from ``knn_pallas(select="packed", interpret=True)``."""
    n, r, s = 64, 4, 4
    jmodel, variables = random_variables("gcnn", seed=4)
    model = build_model("gcnn", num_classes=10, k=20)
    model.load_state_dict(state_dict_from_jax("gcnn", variables), strict=True)
    jfwd, fwd = j_forward(jmodel, variables), make_forward_fn(model)
    rng = np.random.RandomState(12)
    cloud = rng.randn(n, 3).astype(np.float32)
    region_id = np.arange(n) % r
    orders = np.stack([rng.permutation(r) for _ in range(s)])
    params = np.zeros((1, 3), np.float32)
    disturb = MODES["trans"].disturb_fn
    engine = tsh.ShapleyEngine(fwd, num_regions=r, batch_orders=2,
                               device="cpu")
    jengine = jsh.ShapleyEngine(jfwd, num_regions=r, batch_orders=2)
    got = engine.enum_all_poses_plan(
        disturb, cloud, params, 2, region_id, orders,
        lambda x: nb.knn(x, x, 20, select="packed"), fwd.apply_plan_fn)
    want = jengine.enum_all_poses_plan(
        disturb, jnp.asarray(cloud), params, 2, region_id, orders,
        lambda x: knn_pallas(x, x, 20, select="packed", interpret=True),
        jfwd.apply_plan_fn)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- IQTPU_ENUM_PLAN
def test_enum_without_plan_matches_jax(tmp_path, monkeypatch):
    """IQTPU_ENUM_PLAN=0: the port's run_enum never builds a plan, and its
    Shapley values equal the JAX run_enum's under the same variable."""
    monkeypatch.setenv("IQTPU_ENUM_PLAN", "0")
    _, variables = random_variables("gcnn", seed=6)
    t7 = str(tmp_path / "model_best.t7")
    torch.save(state_dict_from_jax("gcnn", variables), t7)

    def no_plan(self, x):
        raise AssertionError("a plan was built with IQTPU_ENUM_PLAN=0")
    monkeypatch.setattr(registry.ForwardFn, "plan_fn", no_plan)
    small = dict(model="gcnn", model_path=t7, num_points=64, num_regions=4,
                 num_samples_save=4, num_samples=4, shapley_batch_size=2)
    out = {}
    for name, stages, cfg_type, extra in (
            ("jax", jstages, JConfig, {}),
            ("torch", tstages, TConfig, {"device": "cpu"})):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)      # save_fps writes into the cwd
        cfg = cfg_type(checkpoints_root=str(tmp_path / name / "ck"),
                       **small, **extra)
        stages.save_fps(cfg, synthetic=True)
        stages.run_shapley_init(cfg, synthetic=True, sample_indices=[0])
        stages.run_enum(cfg, "trans", synthetic=True, sample_indices=[0],
                        max_poses=2)
        out[name] = np.load(cfg.exp_folder
                            + "synthetic_00/trans_all/region_shapley_value.npy")
    assert out["torch"].shape == (2, 4)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-4, atol=1e-4)
