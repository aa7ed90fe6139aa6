"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with nvcc and skips without one.  The
file imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""
import contextlib

import pytest
import torch

from interpret_quality_tpu_torch import config
from interpret_quality_tpu_torch.ops.cuda import dense as dn
from interpret_quality_tpu_torch.ops.cuda import fps as fp
from interpret_quality_tpu_torch.ops.cuda import groups as gr
from interpret_quality_tpu_torch.ops.cuda import launch
from interpret_quality_tpu_torch.ops.cuda import neighbors as nb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from interpret_quality_tpu_torch.ops.precision import set_matmul_precision
    set_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C,F", [(3, 64), (64, 128), (128, 256), (5, 7)])
def test_kernels_match_plain_versions(cuda, C, F):
    """kNN indices equal to knn_plain on an exact-duplicate cloud (ties
    everywhere); the fused kernel and the gather kernel bit-equal to the
    plain gather of the kNN kernel's indices; each launch counted once."""
    g = torch.Generator().manual_seed(C)
    base = torch.randn(4, 128, C, generator=g)
    xs = base.repeat(1, 8, 1).contiguous().to(cuda)
    a = torch.randn(4, 1024, F, generator=g).to(cuda)
    launch.reset_launches()
    idx = nb.knn(xs, xs, 20)
    assert torch.equal(idx, nb.knn_plain(xs, xs, 20))
    pmax, pmin = nb.gather_extrema_plain(idx, a)
    kmax, kmin = nb.knn_gather_extrema(xs, a, 20)
    gmax, gmin = nb.gather_extrema(idx, a)
    torch.cuda.synchronize()
    assert torch.equal(kmax, pmax) and torch.equal(kmin, pmin)
    assert torch.equal(gmax, pmax) and torch.equal(gmin, pmin)
    assert launch.launches("knn", "gather_extrema", "knn_gather_extrema") == {
        "knn": 1, "gather_extrema": 1, "knn_gather_extrema": 1}


@pytest.mark.cuda
def test_ragged_sizes_and_separate_queries(cuda):
    """Sizes that are not multiples of the kernels' tiles, and a query set
    apart from the database."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(3, 77, 5, generator=g).to(cuda)
    db = torch.randn(3, 100, 5, generator=g).to(cuda)
    assert torch.equal(nb.knn(q, db, 7), nb.knn_plain(q, db, 7))
    a = torch.randn(3, 100, 9, generator=g).to(cuda)
    idx = nb.knn(db, db, 32)
    for got, want in zip(nb.gather_extrema(idx, a),
                         nb.gather_extrema_plain(idx, a)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    xs = torch.randn(2, 64, 3, device=cuda)
    with pytest.raises(ValueError):
        nb.knn(xs, xs, 33)                                   # k > 32
    with pytest.raises(ValueError):
        nb.knn(xs.double(), xs.double(), 4)                  # not f32
    with pytest.raises(ValueError):
        nb.knn_gather_extrema(xs, torch.randn(2, 64, 8), 4)  # mixed devices


def _cloud(cuda, B, N, seed, collapse=True):
    """Random clouds; with ``collapse`` the second half of each cloud sits on
    its first point, as a masked coalition puts a region on the centre
    (exact ties everywhere)."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(B, N, 3, generator=g) - 0.5
    if collapse:
        xyz[:, N // 2:] = xyz[:, :1]
    return xyz.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("N,npoint", [(1024, 512), (512, 128), (256, 512),
                                      (100, 7), (300, 64), (1000, 200),
                                      (1500, 64), (2048, 33)])
def test_fps_bit_equal_to_plain(cuda, N, npoint):
    """Both routes of the kernel: the cloud in registers up to 1024 points
    (N = 100, 300 and 1000 fill no block evenly; npoint > N keeps going), in
    shared memory beyond (1500, 2048); half of every cloud sits on one point."""
    xyz = _cloud(cuda, 5, N, N)
    launch.reset_launches()
    got = fp.fps(xyz, npoint)
    assert torch.equal(got, fp.fps_plain(xyz, npoint))
    assert (got[:, 0] == 0).all() and launch.launches("fps") == {"fps": 1}
    route = fp.fps_occupancy(N)
    assert route["route"] == ("registers" if N <= fp.REGISTER_ROUTE_MAX_N
                              else "shared memory")
    assert route["blocks_per_sm"] >= 1 and launch.launches("fps") == {"fps": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 512, 1024, 1300])
def test_fps_all_points_coincide(cuda, N):
    """Every distance is 0 at every step: the lowest index wins, so the
    result is all zeros, as fps_plain's; 200 clouds are more than one SM's
    share of a small card and fewer than two of a large one."""
    xyz = torch.full((200, N, 3), 0.125, device=cuda)
    got = fp.fps(xyz, 20)
    assert torch.equal(got, fp.fps_plain(xyz, 20))
    assert int(got.abs().max()) == 0


@pytest.mark.cuda
def test_fps_refuses_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError):
        fp.fps(torch.zeros(1, fp.MAX_N + 1, 3, device=cuda), 4)
    with pytest.raises(ValueError):
        fp.fps(torch.zeros(2, 16, 2, device=cuda), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("k,collapse", [(32, True), (64, True), (20, False),
                                        (64, False)])
def test_knn_with_density_matches_plain(cuda, k, collapse):
    xyz = _cloud(cuda, 3, 256, k, collapse)
    query = xyz[:, :77].contiguous()
    inv = torch.rand(3, 256, device=cuda) + 0.5
    launch.reset_launches()
    idx, den, dmax = gr.knn_with_density(query, xyz, inv, k)
    pidx, pden, pdmax = gr.knn_with_density_plain(query, xyz, inv, k)
    assert torch.equal(idx, pidx)
    assert torch.equal(den, pden) and torch.equal(dmax, pdmax)
    assert launch.LAUNCHES["knn_with_density"] == 1


def _affine(g, cin, cout, cuda):
    return ((torch.randn(cin, cout, generator=g) / cin ** 0.5).to(cuda),
            (0.1 * torch.randn(cout, generator=g)).to(cuda))


# (widths, K, radius) of the six PointNet++ MSG branches (models/pointnet2.py)
BALL_BRANCHES = [((32, 32, 64), 16, 0.1), ((64, 64, 128), 32, 0.2),
                 ((64, 96, 128), 128, 0.4), ((64, 64, 128), 32, 0.2),
                 ((128, 128, 256), 64, 0.4), ((128, 128, 256), 128, 0.8)]


def _ball_weights(g, widths, with_uf, cuda):
    """Folded layers of one branch: b1, a1x, a2, b2, a3, b3, and the rows of
    A1 that multiply 5 input features (None without ``with_uf``)."""
    C1, C2, C3 = widths
    (a1, b1), (a2, b2), (a3, b3) = (_affine(g, 3 + (5 if with_uf else 0), C1, cuda),
                                    _affine(g, C1, C2, cuda),
                                    _affine(g, C2, C3, cuda))
    return (b1, a1[5:] if with_uf else a1, a2, b2, a3, b3), \
        (a1[:5] if with_uf else None)


@pytest.mark.cuda
@pytest.mark.parametrize("with_uf", [False, True])
@pytest.mark.parametrize("widths,k,radius", BALL_BRANCHES)
def test_ball_mlp3_matches_plain(cuda, widths, k, radius, with_uf):
    """Every branch width and K of PointNet++, with and without hoisted
    feature rows: within rtol 1e-4, atol 1e-5 of the plain version (layers
    2-3 run as three TF32 products on the tensor cores, f32 sums in another
    order); the clouds are random, so no point sits on a ball's boundary at
    f32 noise."""
    g = torch.Generator().manual_seed(k + widths[0])
    xyz = _cloud(cuda, 2, 512, k, collapse=False)
    new_xyz = xyz[:, :128].contiguous()
    w, a1f = _ball_weights(g, widths, with_uf, cuda)
    uf = None
    if with_uf:
        uf = torch.randn(2, 512, 5, generator=g).to(cuda) @ a1f
    launch.reset_launches()
    got = gr.fused_ball_mlp3(new_xyz, xyz, uf, *w, radius=radius, k=k)
    want = gr.fused_ball_mlp3_plain(new_xyz, xyz, uf, *w, radius=radius, k=k)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert launch.LAUNCHES["fused_ball_mlp3"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("with_uf", [False, True])
@pytest.mark.parametrize("B,S,empty,widths,k", [
    (3, 77, 5, (64, 64, 128), 32),
    (3, 77, 5, (128, 128, 256), 128),
    (1, 5, 1, (64, 96, 128), 128)])
def test_ball_mlp3_empty_and_overfull_balls(cuda, with_uf, B, S, empty, widths, k):
    """A centre with no point in its ball takes point 0; a centre with more
    than K members (a collapsed region: 600 copies of one point, then 300
    points around it) takes the first K in index order; 77 centres and 999
    points fill no tile and no batch evenly.  At K = 128 with streamed
    weights a centre's rows straddle two 64-row tiles and two ring stages
    (the empty balls' single rows come first); one cloud of 5 centres is
    one batch, so every block but one finds no work and must still end."""
    g = torch.Generator().manual_seed(7)
    xyz = torch.rand(B, 999, 3, generator=g) - 0.5
    xyz[:, 100:700] = xyz[:, 100:101]
    xyz[:, 700:] = xyz[:, 100:101] + 0.05 * (torch.rand(B, 299, 3, generator=g) - 0.5)
    new_xyz = xyz[:, 90:90 + S].clone()
    new_xyz[:, :empty] += 10.0                                # empty balls
    xyz, new_xyz = xyz.to(cuda), new_xyz.contiguous().to(cuda)
    w, a1f = _ball_weights(g, widths, with_uf, cuda)
    uf = torch.randn(B, 999, 5, generator=g).to(cuda) @ a1f if with_uf else None
    from interpret_quality_tpu_torch.ops.geometry import query_ball_point
    idx = query_ball_point(0.1, k, xyz, new_xyz)
    assert bool((idx[:, :empty] == 0).all())                  # empty: index 0
    inside = ((xyz[:, None] - new_xyz[:, :, None]) ** 2).sum(-1) <= 0.1 ** 2
    assert int(inside.sum(-1).max()) > (k if S > 5 else 0)   # overfull
    got = gr.fused_ball_mlp3(new_xyz, xyz, uf, *w, radius=0.1, k=k)
    want = gr.fused_ball_mlp3_plain(new_xyz, xyz, uf, *w, radius=0.1, k=k)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _selected_distance_gap(query, db, idx_a, idx_b):
    """Largest gap between two kNN selections' sorted exact (f64) distances,
    relative to the largest |x|^2: within 1e-5 the two differ only where
    candidates lie at f32 noise from each other."""
    def dist(ix):
        rows = torch.gather(db.double()[:, None].expand(-1, ix.shape[1], -1, -1),
                            2, ix.long()[..., None].expand(-1, -1, -1, db.shape[2]))
        return ((rows - query.double()[:, :, None]) ** 2).sum(-1).sort(-1).values
    scale = max(float((db.double() ** 2).sum(-1).max()),
                float((query.double() ** 2).sum(-1).max()))
    return float((dist(idx_a) - dist(idx_b)).abs().max()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 20, 32])
@pytest.mark.parametrize("C", [3, 5, 64, 128])
def test_selection_on_ragged_clouds(cuda, C, k):
    """N = 300 (no multiple of a tile) at every channel width of DGCNN.  An
    exact-duplicate cloud (100 rows, 3 times over): indices equal to
    knn_plain's, ties to the lowest index.  A random cloud with separate
    queries (S = 77): selected distances within 1e-5 of |x|^2 of
    knn_plain's.  The fused kernel: bit-equal to the plain gather of the kNN
    kernel's indices."""
    g = torch.Generator().manual_seed(100 * C + k)
    dup = torch.randn(3, 100, C, generator=g).repeat(1, 3, 1).contiguous().to(cuda)
    idx = nb.knn(dup, dup, k)
    assert torch.equal(idx, nb.knn_plain(dup, dup, k))
    a = torch.randn(3, 300, 24, generator=g).to(cuda)
    for got, want in zip(nb.knn_gather_extrema(dup, a, k),
                         nb.gather_extrema_plain(idx, a)):
        assert torch.equal(got, want)
    q = torch.randn(3, 77, C, generator=g).to(cuda)
    db = torch.randn(3, 300, C, generator=g).to(cuda)
    got, want = nb.knn(q, db, k), nb.knn_plain(q, db, k)
    assert _selected_distance_gap(q, db, got, want) <= 1e-5
    xs = db.contiguous()
    idx = nb.knn(xs, xs, k)
    assert _selected_distance_gap(xs, xs, idx, nb.knn_plain(xs, xs, k)) <= 1e-5
    for got, want in zip(nb.knn_gather_extrema(xs, a, k),
                         nb.gather_extrema_plain(idx, a)):
        assert torch.equal(got, want)


def _route_clouds(kind, B, N, C, seed):
    """Clouds for the route tests: random, on a 1/64 grid (every distance
    exact), all points on one, or masked (a random 30% kept, the rest on the
    cloud's mean, as a coalition puts its absent regions on the centre).
    grid_masked: every coordinate in {-1, -0.5, 0, 0.5, 1} (distances exact,
    rows of other classes often tied), 70% of the points from N // 3 on
    sitting on the grid point of row N // 3, so the collapsed row arrives
    after rows it ties with."""
    g = torch.Generator().manual_seed(seed)
    if kind == "grid":
        return torch.randint(-64, 64, (B, N, C), generator=g).float() / 64
    if kind == "grid_masked":
        x = torch.randint(-2, 3, (B, N, C), generator=g).float() / 2
        absent = ((torch.rand(B, N, generator=g) < 0.7)
                  & (torch.arange(N) >= N // 3))
        return torch.where(absent[..., None], x[:, N // 3:N // 3 + 1], x)
    if kind == "coincident":
        return torch.randn(B, 1, C, generator=g).expand(B, N, C).contiguous()
    x = torch.randn(B, N, C, generator=g)
    if kind == "masked":
        kept = torch.rand(B, N, 1, generator=g) < 0.3
        x = torch.where(kept, x, x.mean(1, keepdim=True))
    return x


ROUTE_SIZES = [(N, S) for N in (1, 20, 33, 100, 256, 513, 1100) for S in (N, 77)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "grid", "coincident", "masked"])
@pytest.mark.parametrize("k", [1, 20, 32, 64])
def test_knn_routes_bit_equal(cuda, kind, k):
    """Kernels 1 and 6 on both routes forced (xyz, tiled) at ragged sizes (N
    = 1 and N = k among them, N not a multiple of 32, two segments of the
    xyz route at N = 1100) and S != N: the indices, densities and maxima of
    the two routes bit-equal; on exact clouds (grid, coincident) equal to
    the plain versions, else their selected distances within 1e-5 of
    |x|^2 of the plain versions' (REL_LIMIT)."""
    X, T = nb.KNN_ROUTES["xyz"], nb.KNN_ROUTES["tiled"]
    exact = kind in ("grid", "coincident")
    for N, S in ROUTE_SIZES:
        if k > N:
            continue
        db = _route_clouds(kind, 3, N, 3, seed=N + k).to(cuda)
        q = db if S == N else _route_clouds(kind, 3, S, 3, seed=S + k).to(cuda)
        want = nb.knn_plain(q, db, k)
        inv = torch.rand(3, N, device=cuda) + 0.5
        routes = [gr._knn_with_density(q, db, inv, k, r) for r in (X, T)]
        if k <= nb.MAX_K:
            routes = [(nb._knn(q, db, k, r),) + out for r, out in zip((X, T), routes)]
        for a, b in zip(*routes):
            assert torch.equal(a, b), (N, S)
        idx = routes[0][0]
        if exact:
            assert torch.equal(idx, want), (N, S)
        else:
            assert _selected_distance_gap(q, db, idx, want) <= 1e-5, (N, S)
        pidx, pden, pdmax = gr.knn_with_density_plain(q, db, inv, k)
        same = (idx == pidx).all(-1)
        den, dmax = routes[0][-2:]
        assert torch.equal(den[same], pden[same])
        assert torch.equal(dmax[same], pdmax[same])


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["packed", "bf16"])
@pytest.mark.parametrize("kind", ["grid", "coincident", "masked"])
@pytest.mark.parametrize("k", [20, 64])
def test_knn_select_classes_on_both_routes(cuda, cls, kind, k):
    """Kernels 1 and 6 at the kNN selection classes packed and bf16
    (IQTPU_KNN_SELECT), on both routes forced at ragged sizes: bit-equal to
    each other; on exact clouds (grid, coincident) equal to the plain
    versions at the class; each launch counted under its route."""
    X, T = nb.KNN_ROUTES["xyz"], nb.KNN_ROUTES["tiled"]
    launch.reset_launches()
    for N, S in ROUTE_SIZES:
        if k > N:
            continue
        db = _route_clouds(kind, 3, N, 3, seed=N + k).to(cuda)
        q = db if S == N else _route_clouds(kind, 3, S, 3, seed=S + k).to(cuda)
        inv = torch.rand(3, N, device=cuda) + 0.5
        routes = [gr._knn_with_density(q, db, inv, k, r, cls) for r in (X, T)]
        if k <= nb.MAX_K:
            routes = [(nb._knn(q, db, k, r, cls),) + out
                      for r, out in zip((X, T), routes)]
        for a, b in zip(*routes):
            assert torch.equal(a, b), (N, S)
        if kind != "masked":
            assert torch.equal(routes[0][0],
                               gr.knn_with_density_plain(q, db, inv, k, cls)[0])
    assert launch.LAUNCHES[f"knn_with_density:{cls}"] > 0
    assert launch.LAUNCHES[f"knn:{cls}"] == (
        launch.LAUNCHES[f"knn_with_density:{cls}"] if k <= nb.MAX_K else 0)
    launch.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 64])
def test_knn_gather_extrema_select_classes(cuda, C):
    """Kernel 3 at each class on an exact-duplicate cloud: equal to its
    plain version at the class and to the gather of kernel 1's indices;
    at IQTPU_KNN_LAYOUT=nq the packed class whatever IQTPU_KNN_SELECT;
    an unknown setting raises."""
    import os
    g = torch.Generator().manual_seed(C)
    xs = torch.randn(4, 128, C, generator=g).repeat(1, 8, 1).contiguous().to(cuda)
    a = torch.randn(4, 1024, 32, generator=g).to(cuda)
    for select in ("two_pass", "packed", "bf16"):
        got = nb.knn_gather_extrema(xs, a, 20, select=select)
        cls = config.knn_select_class(select)
        for g_, w in zip(got, nb.knn_gather_extrema_plain(xs, a, 20, 2, cls)):
            assert torch.equal(g_, w), select
        idx = nb.knn(xs, xs, 20, select=select)
        for g_, w in zip(got, nb.gather_extrema(idx, a)):
            assert torch.equal(g_, w), select
    packed = nb.knn_gather_extrema(xs, a, 20, select="packed")
    saved = {k: os.environ.get(k) for k in ("IQTPU_KNN_SELECT",
                                            "IQTPU_KNN_LAYOUT")}
    try:
        os.environ.update(IQTPU_KNN_SELECT="bf16", IQTPU_KNN_LAYOUT="nq")
        for g_, w in zip(nb.knn_gather_extrema(xs, a, 20), packed):
            assert torch.equal(g_, w)
        os.environ["IQTPU_KNN_SELECT"] = "greedy"
        with pytest.raises(ValueError):
            nb.knn(xs, xs, 20)
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    launch.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 20, 32])
@pytest.mark.parametrize("C", [3, 64, 128])
@pytest.mark.parametrize("kind", ["masked", "coincident"])
def test_knn_gather_extrema_compacted_scan(cuda, kind, C, k):
    """Kernel 3 scans a cloud's distinct rows only, each entering the lists
    with its copies: at N = 300 and 1024 its extrema are bit-equal to the
    plain gather of kernel 1's indices (a scan of every row), the collapsed
    centre's copies past entry k - 1 falling off (it has more than 32)."""
    g = torch.Generator().manual_seed(k)
    for N in (300, 1024):
        xs = _route_clouds(kind, 3, N, C, seed=N + C + k).to(cuda)
        a = torch.randn(3, N, 24, generator=g).to(cuda)
        idx = nb.knn(xs, xs, k)
        for got, want in zip(nb.knn_gather_extrema(xs, a, k),
                             nb.gather_extrema_plain(idx, a)):
            assert torch.equal(got, want), N


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 20, 32])
@pytest.mark.parametrize("C", [3, 64, 128])
def test_knn_gather_extrema_ties_across_rows(cuda, C, k):
    """grid_masked clouds (every distance exact, rows of other classes tied
    with the collapsed one) at N = 300 and 1024: kernel 3's extrema
    bit-equal to the gather of knn_plain's indices and of kernel 1's;
    traced, k3_tie_rows and k3_distances equal the emulated scan's
    (emulation.select_knn_compact), the tie path taken; on random clouds,
    which have no copies, never."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    g = torch.Generator().manual_seed(C + k)
    ties = 0
    for N in (300, 1024):
        xs = _route_clouds("grid_masked", 2, N, C, seed=N + C + k)
        a = torch.randn(2, N, 24, generator=g).to(cuda)
        emu = em.select_knn_compact(xs, k)
        xs = xs.to(cuda)
        got, counts = _traced(lambda: nb.knn_gather_extrema(xs, a, k))
        for idx in (nb.knn_plain(xs, xs, k), nb.knn(xs, xs, k)):
            for g_, w in zip(got, nb.gather_extrema_plain(idx, a)):
                assert torch.equal(g_, w), N
        assert counts == {nb.K3_DISTANCES: int(emu.distances.sum()),
                          nb.K3_TIE_ROWS: int(emu.tie_rows.sum())}, N
        ties += counts[nb.K3_TIE_ROWS]
    assert ties > 0
    xs = _route_clouds("random", 2, 300, C, seed=k).to(cuda)
    a = torch.randn(2, 300, 24, generator=g).to(cuda)
    _, counts = _traced(lambda: nb.knn_gather_extrema(xs, a, k))
    assert counts[nb.K3_TIE_ROWS] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("select", ["two_pass", "packed", "bf16"])
@pytest.mark.parametrize("kind", ["masked", "grid_masked"])
def test_knn_gather_extrema_compacted_scan_at_each_class(cuda, kind, select):
    """At each selection class, on clouds with a collapsed centre (1024
    points, C = 64, k = 20): kernel 3 bit-equal to the gather of kernel 1's
    indices at the class, whose selection scans every row."""
    g = torch.Generator().manual_seed(9)
    xs = _route_clouds(kind, 4, 1024, 64, seed=9).to(cuda)
    a = torch.randn(4, 1024, 32, generator=g).to(cuda)
    idx = nb.knn(xs, xs, 20, select=select)
    for got, want in zip(nb.knn_gather_extrema(xs, a, 20, select=select),
                         nb.gather_extrema(idx, a)):
        assert torch.equal(got, want), select


@pytest.mark.cuda
def test_knn_truncation_example(cuda):
    """The JAX package's truncation example (its tests/test_knn_select.py):
    two database points one ulp apart in distance from the query, the
    larger at the lower index; exact selection keeps them apart, packed
    and bf16 merge them and break the tie to the lower index."""
    import numpy as np
    x = torch.tensor([float(np.nextafter(np.float32(5.0), np.float32(6.0))),
                      5.0, 1.0, 2.0, 7.0, 8.0, 9.0, 10.0], device=cuda)
    db = torch.stack([x, torch.zeros_like(x), torch.zeros_like(x)], -1)[None]
    q = torch.zeros_like(db)
    inv = torch.ones(1, 8, device=cuda)
    for cls, want in (("exact", [2, 3, 1, 0]), ("packed", [2, 3, 0, 1]),
                      ("bf16", [2, 3, 0, 1])):
        for r in (nb.KNN_ROUTES["xyz"], nb.KNN_ROUTES["tiled"]):
            assert nb._knn(q, db, 4, r, cls)[0, 0].tolist() == want
            assert gr._knn_with_density(q, db, inv, 4, r, cls)[0][0, 0].tolist() \
                == want
    assert nb._lib().iq_knn(q.data_ptr(), db.data_ptr(), 0, 0, 1, 8, 8, 3, 4, 0,
                            3, 0) != 0         # an unknown class is refused
    launch.reset_launches()


@pytest.mark.cuda
def test_knn_routes_refuse_what_they_do_not_take(cuda):
    """k beyond either kernel's range, and the xyz route forced on a shape
    it does not take (more than 4 channels, a database that does not fit a
    block's shared memory); the route queries name the route each shape
    takes."""
    X = nb.KNN_ROUTES["xyz"]
    xs = torch.randn(2, 128, 3, device=cuda)
    with pytest.raises(ValueError):
        nb._knn(xs, xs, 33, X)
    with pytest.raises(ValueError):
        gr._knn_with_density(xs, xs, torch.ones(2, 128, device=cuda), 65, X)
    wide = torch.randn(2, 128, 5, device=cuda)
    with pytest.raises(RuntimeError):
        nb._knn(wide, wide, 8, X)
    big = torch.randn(1, 20000, 3, device=cuda)
    with pytest.raises(RuntimeError):
        nb._knn(big[:, :16].contiguous(), big, 8, X)
    with pytest.raises(RuntimeError):
        gr._knn_with_density(big[:, :16].contiguous(), big,
                             torch.ones(1, 20000, device=cuda), 8, X)
    assert nb.knn_route(1024, 3, 20)["route"] == "xyz"
    assert gr.knn_density_route(512, 3, 64)["route"] == "xyz"
    assert nb.knn_route(1024, 64, 20)["route"] == "tiled"
    assert nb.knn_route(20000, 3, 20)["route"] == "tiled"
    launch.reset_launches()
    assert torch.equal(nb._knn(big[:, :16].contiguous(), big, 8, 0),
                       nb._knn(big[:, :16].contiguous(), big, 8, nb.KNN_ROUTES["tiled"]))
    assert launch.LAUNCHES["knn"] == 2


def _pconv_args(cuda, widths, k, D, B, S, N=256):
    """Inputs of fused_pointconv_sa as PointConvDensitySA.forward builds
    them, on clouds with a collapsed half, from the kNN kernel's indices."""
    g = torch.Generator().manual_seed(k + S)
    xyz = _cloud(cuda, B, N, k)
    new_xyz = xyz[:, torch.linspace(0, N - 1, S).long()].contiguous()
    inv = torch.rand(B, N, generator=g).to(cuda) + 0.5
    idx, den, dmax = gr.knn_with_density(new_xyz, xyz, inv, k)
    C1, C2, C3 = widths
    (a1, b1), (a2, b2), (a3, b3) = (_affine(g, 3 + D, C1, cuda),
                                    _affine(g, C1, C2, cuda),
                                    _affine(g, C2, C3, cuda))
    src = torch.cat([xyz, torch.randn(B, N, D, generator=g).to(cuda)], -1)
    u = src @ a1 + b1
    csw = new_xyz @ a1[:3]
    # a positive last DensityNet layer: a scale that ReLU does not leave at 0
    dnet = [_affine(g, 1, 16, cuda), _affine(g, 16, 8, cuda),
            tuple(t.abs() for t in _affine(g, 8, 1, cuda))]
    wnet = [_affine(g, 3, 8, cuda), _affine(g, 8, 8, cuda),
            _affine(g, 8, 16, cuda)]
    return (idx, den, dmax, new_xyz, u, xyz, csw, a2, b2, a3, b3, dnet, wnet)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,k,D,B,S", [
    ((64, 64, 128), 32, 0, 2, 64), ((128, 128, 256), 64, 128, 2, 64),
    ((32, 32, 64), 20, 8, 2, 64),
    ((64, 64, 128), 16, 0, 3, 61),        # K = 16: 8 centres a tile, S ragged
    ((64, 64, 128), 32, 0, 40, 63),       # more tiles than SMs, S % 4 != 0
    ((128, 128, 256), 64, 128, 70, 33),   # streamed weights, S odd
    ((64, 96, 128), 24, 5, 2, 50),        # 5 centres of 24 rows: a ragged tile
    ((32, 32, 64), 7, 2, 1, 9)])          # fewer tiles than SMs, K % 4 != 0
def test_pointconv_sa_matches_plain(cuda, widths, k, D, B, S):
    """Both of the model's configurations and the other widths and K the
    kernel takes, batches smaller and larger than the SM count, and S that
    is no multiple of the centres of a tile: within rtol 1e-4, atol 1e-5 of
    the plain version (layers 2-3 and the contraction run as three TF32
    products on the tensor cores, f32 sums in another order)."""
    args = _pconv_args(cuda, widths, k, D, B, S)
    launch.reset_launches()
    got = gr.fused_pointconv_sa(*args, k=k)
    want = gr.fused_pointconv_sa_plain(*args, k=k)
    assert got.shape == (B, S, widths[2] * 16)
    assert float((want != 0).float().mean()) > 0.05
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert launch.LAUNCHES["fused_pointconv_sa"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("widths,k", [((64, 48, 128), 32), ((48, 64, 128), 32),
                                      ((16, 32, 64), 16), ((64, 64, 128), 65)])
def test_pointconv_sa_refuses_what_the_kernel_does_not_take(cuda, widths, k):
    """A width outside the kernel's instantiations, a C3 wider than C1 + C2
    and a K beyond 64 raise in the wrapper: nothing falls back."""
    args = list(_pconv_args(cuda, widths, min(k, 64), 0, 2, 16))
    if k > 64:
        args[0] = torch.zeros(2, 16, k, dtype=torch.int32, device=cuda)
        args[1] = torch.ones(2, 16, k, device=cuda)
    launch.reset_launches()
    with pytest.raises(ValueError):
        gr.fused_pointconv_sa(*args, k=k)
    assert launch.LAUNCHES["fused_pointconv_sa"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("F,offset", [(64, 0), (7, 0), (130, 0), (16, 1)])
def test_gather_rows_bit_equal_to_plain(cuda, F, offset):
    """float4 rows (F % 4 == 0), scalar rows otherwise, and values that
    start off a 16-byte boundary (``offset``: the scalar path)."""
    g = torch.Generator().manual_seed(F)
    buf = torch.randn(offset + 3 * 1024 * F, generator=g).to(cuda)
    values = buf[offset:].view(3, 1024, F)
    idx = torch.randint(0, 1024, (3, 256, 20), generator=g,
                        dtype=torch.int32).to(cuda)
    launch.reset_launches()
    got = gr.gather_rows(values, idx)
    torch.cuda.synchronize()
    assert got.shape == (3, 256, 20, F)
    assert torch.equal(got, gr.gather_rows_plain(values, idx))
    assert launch.LAUNCHES["gather_rows"] == 1


def _gather_case(cuda, B, S, N, F, k, seed, offset=0):
    """Index rows of which the second half copy row 0 (as a masked
    coalition's collapsed regions do), and value rows that start ``offset``
    floats past an allocation (off a 16-byte boundary where it is odd)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, N, (B, S, k), generator=g, dtype=torch.int32)
    idx[:, S // 2:] = idx[:, :1]
    buf = torch.randn(offset + B * N * F, generator=g)
    return idx.to(cuda), buf.to(cuda)[offset:].view(B, N, F)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 64, 256])
@pytest.mark.parametrize("N", [64, 1024, 16384])
def test_gather_extrema_routes_bit_equal_to_plain(cuda, N, F):
    """Kernel 2 bit-equal to its plain version on the route its shape takes
    and on each route forced: the slice route up to the clouds whose slice
    fits shared memory, the row route beyond (N = 16384: even a 4-column
    slice takes 256 KB)."""
    idx, a = _gather_case(cuda, 3, min(N, 1024), N, F, 20, seed=N + F)
    want = nb.gather_extrema_plain(idx, a)
    info = nb.gather_extrema_route(N, F, 20)
    assert info["route"] == ("rows" if N == 16384 else "slice")
    assert info["blocks_per_sm"] >= 1
    for route in ("shape", "slice", "rows"):
        if route == "slice" and info["route"] == "rows":
            with pytest.raises(RuntimeError):      # the slice does not fit
                nb._gather_extrema(idx, a, nb.ROUTES[route])
            continue
        got = nb._gather_extrema(idx, a, nb.ROUTES[route])
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_), route


@pytest.mark.cuda
@pytest.mark.parametrize("S,N,F,k,offset", [(77, 100, 20, 7, 0),
                                            (77, 100, 20, 7, 1),
                                            (130, 64, 9, 32, 0),
                                            (1, 3000, 36, 1, 0)])
def test_gather_extrema_ragged_slices(cuda, S, N, F, k, offset):
    """Query counts apart from N and from a pass, a last column slice
    narrower than the rest (F = 20: 16 + 4; F = 36: 16 + 16 + 4), F not a
    multiple of 4 and values off a 16-byte boundary (scalar copies and
    stores), k = 1 and 32, and a cloud near the slice route's limit."""
    idx, a = _gather_case(cuda, 2, S, N, F, k, seed=S + k, offset=offset)
    launch.reset_launches()
    got = nb.gather_extrema(idx, a)
    torch.cuda.synchronize()
    assert nb.gather_extrema_route(N, F, k)["route"] == "slice"
    for g_, w_ in zip(got, nb.gather_extrema_plain(idx, a)):
        assert torch.equal(g_, w_)
    assert launch.LAUNCHES["gather_extrema"] == 1


# ------------------------------------------------------------- training
TRAIN_BATCH, TRAIN_VALID = 4, 3
# f32 on both sides, sums in other orders, amplified by train-mode
# BatchNorm over a batch of 4: loss and logits rtol/atol 1e-3; each
# gradient within 2e-2 of its norm plus 1e-3 of the largest gradient norm;
# each running statistic within 1e-3 of its buffer's largest value.
TRAIN_LOGIT_TOL, TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR, TRAIN_STAT_TOL = (
    1e-3, 2e-2, 1e-3, 1e-3)


def _grid_clouds(n, seed, clouds=TRAIN_BATCH):
    """Synthetic clouds on a 1/64 grid (every xyz distance exact in f32,
    so FPS, kNN and ball queries select alike on both sides) and labels."""
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    ds = SyntheticClouds(clouds, n, 10, seed=seed)
    x = torch.stack([torch.from_numpy(ds[i][0]) for i in range(clouds)])
    labels = torch.tensor([ds[i][1] for i in range(clouds)])
    return torch.round(x * 64) / 64, labels


def _train_model(name, device):
    from interpret_quality_tpu_torch.models import build_model
    from interpret_quality_tpu_torch.models.common import Dropout
    torch.manual_seed(0)
    model = build_model(name, 10, 20).to(device).train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.eval()
    return model


def _train_step(name, model, x, labels):
    from interpret_quality_tpu_torch.models import (
        feature_transform_regularizer, train_forward)
    from interpret_quality_tpu_torch.train.losses import cal_loss
    from interpret_quality_tpu_torch.train.trainer import (SMOOTHED,
                                                           valid_weights)
    logits, trans_feat = train_forward(model, x)
    loss = cal_loss(logits, labels, smoothing=name in SMOOTHED,
                    weights=valid_weights(x.shape[0], TRAIN_VALID, x.device))
    if name == "pointnet":
        loss = loss + feature_transform_regularizer(trans_feat) * 1e-3
    model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.detach(), logits.detach()


def _feature_knn_margin(x):
    """DGCNN's smallest gap between a k-th and (k+1)-th feature distance
    (layers 2-4) in the port's own CPU train forward, relative to the
    cloud's largest |x|^2, exact in f64."""
    from interpret_quality_tpu_torch.models import dgcnn
    rows, original = [], dgcnn.knn

    def knn(query, database, k, select=None):
        rows.append(query.detach().double())
        return original(query, database, k, select=select)
    dgcnn.knn = knn
    try:
        _train_step("dgcnn", _train_model("dgcnn", "cpu"), x,
                    torch.zeros(x.shape[0], dtype=torch.long))
    finally:
        dgcnn.knn = original
    worst = float("inf")
    for h in rows[1:]:
        d = ((h[:, :, None] - h[:, None]) ** 2).sum(-1).sort(-1).values
        scale = (h ** 2).sum(-1).amax(-1)[:, None]
        worst = min(worst, float(((d[..., 20] - d[..., 19]) / scale).min()))
    return worst


def _train_batch(name, seed=0):
    """The grid batch of a train step on the card: 256 points from
    ``seed``; DGCNN's 64 points from the first seed on whose feature-space
    selections keep 1e-6 apart."""
    if name != "dgcnn":
        return _grid_clouds(256, seed)
    x, labels = _grid_clouds(64, seed)
    while _feature_knn_margin(x) < 1e-6:
        seed += 1
        assert seed < 64
        x, labels = _grid_clouds(64, seed)
    return x, labels


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dgcnn", "gcnn", "pointnet2", "pointconv",
                                  "pointnet"])
def test_train_step_on_the_card_matches_the_cpu(cuda, name):
    """One train step (dropout off) through the kNN and FPS kernels on the
    card against the plain versions on the CPU, from the same weights:
    loss, logits, every gradient and every running statistic.  DGCNN runs
    on the first seed whose feature-space selections keep 1e-6 apart."""
    x, labels = _train_batch(name)
    out = {}
    for dev in ("cpu", cuda):
        model = _train_model(name, dev)
        loss, logits = _train_step(name, model, x.to(dev), labels.to(dev))
        out[str(dev)] = (loss.cpu(), logits.cpu(),
                         {p: t.grad.cpu() for p, t in model.named_parameters()},
                         {b: t.cpu() for b, t in model.named_buffers()
                          if b.endswith(("running_mean", "running_var"))})
    (l_c, lg_c, g_c, s_c), (l_g, lg_g, g_g, s_g) = out["cpu"], out["cuda"]
    tol = dict(rtol=TRAIN_LOGIT_TOL, atol=TRAIN_LOGIT_TOL)
    assert torch.allclose(l_g, l_c, **tol) and torch.allclose(lg_g, lg_c, **tol)
    floor = TRAIN_GRAD_FLOOR * max(float(g.norm()) for g in g_c.values())
    for p, want in g_c.items():
        assert float((g_g[p] - want).norm()) <= \
            TRAIN_GRAD_REL * float(want.norm()) + floor, p
    for b, want in s_c.items():
        assert float((s_g[b] - want).abs().max()) <= \
            TRAIN_STAT_TOL * float(want.abs().max()), b


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel,per_step", [("dgcnn", "knn", 4),
                                                  ("gcnn", "knn", 1),
                                                  ("pointnet2", "fps", 2),
                                                  ("pointconv", "fps", 2)])
def test_train_steps_launch_the_index_kernels(cuda, name, kernel, per_step):
    """A train step on the card takes its graphs from kernel 1 (kNN) and its
    centres from kernel 4 (FPS), and launches no kernel that folds eval
    BatchNorm (2, 3, 5, 6, 7, 9)."""
    x, labels = _grid_clouds(256, 1)
    model = _train_model(name, cuda)
    launch.reset_launches()
    _train_step(name, model, x.to(cuda), labels.to(cuda))
    torch.cuda.synchronize()
    launched = launch.launches()
    assert launched.pop(kernel) == per_step
    assert all(v == 0 for v in launched.values()), launched


# ------------------------------------------------------ adversarial, split
@pytest.mark.cuda
def test_adv_step_launches_knn_only_and_keeps_the_model_in_training(cuda):
    """An adversarial step on the card: the BIM attacks and both train
    passes take GCNN's graph from kernel 1, 7 + 3 + 2 launches, and no
    other kernel; the parameters move, the model stays in training."""
    from interpret_quality_tpu_torch.models import build_model
    from interpret_quality_tpu_torch.train import adversarial as adv
    from interpret_quality_tpu_torch.train.trainer import make_optimizer
    x, labels = _grid_clouds(256, 2)
    torch.manual_seed(0)
    model = build_model("gcnn", 10, 20).to(cuda).train()
    optimizer, scheduler, _ = make_optimizer(model, "gcnn_adv", 1, 1)
    before = model.linear3.weight.detach().clone()
    step = adv.make_adv_step(model, optimizer, scheduler,
                             torch.Generator(device=cuda).manual_seed(0))
    launch.reset_launches()
    loss, p1, p2 = step(x.to(cuda), labels.to(cuda), TRAIN_BATCH)
    torch.cuda.synchronize()
    launched = launch.launches()
    assert launched.pop("knn") == adv.ROT_ADV_ITER + adv.TRANS_ADV_ITER + 2
    assert all(v == 0 for v in launched.values()), launched
    assert model.training and torch.isfinite(loss)
    assert p1.shape == p2.shape == (TRAIN_BATCH,)
    assert not torch.equal(model.linear3.weight, before)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dgcnn", "pointnet2"])
def test_virtual_split_is_the_per_part_forward(cuda, name):
    """A split over [cuda, cuda] of 1024-point clouds half collapsed, as
    masked coalitions are: bit-equal to the unsplit forward of the same
    parts, plan path included (the split adds no arithmetic), and within
    rtol/atol 1e-3 of the unsplit forward of the whole batch (a dense
    layer may sum in another order for another row count, and a
    feature-space kNN near tie may then flip)."""
    from interpret_quality_tpu_torch.models import build_model, make_forward_fn
    from interpret_quality_tpu_torch.pipeline import split_forward
    torch.manual_seed(0)
    forward = make_forward_fn(build_model(name, 10, 20).to(cuda))
    split, device = split_forward(forward, cuda, [cuda, cuda])
    x = _cloud(cuda, 7, 1024, 3)
    parts = torch.tensor_split(x, 2)
    with torch.inference_mode():
        got = split(x)
        assert torch.equal(got, torch.cat([forward(p) for p in parts]))
        torch.testing.assert_close(got, forward(x), rtol=1e-3, atol=1e-3)
        plan = split.plan_fn(x)
        got = split.apply_plan_fn(x, plan)
        assert torch.equal(got, torch.cat(
            [forward.apply_plan_fn(p, q) for p, q in zip(parts, plan)]))
        torch.testing.assert_close(
            got, forward.apply_plan_fn(x, forward.plan_fn(x)), rtol=1e-3,
            atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dgcnn", "pointnet2"])
def test_split_over_the_visible_cards(cuda, name):
    """The split over every visible card (needs two or more): each part
    runs on its own card, with the kernels launched in that card's
    context, and comes back to the first card bit-equal to the unsplit
    forward of the same part there, plan path included."""
    from interpret_quality_tpu_torch.models import build_model, make_forward_fn
    from interpret_quality_tpu_torch.parallel import make_mesh
    from interpret_quality_tpu_torch.pipeline import split_forward
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    devices = make_mesh(n)
    torch.manual_seed(0)
    forward = make_forward_fn(build_model(name, 10, 20).to(devices[0]))
    split, device = split_forward(forward, devices[0], devices)
    assert device == devices[0]
    assert [next(r.model.parameters()).device for r in split.replicas] == \
        devices
    x = _cloud(devices[0], 2 * n + 1, 256, 3)
    parts = torch.tensor_split(x, n)
    with torch.inference_mode():
        got = split(x)
        plan = split.plan_fn(x)
        got_plan = split.apply_plan_fn(x, plan)
        leaves = [p if name == "dgcnn" else p[0] for p in plan]
        assert [t.device for t in leaves] == devices  # copied to each card
        want = torch.cat([forward(p) for p in parts])
        want_plan = torch.cat([forward.apply_plan_fn(p, forward.plan_fn(p))
                               for p in parts])
    torch.cuda.synchronize()
    assert got.device == devices[0]
    assert torch.equal(got, want) and torch.equal(got_plan, want_plan)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cards", [("dgcnn", 1), ("gcnn", None)])
def test_cli_shapley_init_over_the_visible_cards(cuda, tmp_path, monkeypatch,
                                                 name, cards):
    """cli.shapley_value --mesh_devices <cards> against the run without it.
    Over every visible card (``None``; needs two or more): GCNN's estimates
    within f32 rounding (the parts' dense layers sum in another order for
    another row count), efficient, and every card busy.  Over one card at
    50 orders: DGCNN's artifacts bit-equal, the run traced with
    --trace_dir into one trace, which names the launch spans of DGCNN's
    kernels."""
    import json

    import numpy as np

    from interpret_quality_tpu_torch.cli import shapley_value
    from interpret_quality_tpu_torch.config import ExperimentConfig
    n = cards or torch.cuda.device_count()
    if n < 2 and cards is None:
        pytest.skip("needs two or more cards")
    monkeypatch.chdir(tmp_path)
    traces = tmp_path / "traces"
    out = []
    for flag in ("0", str(n)):
        root = str(tmp_path / f"ck{flag}")
        traced = ["--trace_dir", str(traces)] if cards and flag != "0" else []
        shapley_value.main(["--model", name, "--synthetic",
                            "--allow_random_init", "--checkpoints_root", root,
                            "--num_points", "1024", "--num_samples_save",
                            "50" if cards else "20", "--samples", "0",
                            "--mesh_devices", flag, *traced])
        folder = ExperimentConfig(model=name, checkpoints_root=root
                                  ).exp_folder + "synthetic_00/"
        out.append([np.load(folder + f) for f in (
            "region_sv_all.npy", "norm_factor.npy", "region_id.npy")])
        if flag != "0":
            assert all(torch.cuda.max_memory_allocated(i) > 0
                       for i in range(n))
    (sv1, nf1, id1), (svn, nfn, idn) = out
    np.testing.assert_array_equal(idn, id1)
    if cards:
        np.testing.assert_array_equal(svn, sv1)
        np.testing.assert_array_equal(nfn, nf1)
        assert [p.name for p in traces.iterdir()] == [
            "shapley_init_synthetic_00.pt.trace.json"]
        with open(traces / "shapley_init_synthetic_00.pt.trace.json") as f:
            spans = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        assert {"iq_knn_gather_extrema", "iq_dense_pool"} <= spans
        return
    np.testing.assert_allclose(svn, sv1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nfn, nf1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(svn.sum(1), nfn, rtol=1e-3, atol=1e-4)


# -------------------------------------------------------- data parallel
# Data-parallel steps on the card against trainer.make_train_step on the
# whole batch, from the same weights, dropout on with the same generator
# seed.  Every family at full width (DP_BATCH synthetic clouds of DP_POINTS
# points, the last row a padded tail), DGCNN also on a tie-free grid batch,
# and PointConv in float64 as well, where only f64 rounding parts the two
# steps.  DP_TOL: the loss (rtol/atol), gradients
# (of their norm, plus a floor of the largest norm), running statistics (of
# their largest value).  In f32 the two steps sum in other orders only
# where the all-reduce does: the train step's gradient bounds, the loss and
# statistics five and ten times tighter than a card against the CPU.
DP_BATCH, DP_POINTS = 32, 1024
# DGCNN's tie-free batch: 8 grid clouds of 128 points from the first seed
# on whose feature-space selections keep 1e-6 apart (the train step's
# search, run once: it takes about a minute)
DP_TIE_FREE_CLOUDS, DP_TIE_FREE_POINTS, DP_TIE_FREE_SEED = 8, 128, 20
DP_CASES = [("dgcnn", torch.float32, "tie_free"),
            ("dgcnn", torch.float32, "full"), ("gcnn", torch.float32, "full"),
            ("pointnet2", torch.float32, "full"),
            ("pointconv", torch.float32, "full"),
            ("pointconv", torch.float64, "full"),
            ("pointnet", torch.float32, "full")]
DP_TOL = {torch.float32: (2e-4, TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR, 1e-4),
          torch.float64: (1e-8, 1e-8, 1e-11, 1e-8)}
# on the full-width batch a DGCNN row may select other neighbours in the
# two steps only at a near tie: selected distances this far apart,
# relative to the cloud's largest |x|^2 (the f32 rounding of
# |q|^2 - 2 q.d + |d|^2)
DP_TIE_REL = 1e-5
# the kernels a train step launches: kNN's graphs and FPS's centres
STEP_KERNELS = {"dgcnn": {"knn"}, "gcnn": {"knn"}, "pointnet2": {"fps"},
                "pointconv": {"fps"}, "pointnet": set()}


def _first_step_gap(name, g_a, g_b, p0):
    """How far the optimiser's first step puts the parameters of two
    gradients apart: SGD's lr * g, Adam's lr * g / (|g| + eps), g with the
    weight decay."""
    from interpret_quality_tpu_torch.train.trainer import (WEIGHT_DECAY,
                                                           lr_schedule_for)
    lr = lr_schedule_for(name, 1, 1)(0)
    ga, gb = g_a + WEIGHT_DECAY * p0, g_b + WEIGHT_DECAY * p0
    if name in ("pointnet", "pointnet2"):
        return lr * (ga / (ga.abs() + 1e-8) - gb / (gb.abs() + 1e-8)).abs()
    return lr * (ga - gb).abs()


def _dp_case(name, dtype=torch.float32, batch="full"):
    """The arguments of ``dryrun.dp_step_rank`` for one data-parallel step:
    the full-width batch or DGCNN's tie-free batch, the last row a padded
    tail, seeded weights, dropout on, the generator seeded with 1."""
    from interpret_quality_tpu_torch.data.datasets import SyntheticClouds
    from interpret_quality_tpu_torch.models import build_model
    if batch == "tie_free":
        x, labels = _grid_clouds(DP_TIE_FREE_POINTS, DP_TIE_FREE_SEED,
                                 DP_TIE_FREE_CLOUDS)
        assert _feature_knn_margin(x) >= 1e-6
    else:
        ds = SyntheticClouds(DP_BATCH, DP_POINTS, 10, seed=11)
        x = torch.stack([torch.from_numpy(ds[i][0]) for i in range(DP_BATCH)])
        labels = torch.tensor([ds[i][1] for i in range(DP_BATCH)])
    torch.manual_seed(0)
    state = build_model(name, 10, 20).state_dict()
    return (name, state, x.numpy(), labels.numpy(), x.shape[0] - 1, 1, True,
            dtype)


def _dp_ranks(backend, devices, cases):
    """Every rank's result of each case, from one set of ranks over
    ``devices``: per case, the list over ranks."""
    import torch_dp_ranks
    from interpret_quality_tpu_torch.parallel import spawn
    ranks = spawn(torch_dp_ranks.dp_step_cases_on_card, len(devices),
                  backend, devices, args=(cases,))
    return [[r[i] for r in ranks] for i in range(len(cases))]


def _check_selections(calls, ranks, tie_free):
    """The data-parallel step's kNN selections (DGCNN's, every rank's)
    against the single step's ``calls``, call by call.  Where the ranks'
    features are the single step's bit for bit, the index lists are equal.
    Elsewhere, on the tie-free batch, every row selects the single step's
    neighbour set, and a list orders two neighbours otherwise only where
    rounding can swap them: each position's distances in the two lists
    (exact, at the single step's features, over the cloud's largest |x|^2)
    at most twice the largest change of any distance between the two
    steps' features.  On the full-width batch, where the single step took
    the data-parallel step's selections, a row may select otherwise only at
    a near tie: its selected distances, sorted, within DP_TIE_REL."""
    assert len(ranks[0]["knn"]) == len(calls)
    for call, (query, idx) in enumerate(calls):
        have_q = torch.cat([r["knn"][call][0] for r in ranks])
        have = torch.cat([r["knn"][call][1] for r in ranks])
        if torch.equal(have_q, query):
            assert torch.equal(have, idx), call
            continue
        q, g = query.double(), have_q.double()
        scale = (q ** 2).sum(-1).amax(-1)                          # (B,)
        b, r = (have != idx).any(-1).nonzero(as_tuple=True)
        if not b.numel():
            continue

        def listed(ix):      # each differing row's distances in list order
            nbrs = q[b[:, None], ix[b, r].long()]
            return ((nbrs - q[b, r][:, None]) ** 2).sum(-1) / scale[b, None]
        if tie_free:
            assert torch.equal(have.sort(-1).values,
                               idx.sort(-1).values), call
            moved = ((((g[:, :, None] - g[:, None]) ** 2).sum(-1)
                      - ((q[:, :, None] - q[:, None]) ** 2).sum(-1)
                      ).abs() / scale[:, None, None]).max()
            swap = (listed(have) - listed(idx)).abs().max()
            assert float(swap) <= 2 * float(moved), (call, float(swap))
        else:
            gap = (listed(have).sort(-1).values
                   - listed(idx).sort(-1).values).abs().max()
            assert float(gap) <= DP_TIE_REL, (call, float(gap))


def _dp_against_the_single_step(case, ranks, device, tie_free=False):
    """One data-parallel step (every rank's result of ``case``) against
    trainer.make_train_step on the whole batch on ``device``, from the same
    weights and generator seed: loss, every gradient and running statistic
    within DP_TOL, every parameter within 1e-6 of its buffer's largest
    value of where the first step puts the two gradients apart; every
    dropout value kept or dropped as in the single step; the kernels of a
    train step launched and no other; DGCNN's kNN selections as
    ``_check_selections`` holds them.  On DGCNN's full-width batch the
    single step takes the data-parallel step's selections: a near tie that
    rounding flips moves a gradient by more than rounding does, so the
    gradients are held to rounding on the same neighbours, and the flips
    to near ties."""
    import torch_dp_ranks
    from interpret_quality_tpu_torch.models import build_model
    from interpret_quality_tpu_torch.train.trainer import (make_optimizer,
                                                           make_train_step)
    name, state, x, labels, valid, seed, _, dtype = case
    model = build_model(name, 10, 20)
    model.load_state_dict(state)
    model = model.to(device, dtype).train()
    optimizer, scheduler, _ = make_optimizer(model, name, 1, 1)
    step = make_train_step(model, optimizer, scheduler, name,
                           torch.Generator(device=device).manual_seed(seed))
    replay = None
    if name == "dgcnn" and not tie_free:
        replay = [torch.cat([r["knn"][call][1] for r in ranks])
                  for call in range(len(ranks[0]["knn"]))]
    with torch_dp_ranks.recorded_step(dtype is torch.float64, replay) as rec:
        loss, _ = step(torch.from_numpy(x).to(device, dtype),
                       torch.from_numpy(labels).to(device), valid)
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    logit_tol, grad_rel, grad_floor, stat_tol = DP_TOL[dtype]
    got = ranks[0]
    assert torch.allclose(got["loss"], loss.cpu(), rtol=logit_tol,
                          atol=logit_tol)
    floor = grad_floor * max(float(g.norm()) for g in grads.values())
    for p, want in grads.items():
        assert float((got["grads"][p] - want).norm()) <= \
            grad_rel * float(want.norm()) + floor, p
    for key, want in model.state_dict().items():
        want, have = want.cpu(), got["state"][key]
        if key.endswith(("running_mean", "running_var")):
            assert float((have - want).abs().max()) <= \
                stat_tol * float(want.abs().max()), key
        elif key in grads:
            gap = _first_step_gap(name, got["grads"][key], grads[key],
                                  state[key])
            assert float(((have - want).abs() - gap).max()) <= \
                1e-6 * float(want.abs().max()), key
    assert len(got["masks"]) == len(rec["masks"]) > 0
    for call, (kept, nonzero) in enumerate(rec["masks"]):
        have = torch.cat([r["masks"][call][0] for r in ranks])
        both = torch.cat([r["masks"][call][1] for r in ranks]) & nonzero
        assert not bool(((have != kept) & both).any()), call
    assert {k for r in ranks for k, v in r["launches"].items() if v} == \
        STEP_KERNELS[name]
    _check_selections(rec["knn"], ranks, tie_free)


@pytest.fixture(scope="module")
def dp_on_one_card():
    """Every DP_CASES step over one NCCL rank and over two gloo ranks on
    the first card (NCCL takes one rank a card), each set of ranks spawned
    once: by (backend, case), the case's arguments and every rank's
    result."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    card, out = torch.device("cuda", 0), {}
    cases = [_dp_case(*key) for key in DP_CASES]
    for backend, world in (("nccl", 1), ("gloo", 2)):
        for key, case, ranks in zip(DP_CASES, cases,
                                    _dp_ranks(backend, [card] * world, cases)):
            out[backend, key] = case, ranks
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,batch", DP_CASES)
def test_dp_step_world_one_nccl_matches_the_single_step(cuda, dp_on_one_card,
                                                        name, dtype, batch):
    """The data-parallel step on one rank through NCCL: the kNN or FPS
    kernel gives its graph or centres, and it is the single step."""
    _dp_against_the_single_step(*dp_on_one_card["nccl", (name, dtype, batch)],
                                cuda, batch == "tie_free")


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,batch", DP_CASES)
def test_dp_step_two_gloo_ranks_on_one_card_match_the_single_step(
        cuda, dp_on_one_card, name, dtype, batch):
    """The data-parallel step on two ranks through gloo, both on the one
    card: BatchNorm's statistics, the dropout masks and the loss over the
    whole batch, the single step."""
    _dp_against_the_single_step(*dp_on_one_card["gloo", (name, dtype, batch)],
                                cuda, batch == "tie_free")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gcnn", "pointnet"])
def test_dp_step_over_the_visible_cards(cuda, name):
    """The data-parallel step over every visible card through NCCL (needs
    two or more): one rank a card, BatchNorm's statistics and the loss
    over the whole batch, the single step on the first card."""
    from interpret_quality_tpu_torch.parallel import make_mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    devices = make_mesh()
    case = _dp_case(name)
    _dp_against_the_single_step(case, _dp_ranks("nccl", devices, [case])[0],
                                devices[0])


@pytest.mark.cuda
def test_dryrun_on_the_visible_cards(cuda):
    """dryrun_multichip over every visible card (one card: world 1)."""
    from interpret_quality_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(torch.cuda.device_count(), "cuda")


# ------------------------------------------- the non-exact precision settings
# A one-pass setting against its emulation: f32 sums in another order, and a
# value at a rounding boundary of the one-pass operand may round the other
# way on one side, so the gap is held to a share of the setting's own
# rounding (the emulation against the exact f32 version; see chip_smoke.py's
# ONE_PASS_RMS_SHARE)
ONE_PASS_RMS_SHARE, ONE_PASS_MAX_SHARE = 0.1, 0.5


@contextlib.contextmanager
def _matmul_precision(precision):
    """The process's --matmul_precision for a block, highest after it."""
    from interpret_quality_tpu_torch import config
    config.set_matmul_precision(precision)
    try:
        yield
    finally:
        config.set_matmul_precision("highest")


def _one_pass_close(got, emulated, exact):
    gap, rounding = (got - emulated).double(), (emulated - exact).double()
    assert float(gap.square().mean().sqrt()) <= ONE_PASS_RMS_SHARE * float(
        rounding.square().mean().sqrt())
    assert float(gap.abs().max()) <= ONE_PASS_MAX_SHARE * float(
        rounding.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,offset", [(64, 64, 0), (1024, 64, 0),
                                        (1024, 20, 0), (100, 9, 1),
                                        (16384, 16, 0)])
def test_gather_extrema_bf16_routes_bit_equal_to_plain(cuda, N, F, offset):
    """Kernel 2's bf16 route (a bf16 copy of the values) bit-equal to the
    plain version on the rounded values, on the route the shape takes and
    each route forced; F not a multiple of 8 takes the scalar copy; the
    launch counts under its route too."""
    idx, a = _gather_case(cuda, 2, min(N, 512), N, F, 20, seed=N + F,
                          offset=offset)
    want = nb.gather_extrema_plain(idx, a, parts=1)
    assert not torch.equal(want[0], nb.gather_extrema_plain(idx, a)[0])
    info = nb.gather_extrema_route(N, F, 20, parts=1)
    assert info["route"] == ("rows" if N == 16384 else "slice")
    launch.reset_launches()
    routes = ("shape", "rows") if N == 16384 else ("shape", "slice", "rows")
    for route in routes:
        got = nb._gather_extrema(idx, a, nb.ROUTES[route], parts=1)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_), route
    for g_, w_ in zip(nb.gather_extrema(idx, a, parts=1), want):
        assert torch.equal(g_, w_)
    assert launch.LAUNCHES["gather_extrema:bf16"] == len(routes) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("F,offset", [(64, 0), (7, 0), (16, 1)])
def test_gather_rows_bf16_bit_equal_to_plain(cuda, F, offset):
    g = torch.Generator().manual_seed(F)
    buf = torch.randn(offset + 3 * 1024 * F, generator=g).to(cuda)
    values = buf[offset:].view(3, 1024, F)
    idx = torch.randint(0, 1024, (3, 256, 20), generator=g,
                        dtype=torch.int32).to(cuda)
    launch.reset_launches()
    got = gr.gather_rows(values, idx, parts=1)
    torch.cuda.synchronize()
    assert torch.equal(got, gr.gather_rows_plain(values, idx, parts=1))
    assert launch.LAUNCHES["gather_rows:bf16"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision,parts", [("high", 2), ("default", 1)])
@pytest.mark.parametrize("with_uf", [False, True])
@pytest.mark.parametrize("widths,k,radius", [BALL_BRANCHES[1], BALL_BRANCHES[4],
                                              BALL_BRANCHES[5]])
def test_ball_mlp3_one_pass_matches_emulation(cuda, widths, k, radius,
                                              with_uf, precision, parts):
    """Kernel 5 at a one-pass setting against ``emulation.ball_mlp3_at``;
    resident (64, 128) and streamed (128, 256) weights, the latter also at
    K = 128, where a centre's rows cross tiles."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    g = torch.Generator().manual_seed(k + widths[0])
    xyz = _cloud(cuda, 2, 512, k, collapse=False)
    new_xyz = xyz[:, :128].contiguous()
    w, a1f = _ball_weights(g, widths, with_uf, cuda)
    uf = (3.0 * torch.randn(2, 512, 5, generator=g).to(cuda) @ a1f
          if with_uf else None)
    launch.reset_launches()
    with _matmul_precision(precision):
        got = gr.fused_ball_mlp3(new_xyz, xyz, uf, *w, radius=radius, k=k,
                                 parts=parts)
    _one_pass_close(got, em.ball_mlp3_at(new_xyz, xyz, uf, *w, radius=radius,
                                         k=k, precision=precision,
                                         parts=parts),
                    gr.fused_ball_mlp3_plain(new_xyz, xyz, uf, *w,
                                             radius=radius, k=k, parts=parts))
    exact = gr.fused_ball_mlp3(new_xyz, xyz, uf, *w, radius=radius, k=k)
    assert not torch.allclose(got, exact, rtol=1e-5, atol=1e-6)
    assert launch.LAUNCHES[f"fused_ball_mlp3:{precision}"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision,parts", [("high", 2), ("default", 1)])
@pytest.mark.parametrize("widths,k,D,B,S", [
    ((64, 64, 128), 32, 0, 2, 64), ((128, 128, 256), 64, 128, 2, 64)])
def test_pointconv_sa_one_pass_matches_emulation(cuda, widths, k, D, B, S,
                                                 precision, parts):
    """Kernel 7 at a one-pass setting against
    ``emulation.pointconv_sa_at`` (layers 2-3 and WeightNet at the setting,
    the contraction three products)."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    args = _pconv_args(cuda, widths, k, D, B, S)
    launch.reset_launches()
    with _matmul_precision(precision):
        got = gr.fused_pointconv_sa(*args, k=k, parts=parts)
    _one_pass_close(got, em.pointconv_sa_at(*args, k=k, precision=precision,
                                            parts=parts),
                    gr.fused_pointconv_sa_plain(*args, k=k, parts=parts))
    assert launch.LAUNCHES[f"fused_pointconv_sa:{precision}"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "default"])
def test_precision_product_on_the_card(cuda, precision):
    """The models' product at a one-pass setting: coarser than f32; at
    default the f32 sums of exact products of the bf16-rounded operands
    (forward and backward); cuBLAS left in f32 after it."""
    from interpret_quality_tpu_torch.ops import precision as pr
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 300, 256, generator=g).to(cuda).requires_grad_()
    w = torch.randn(256, 128, generator=g).to(cuda).requires_grad_()
    y = pr.matmul(x, w, precision)
    y.backward(torch.ones_like(y))
    exact = torch.matmul(x.detach().double(), w.detach().double())
    assert float((y.double() - exact).abs().max()) > 1e-4
    if precision == "default":
        rx, rw = pr.round_bf16(x.detach()).double(), pr.round_bf16(
            w.detach()).double()
        bound = 256 * 2.0 ** -24 * (rx.abs() @ rw.abs())
        assert bool(((y.double() - rx @ rw).abs() <= bound).all())
        ones = torch.ones(4, 300, 128, dtype=torch.float64, device=cuda)
        assert bool(((x.grad.double() - ones @ rw.T).abs()
                     <= 128 * 2.0 ** -24 * (ones @ rw.abs().T)).all())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.equal(pr.matmul(x, w, "highest"), torch.matmul(x, w))


# ------------------------------------------------------------ work counters
def _traced(fn):
    """fn() under a profiler of the card, the work counters cleared first:
    (its result, the counters)."""
    from torch.profiler import ProfilerActivity, profile
    from interpret_quality_tpu_torch.utils import profiling
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = fn()
    counts = profiling.counters()
    profiling.reset_counters()
    return out, counts


@pytest.mark.cuda
@pytest.mark.parametrize("with_uf", [False, True])
@pytest.mark.parametrize("widths", [(64, 64, 128), (128, 128, 256)])
def test_ball_mlp3_counts_its_rows(cuda, with_uf, widths):
    """Traced, kernel 5 counts each centre's filled slots (the first k
    in-ball points; without feature rows those with no earlier point at
    their very coordinates), every centre, a repeated one too; its
    consumers multiply at least those rows' tiles of ``BALL_TILE_ROWS``,
    and wait for the producer at no more tiles than they multiply; its
    output is bit-equal to the untraced launch's.  Half of each cloud sits
    on its first point and every third point is a centre; no point lies
    within 4e-5 of a ball's boundary, so f32 rounding decides no
    membership.  Resident and streamed weights."""
    g = torch.Generator().manual_seed(12)
    xyz = _cloud(cuda, 2, 512, 12)
    new_xyz = xyz[:, ::3].contiguous()
    w, a1f = _ball_weights(g, widths, with_uf, cuda)
    uf = torch.randn(2, 512, 5, generator=g).to(cuda) @ a1f if with_uf else None
    radius, k = 0.2, 32
    off = gr.fused_ball_mlp3(new_xyz, xyz, uf, *w, radius=radius, k=k)
    on, counts = _traced(lambda: gr.fused_ball_mlp3(new_xyz, xyz, uf, *w,
                                                   radius=radius, k=k))
    assert torch.equal(on, off)
    d2 = ((new_xyz.double()[:, :, None] - xyz.double()[:, None]) ** 2).sum(-1)
    assert float((d2 - radius ** 2).abs().min()) > 4e-5
    inside = d2 <= radius ** 2
    rows = inside & (torch.cumsum(inside, -1) <= k)
    if not with_uf:
        same = (xyz[:, :, None] == xyz[:, None]).all(-1)       # (B, N, N)
        copy = torch.tril(same, diagonal=-1).any(-1)            # an earlier twin
        rows &= ~copy[:, None, :]
    per_centre = torch.where(inside.any(-1), rows.sum(-1), 1)
    assert counts[gr.K5_ROWS] == int(per_centre.sum())
    tiles = counts[gr.K5_TILES]
    assert tiles >= -(-int(per_centre.sum()) // gr.BALL_TILE_ROWS)
    assert 0 <= counts.get(gr.K5_FRONT_WAITS, 0) <= tiles
    assert set(counts) <= {gr.K5_ROWS, gr.K5_TILES, gr.K5_FRONT_WAITS}


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 64])
def test_knn_gather_extrema_counts_its_distances(cuda, C):
    """Traced, kernel 3 counts its distinct query rows times the distinct
    database rows it scans for each, and no tie path on these random rows;
    its output is bit-equal to the untraced launch's."""
    g = torch.Generator().manual_seed(5)
    xs = torch.randn(3, 700, C, generator=g)
    xs[0, 350:] = xs[0, :1]
    xs[1, 100:] = xs[1, 5:6]
    xs, a = xs.to(cuda), torch.randn(3, 700, 40, generator=g).to(cuda)
    off = nb.knn_gather_extrema(xs, a, 20)
    on, counts = _traced(lambda: nb.knn_gather_extrema(xs, a, 20))
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    distinct = sum(torch.unique(x, dim=0).shape[0] for x in xs.cpu())
    assert distinct == 350 + 100 + 700
    assert counts == {nb.K3_DISTANCES: 350 ** 2 + 100 ** 2 + 700 ** 2,
                      nb.K3_TIE_ROWS: 0}


# ------------------------------------------------- kernel 9: DGCNN's head
# (B, N, kind): ragged N, one cloud, the main path's 1650 clouds, and
# clouds whose points all coincide
DENSE_CASES = [(1, 1024, "random"), (3, 1000, "random"), (3, 37, "random"),
               (1, 37, "coincident"), (3, 1024, "coincident"),
               (1650, 1024, "random")]
# highest: the kernel's three TF32 products drop lo*lo (2**-22 of a
# product) and sum in another order than cuBLAS's f32 product
DENSE_TOL = dict(rtol=1e-4, atol=1e-5)


def _head_args(device, B, N, kind, seed=0):
    """DGCNN's four edge outputs (B, N, 64/64/128/256), its conv5 and an
    eval BatchNorm with random statistics and scales of both signs."""
    from interpret_quality_tpu_torch.models import build_model
    from interpret_quality_tpu_torch.models.dgcnn import EDGE_WIDTHS
    torch.manual_seed(seed)
    model = build_model("dgcnn", 10, 20).eval()
    g = torch.Generator().manual_seed(seed)
    rows = 1 if kind == "coincident" else N
    feats = [torch.randn(B, rows, w, generator=g).expand(B, N, w).contiguous()
             .to(device) for w in EDGE_WIDTHS]
    bn = model.bn5
    with torch.no_grad():
        c = bn.num_features
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
        sign = torch.where(torch.rand(c, generator=g) < 0.5, -1.0, 1.0)
        bn.weight.copy_(sign * (0.5 + torch.rand(c, generator=g)))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
    model.to(device)
    return feats, model.conv5[0], model.bn5


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,kind", DENSE_CASES)
def test_dense_pool_matches_plain(cuda, B, N, kind):
    """Kernel 9 at highest against its plain version (DENSE_TOL), one
    launch; deterministic (a second launch bit-equal)."""
    feats, conv, bn = _head_args(cuda, B, N, kind, seed=B + N)
    launch.reset_launches()
    got = dn.dense_pool(feats, conv, bn)
    torch.cuda.synchronize()
    assert got.shape == (B, 2048)
    assert launch.launches("dense_pool") == {"dense_pool": 1}
    assert torch.allclose(got, dn.dense_pool_plain(feats, conv, bn),
                          **DENSE_TOL)
    assert torch.equal(dn.dense_pool(feats, conv, bn), got)
    assert launch.launches("dense_pool:high", "dense_pool:default") == {
        "dense_pool:high": 0, "dense_pool:default": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("B,N,kind", DENSE_CASES[:5])
def test_dense_pool_one_pass_matches_emulation(cuda, B, N, kind, precision):
    """Kernel 9 at a one-pass setting against its plain version on
    ``emulation.matmul_at``'s product (exact products of the rounded
    operands): the gap within a tenth of the rounding's RMS and half its
    largest value (``_one_pass_close``: only the order of the f32 sums
    differs); coarser than highest's; counted under its route."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    feats, conv, bn = _head_args(cuda, B, N, kind, seed=B + N)
    launch.reset_launches()
    with _matmul_precision(precision):
        got = dn.dense_pool(feats, conv, bn)
    exact = dn.dense_pool_plain(feats, conv, bn)
    _one_pass_close(got, dn.dense_pool_plain(
        feats, conv, bn, product=lambda x, w: em.matmul_at(x, w, precision)),
        exact)
    assert not torch.allclose(got, exact, rtol=1e-5, atol=1e-6)
    assert launch.LAUNCHES[f"dense_pool:{precision}"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width", "offset", "columns"])
def test_dense_pool_refuses_what_the_kernel_does_not_take(cuda, case):
    """Segments whose width is not a multiple of 32 or that start off a
    16-byte boundary, and an output width not a multiple of 256, raise on
    the card (the plain version takes them on the CPU)."""
    feats, conv, bn = _head_args(cuda, 2, 64, "random")
    if case == "width":
        feats = [torch.randn(2, 64, w, device=cuda) for w in (48, 80)] + feats[2:]
    elif case == "offset":
        buf = torch.empty(feats[0].numel() + 1, device=cuda)
        feats[0] = buf[1:].view_as(feats[0]).copy_(feats[0])
    else:
        conv = torch.nn.Conv1d(512, 96, 1, bias=False).to(cuda)
        bn = torch.nn.BatchNorm1d(96).to(cuda).eval()
    with pytest.raises(ValueError):
        dn.dense_pool(feats, conv, bn)
    assert dn.dense_pool([f.cpu() for f in feats], conv.cpu(),
                         bn.cpu()).shape[0] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dgcnn", "gcnn"])
def test_fused_forward_launches_dense_pool_once(cuda, name):
    """The fused eval forward of both families launches kernel 9 once, the
    differentiable eval forward (fused=False, the BIM attack's) never (the
    train steps' tests hold that a train step never does)."""
    from interpret_quality_tpu_torch.models import build_model
    x, _ = _grid_clouds(256, 3)
    torch.manual_seed(0)
    model = build_model(name, 10, 20).to(cuda).eval()
    launch.reset_launches()
    with torch.inference_mode():
        model(x.to(cuda))
        assert launch.launches("dense_pool") == {"dense_pool": 1}
        model(x.to(cuda), fused=False)
    assert launch.launches("dense_pool") == {"dense_pool": 1}


@pytest.mark.cuda
def test_dense_pool_counts_its_products_in_its_span(cuda):
    """Traced, kernel 9 adds 2 B N 512 1024 to ``dense_products`` and runs
    inside the span ``iq_dense_pool``; its output is bit-equal to the
    untraced launch's."""
    from torch.profiler import ProfilerActivity, profile
    from interpret_quality_tpu_torch.ops.precision import DENSE_PRODUCTS
    from interpret_quality_tpu_torch.utils import profiling
    B, N = 3, 1000
    feats, conv, bn = _head_args(cuda, B, N, "random")
    off = dn.dense_pool(feats, conv, bn)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = dn.dense_pool(feats, conv, bn)
        torch.cuda.synchronize()
    counts = profiling.counters()
    profiling.reset_counters()
    assert torch.equal(on, off)
    assert counts == {DENSE_PRODUCTS: 2 * B * N * 512 * 1024}
    assert "iq_dense_pool" in {e.key for e in prof.key_averages()}


# kernel 9's listed route on kernel 3's own copy lists: (B, N, kind) of the
# clouds that kernel 3 takes (``_route_clouds``), rows whose xyz repeat made
# equal in every segment; "coincident" gives nrows == 1, "random" nrows == N
LISTED_CASES = [(6, 1024, "grid_masked"), (5, 1000, "masked"),
                (4, 300, "random"), (3, 1024, "coincident"), (2, 37, "masked")]


def _listed_head_args(device, B, N, kind, seed=0):
    """Kernel 3's ``DistinctRows`` of clouds (B, N, 3), and DGCNN's head
    arguments whose edge outputs repeat the clouds' copies bit for bit (each
    row the first copy's), checked against ``emulation.copy_lists``."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    xs = _route_clouds(kind, B, N, 3, seed)
    cl = [em.copy_lists(c) for c in xs]
    xs = xs.to(device)
    a = torch.zeros(B, N, 32, device=device)
    _, _, lists = nb.knn_gather_extrema(xs, a, min(20, N), copy_lists=True)
    for b, c in enumerate(cl):
        d = len(c.rows)
        assert int(lists.nrows[b]) == d
        assert torch.equal(lists.rows[b, :d].cpu().long(), c.rows)
        assert torch.equal(lists.starts[b, :d + 1].cpu().long(), c.starts)
    first = torch.stack([c.first for c in cl]).to(device)
    feats, conv, bn = _head_args(device, B, N, "random", seed)
    feats = [torch.gather(f, 1, first[..., None].expand_as(f)).contiguous()
             for f in feats]
    return feats, conv, bn, lists


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("B,N,kind", LISTED_CASES)
def test_dense_pool_listed_route_matches_every_row(cuda, B, N, kind,
                                                   precision):
    """Kernel 9 walking kernel 3's lists against its every-row launch at
    each precision: the max bit-equal, the mean within DENSE_TOL (bit-equal
    where no row repeats); both against the plain version (DENSE_TOL at
    highest, ``_one_pass_close`` to the emulated product at one pass);
    nrows == 1 (every point on one) and nrows == N (no copies) included;
    deterministic; counted as one launch each."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    feats, conv, bn, lists = _listed_head_args(cuda, B, N, kind, seed=N + B)
    nrows = lists.nrows.cpu()
    if kind == "coincident":
        assert bool((nrows == 1).all())
    elif kind == "random":
        assert bool((nrows == N).all())
    else:
        assert int(nrows.max()) < N
    C = bn.num_features
    launch.reset_launches()
    with _matmul_precision(precision):
        every = dn.dense_pool(feats, conv, bn)
        listed = dn.dense_pool(feats, conv, bn, lists)
        again = dn.dense_pool(feats, conv, bn, lists)
    torch.cuda.synchronize()
    assert launch.launches("dense_pool") == {"dense_pool": 3}
    assert torch.equal(again, listed)
    assert torch.equal(listed[:, :C], every[:, :C])
    assert torch.allclose(listed[:, C:], every[:, C:], **DENSE_TOL)
    if kind == "random":
        assert torch.equal(listed, every)
    exact = dn.dense_pool_plain(feats, conv, bn)
    for got in (every, listed):
        if precision == "highest":
            assert torch.allclose(got, exact, **DENSE_TOL)
        else:
            _one_pass_close(got, dn.dense_pool_plain(
                feats, conv, bn,
                product=lambda x, w: em.matmul_at(x, w, precision)), exact)


@pytest.mark.cuda
def test_dense_pool_refuses_lists_it_cannot_walk(cuda):
    """Lists of another batch, another dtype or on another device raise
    before any launch."""
    feats, conv, bn, lists = _listed_head_args(cuda, 2, 64, "masked")
    bad = [lists._replace(rows=lists.rows[:1].contiguous()),
           lists._replace(nrows=lists.nrows.long()),
           lists._replace(starts=lists.starts.cpu()),
           lists._replace(starts=lists.starts[:, :64].contiguous())]
    launch.reset_launches()
    for lst in bad:
        with pytest.raises(ValueError, match="lists"):
            dn.dense_pool(feats, conv, bn, lst)
    assert launch.launches("dense_pool") == {"dense_pool": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name,with_plan,listed", [
    ("dgcnn", False, True), ("dgcnn", True, True), ("gcnn", False, False),
    ("gcnn", True, False), ("pct", True, False)])
def test_forwards_hand_kernel_3_lists_to_the_head(cuda, monkeypatch, name,
                                                  with_plan, listed):
    """DGCNN's fused forward, with and without a plan, passes its first
    kernel-3 launch's lists to kernel 9; GCNN's and PCT's pass none.  On
    masked clouds the listed head's max is the every-row head's bit for bit
    (rows equal in the first launch's input stay equal in all four edge
    outputs) and its mean within DENSE_TOL, and the lists are shorter than
    the clouds."""
    import importlib
    from interpret_quality_tpu_torch.models import build_model, make_forward_fn
    module = importlib.import_module(
        f"interpret_quality_tpu_torch.models.{'pct' if name == 'pct' else 'dgcnn'}")
    calls = []

    def recorded(*args):
        out = dn.dense_pool(*args)
        calls.append((args, out, dn.dense_pool(*args[:3])))
        return out
    monkeypatch.setattr(module, "dense_pool", recorded)
    x = _route_clouds("masked", 8, 1024, 3, seed=5).to(cuda)
    torch.manual_seed(0)
    fwd = make_forward_fn(build_model(name, 10, 20).to(cuda).eval())
    with torch.inference_mode():
        if with_plan:
            fwd.apply_plan_fn(x, fwd.plan_fn(x))
        else:
            fwd.model(x)
    assert len(calls) == 1
    args, got, every = calls[0]
    assert (len(args) == 4) == listed
    if listed:
        C = args[2].num_features
        assert int(args[3].nrows.max()) < 1024
        assert torch.equal(got[:, :C], every[:, :C])
        assert torch.allclose(got[:, C:], every[:, C:], **DENSE_TOL)


@pytest.mark.cuda
def test_dense_pool_listed_route_counts_distinct_rows(cuda):
    """Traced, the listed route adds 2 K C (sum of nrows) to
    ``dense_products`` (on the device, after the span) and runs inside
    ``iq_dense_pool``; its output is bit-equal to the untraced launch's."""
    from torch.profiler import ProfilerActivity, profile
    from interpret_quality_tpu_torch.ops.precision import DENSE_PRODUCTS
    from interpret_quality_tpu_torch.utils import profiling
    feats, conv, bn, lists = _listed_head_args(cuda, 4, 1000, "grid_masked")
    off = dn.dense_pool(feats, conv, bn, lists)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = dn.dense_pool(feats, conv, bn, lists)
        torch.cuda.synchronize()
    counts = profiling.counters()
    profiling.reset_counters()
    assert torch.equal(on, off)
    d = int(lists.nrows.sum())
    assert d < 4 * 1000
    assert counts == {DENSE_PRODUCTS: 2 * d * 512 * 1024}
    assert "iq_dense_pool" in {e.key for e in prof.key_averages()}


# ------------------------------------- kernel 10: PCT's sample-and-group
# (B, S, N, C1, C2, kind): both levels at the main path's shapes (a tenth
# of its 1650 clouds: the plain version writes a (B, S, 32, C1) tensor),
# ragged S, one centre, and clouds whose points all coincide (every u row
# equal, each centre's kNN the first 32 rows)
GROUP_CASES = [(165, 512, 1024, 128, 128, "random"),
               (165, 256, 512, 256, 256, "random"),
               (3, 255, 512, 256, 256, "random"), (2, 7, 40, 128, 128, "random"),
               (1, 1, 32, 256, 256, "random"),
               (4, 512, 1024, 128, 128, "coincident"),
               (4, 256, 512, 256, 256, "coincident")]


def _group_args(device, B, S, N, C1, C2, kind, seed=0):
    """kNN indices, hoisted layer-1 rows u, the centres' share c, layer 2
    (C1, C2) and its shift, as ``models.pct`` passes them."""
    g = torch.Generator().manual_seed(seed)
    if kind == "coincident":
        idx = torch.arange(32, dtype=torch.int32).expand(B, S, 32)
        u = torch.randn(B, 1, C1, generator=g).expand(B, N, C1)
    else:
        idx = torch.randint(0, N, (B, S, 32), generator=g, dtype=torch.int32)
        u = torch.randn(B, N, C1, generator=g)
    c = torch.randn(B, S, C1, generator=g)
    a2 = torch.randn(C1, C2, generator=g) / C1 ** 0.5
    b2 = 0.1 * torch.randn(C2, generator=g)
    return [t.contiguous().to(device) for t in (idx, u, c, a2, b2)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,N,C1,C2,kind", GROUP_CASES)
def test_knn_group_max_matches_plain(cuda, B, S, N, C1, C2, kind):
    """Kernel 10 at highest against its plain version (DENSE_TOL: the
    split drops lo*lo and sums in another order than cuBLAS), one launch;
    deterministic (a second launch bit-equal)."""
    from interpret_quality_tpu_torch.ops.cuda import knn_group as kg
    args = _group_args(cuda, B, S, N, C1, C2, kind, seed=S + C1)
    launch.reset_launches()
    got = kg.knn_group_max(*args)
    torch.cuda.synchronize()
    assert got.shape == (B, S, C2)
    assert launch.launches("knn_group_max") == {"knn_group_max": 1}
    assert torch.allclose(got, kg.knn_group_max_plain(*args), **DENSE_TOL)
    assert torch.equal(kg.knn_group_max(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("B,S,N,C1,C2,kind", GROUP_CASES[2:])
def test_knn_group_max_one_pass_matches_emulation(cuda, B, S, N, C1, C2, kind,
                                                  precision):
    """Kernel 10 at a one-pass setting against ``emulation.knn_group_max_at``
    (``_one_pass_close``); coarser than highest's; counted under its
    route."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    from interpret_quality_tpu_torch.ops.cuda import knn_group as kg
    args = _group_args(cuda, B, S, N, C1, C2, kind, seed=S + C1)
    launch.reset_launches()
    with _matmul_precision(precision):
        got = kg.knn_group_max(*args)
    exact = kg.knn_group_max_plain(*args)
    _one_pass_close(got, em.knn_group_max_at(*args, precision=precision),
                    exact)
    assert not torch.allclose(got, exact, rtol=1e-5, atol=1e-6)
    assert launch.LAUNCHES[f"knn_group_max:{precision}"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slots", "c1", "c2", "int64", "devices"])
def test_knn_group_max_refuses_what_the_kernel_does_not_take(cuda, case):
    """K other than 32, C1 not a multiple of 32, C2 other than 128 or 256,
    int64 indices and tensors on two devices raise on the card; the plain
    version takes the shapes on the CPU."""
    from interpret_quality_tpu_torch.ops.cuda import knn_group as kg
    shape = {"c1": (2, 8, 64, 48, 128), "c2": (2, 8, 64, 64, 64)}.get(
        case, (2, 8, 64, 64, 128))
    idx, u, c, a2, b2 = _group_args(cuda, *shape, "random")
    if case == "slots":
        idx = idx[..., :16].contiguous()
    elif case == "int64":
        idx = idx.long()
    elif case == "devices":
        a2 = a2.cpu()
    with pytest.raises(ValueError):
        kg.knn_group_max(idx, u, c, a2, b2)
    if case != "int64":
        cpu = [t.cpu() for t in (idx, u, c, a2, b2)]
        assert kg.knn_group_max(*cpu).shape == (2, 8, shape[4])


@pytest.mark.cuda
def test_pct_forward_matches_the_reference(cuda):
    """PCT at its published widths on one order's 33 masked clouds of 1024
    points, the benchmark's seeded weights: the plan's indices equal to
    the reference's (kernels 4 and 1 select as its FPS and fmaf-chain kNN
    do), kernels 4, 1, 10 and 9 launched, the median cloud's logits within
    1e-4 of their RMS (f32 rounding through the attention's energies, up
    to 2e4: the benchmark's cell reads 2e-5; a cloud whose softmax column
    sits at the normalisation's 1e-9 may jump, so the median)."""
    import json
    import os

    import numpy as np
    from interpret_quality_tpu_torch.models import build_model, make_forward_fn
    from iqbench import inputs, weights
    from iqbench.reference import attribution as A
    from iqbench.reference import pct as ref
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "iqbench", "configs", "pct.json")) as f:
        cfg = json.load(f)
    state = weights.seeded_state(cfg, 2 ** 31 + 5, cuda)
    model = build_model("pct", 10)
    model.load_state_dict(state, strict=True)
    fwd = make_forward_fn(model.to(cuda).eval())
    rng = np.random.RandomState(3)
    pc, _ = inputs.synthetic_cloud(rng, 1024)
    region = inputs.region_ids(pc, inputs.fps_np(pc, 32))
    masked = A.mask(torch.from_numpy(pc).to(cuda),
                    torch.from_numpy(A.keep_matrix(inputs.orders(rng, 1, 32)))
                    .to(cuda), torch.from_numpy(region).to(cuda)).contiguous()
    shift = torch.tensor([0.1, -0.2, 0.05], device=cuda)
    launch.reset_launches()
    with torch.inference_mode():
        plan = fwd.plan_fn(masked)
        got = fwd.apply_plan_fn(masked + shift, plan)
        want = ref.forward(state, cfg, masked + shift, ref.plan(cfg, masked))
    for port, theirs in zip(plan, ref.plan(cfg, masked)):
        assert all(torch.equal(a.long(), b) for a, b in zip(port, theirs))
    assert launch.launches("fps", "knn", "knn_group_max", "dense_pool") == {
        "fps": 2, "knn": 2, "knn_group_max": 2, "dense_pool": 1}
    per = (got - want).abs().amax(-1) / want.pow(2).mean().sqrt()
    assert float(per.median()) < 1e-4, per


# ------------------------------- kernel 11: PointMLP's grouped residual chain
# (B, S, N, C, kind): the four stages at the main path's shapes (a fiftieth
# of its 1650 clouds: the plain version writes (B, S, 24, C) tensors), a
# ragged tile, one centre, and clouds whose points all coincide (every u row
# equal, each centre its own row: h0 = relu(c), the empty coalition's case)
RES_CASES = [(33, 512, 1024, 128, "masked"), (33, 256, 512, 256, "masked"),
             (33, 128, 256, 512, "masked"), (33, 64, 128, 1024, "masked"),
             (3, 7, 40, 256, "masked"), (1, 1, 24, 1024, "masked"),
             (4, 64, 128, 1024, "coincident")]


def _res_args(device, B, S, N, C, kind, seed=0):
    """kNN indices with repeated slots (a masked cloud's collapsed points),
    the centres' rows, hoisted rows u, the centres' share c, each cloud's
    scale and two residual blocks, as ``models.pointmlp`` passes them."""
    g = torch.Generator().manual_seed(seed)
    if kind == "coincident":
        idx = torch.arange(24, dtype=torch.int32).expand(B, S, 24)
        fps = torch.zeros(B, S, dtype=torch.int32)
        u = torch.randn(B, 1, C, generator=g).expand(B, N, C)
        sig = torch.full((B,), 1e5)
    else:
        idx = torch.randint(0, N, (B, S, 24), generator=g, dtype=torch.int32)
        idx[:, :, 16:] = idx[:, :, :1]
        fps = torch.randint(0, N, (B, S), generator=g, dtype=torch.int32)
        u = torch.randn(B, N, C, generator=g)
        sig = torch.rand(B, generator=g) + 0.5
    c = torch.randn(B, S, C, generator=g) * 0.5
    blocks = [tuple(t.contiguous().to(device) for t in (
        torch.randn(C, C, generator=g) / C ** 0.5, 0.1 * torch.randn(C, generator=g),
        torch.randn(C, C, generator=g) / C ** 0.5, 0.1 * torch.randn(C, generator=g)))
        for _ in range(2)]
    return [t.contiguous().to(device) for t in (idx, fps, u, c, sig)] + [blocks]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,N,C,kind", RES_CASES)
def test_group_res_mlp_matches_plain(cuda, B, S, N, C, kind):
    """Kernel 11 at highest against its plain version, within 1e-4 of the
    largest value (the split drops lo*lo and sums in another order than
    cuBLAS, through four chained products: 1e-5 read at C = 1024), one
    launch; deterministic (a second launch bit-equal)."""
    from interpret_quality_tpu_torch.ops.cuda import group_mlp as gm
    args = _res_args(cuda, B, S, N, C, kind, seed=S + C)
    launch.reset_launches()
    got = gm.group_res_mlp(*args)
    torch.cuda.synchronize()
    assert got.shape == (B, S, C)
    assert launch.launches("group_res_mlp") == {"group_res_mlp": 1}
    assert _rel(got, gm.group_res_mlp_plain(*args)) < 1e-4
    assert torch.equal(gm.group_res_mlp(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("B,S,N,C,kind", RES_CASES[4:])
def test_group_res_mlp_one_pass_matches_emulation(cuda, B, S, N, C, kind,
                                                  precision):
    """Kernel 11 at a one-pass setting against ``emulation.
    group_res_mlp_at``: within ``_one_pass_close``'s shares of the
    setting's own rounding, or within four times what the emulation
    moves by when its products are summed in float64 instead of f32,
    whichever is wider.  Four products in a chain round each layer's f32
    output to TF32 or bf16 again, so an element that f32 summation order
    puts on the other side of a rounding boundary moves by a whole step of
    the one-pass operand, and the next layers carry that on: the kernel
    and the emulation then part by a share of the rounding that grows with
    depth (at ``high`` 0.14-0.36 of its RMS on the card, against 0.1 for
    the two-layer kernels), as the emulation parts from its own
    float64-summed twin (0.05-0.17 of the rounding on the CPU; the
    kernel's gap and the twin's each carry one side of such flips, so the
    factor).  Coarser than highest's; counted under its route."""
    from interpret_quality_tpu_torch.ops.cuda import emulation as em
    from interpret_quality_tpu_torch.ops.cuda import group_mlp as gm
    from interpret_quality_tpu_torch.ops.precision import round_bf16
    args = _res_args(cuda, B, S, N, C, kind, seed=S + C)
    launch.reset_launches()
    with _matmul_precision(precision):
        got = gm.group_res_mlp(*args)
    exact = gm.group_res_mlp_plain(*args)
    emulated = em.group_res_mlp_at(*args, precision=precision)
    rnd = em.round_tf32 if precision == "high" else round_bf16
    twin = gm.group_res_mlp_plain(*args, product=lambda h, w: torch.matmul(
        rnd(h).double(), rnd(w).double()).float())
    gap, rounding = (got - emulated).double(), (emulated - exact).double()
    order = (twin - emulated).double()

    def rms(t):
        return float(t.square().mean().sqrt())
    assert rms(gap) <= max(ONE_PASS_RMS_SHARE * rms(rounding), 4 * rms(order))
    assert float(gap.abs().max()) <= max(
        ONE_PASS_MAX_SHARE * float(rounding.abs().max()),
        4 * float(order.abs().max()))
    assert _rel(got, exact) > 1e-5
    assert launch.LAUNCHES[f"group_res_mlp:{precision}"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slots", "width", "int64", "devices"])
def test_group_res_mlp_refuses_what_the_kernel_does_not_take(cuda, case):
    """K other than 24, C outside 128-1024, int64 indices and tensors on two
    devices raise on the card; the plain version takes the shapes on the
    CPU."""
    from interpret_quality_tpu_torch.ops.cuda import group_mlp as gm
    C = 64 if case == "width" else 128
    idx, fps, u, c, sig, blocks = _res_args(cuda, 2, 8, 64, C, "masked")
    if case == "slots":
        idx = idx[..., :16].contiguous()
    elif case == "int64":
        idx = idx.long()
    elif case == "devices":
        sig = sig.cpu()
    with pytest.raises(ValueError):
        gm.group_res_mlp(idx, fps, u, c, sig, blocks)
    if case != "int64":
        cpu = [t.cpu() for t in (idx, fps, u, c, sig)]
        blocks = [tuple(t.cpu() for t in b) for b in blocks]
        assert gm.group_res_mlp(*cpu, blocks).shape == (2, 8, C)


@pytest.mark.cuda
def test_group_res_mlp_counts_slots_only_while_tracing(cuda):
    """Untraced, ``k11_slots`` counts nothing; traced, B x S x K a launch,
    and the launch runs inside ``iq_group_res_mlp``."""
    from torch.profiler import ProfilerActivity, profile
    from interpret_quality_tpu_torch.ops.cuda import group_mlp as gm
    from interpret_quality_tpu_torch.utils import profiling
    args = _res_args(cuda, *RES_CASES[4])
    profiling.reset_counters()
    gm.group_res_mlp(*args)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gm.group_res_mlp(*args)
        torch.cuda.synchronize()
    counts = profiling.counters()
    profiling.reset_counters()
    assert counts == {gm.K11_SLOTS: 3 * 7 * 24}
    assert "iq_group_res_mlp" in {e.key for e in prof.key_averages()}


def _pointmlp_case(device, seed):
    import json
    import os

    import numpy as np
    from interpret_quality_tpu_torch.models import build_model, make_forward_fn
    from iqbench import inputs, weights
    from iqbench.reference import attribution as A
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "iqbench", "configs", "pointmlp.json")) as f:
        cfg = json.load(f)
    state = weights.seeded_state(cfg, seed, device)
    model = build_model("pointmlp", 10)
    model.load_state_dict(state, strict=True)
    rng = np.random.RandomState(3)
    pc, _ = inputs.synthetic_cloud(rng, 1024)
    region = inputs.region_ids(pc, inputs.fps_np(pc, 32))
    masked = A.mask(torch.from_numpy(pc).to(device),
                    torch.from_numpy(A.keep_matrix(inputs.orders(rng, 1, 32)))
                    .to(device), torch.from_numpy(region).to(device)).contiguous()
    return cfg, state, make_forward_fn(model.to(device).eval()), masked


@pytest.mark.cuda
def test_pointmlp_forward_matches_the_reference(cuda):
    """PointMLP at its published widths on one order's 33 masked clouds of
    1024 points, the benchmark's seeded weights: the plan's indices equal
    to the reference's, kernels 4, 1 and 11 launched (four each), every
    cloud's logits within 1e-4 of their RMS (f32 rounding through 20
    layers: the benchmark's cell reads 6e-5 at its median)."""
    from iqbench.reference import pointmlp as ref
    cfg, state, fwd, masked = _pointmlp_case(cuda, 2 ** 31 + 5)
    shift = torch.tensor([0.1, -0.2, 0.05], device=cuda)
    launch.reset_launches()
    with torch.inference_mode():
        plan = fwd.plan_fn(masked)
        got = fwd.apply_plan_fn(masked + shift, plan)
        want = ref.forward(state, cfg, masked + shift, ref.plan(cfg, masked))
    for port, theirs in zip(plan, ref.plan(cfg, masked)):
        assert all(torch.equal(a.long(), b) for a, b in zip(port, theirs))
    assert launch.launches("fps", "knn", "group_res_mlp") == {
        "fps": 4, "knn": 4, "group_res_mlp": 4}
    per = (got - want).abs().amax(-1) / want.pow(2).mean().sqrt()
    assert float(per.max()) < 1e-4, per


@pytest.mark.cuda
def test_run_enum_smoke_on_pointmlp(cuda, tmp_path, monkeypatch):
    """save_fps, Shapley init and the trans enumeration on the plan path
    through the CLIs for PointMLP on one synthetic cloud (10 orders, two
    poses): four kernel-11 launches a forward, no fallback, finite
    artifacts of their shapes."""
    import importlib

    import numpy as np
    from interpret_quality_tpu_torch.config import ExperimentConfig
    monkeypatch.chdir(tmp_path)             # save_fps writes into the cwd
    common = ["--synthetic", "--allow_random_init", "--device", "cuda",
              "--checkpoints_root", str(tmp_path / "ck"), "--num_points",
              "1024", "--num_regions", "32", "--samples", "0"]
    orders = ["--num_samples_save", "10"]
    launch.reset_launches()
    for cli, argv in (("save_fps", ["--model", "pointmlp"]),
                      ("shapley_value", ["--model", "pointmlp", *orders]),
                      ("enum", ["--model", "pointmlp", "--mode", "trans",
                                *orders, "--num_samples", "10",
                                "--max_poses", "2"])):
        importlib.import_module(
            f"interpret_quality_tpu_torch.cli.{cli}").main(argv + common)
    torch.cuda.synchronize()
    n = launch.launches("group_res_mlp", "fps", "knn")
    assert n["group_res_mlp"] > 0 and n["group_res_mlp"] % 4 == 0, n
    assert n["fps"] == n["knn"] > 0, n
    folder = ExperimentConfig(model="pointmlp", checkpoints_root=str(tmp_path / "ck"),
                              num_points=1024, num_regions=32).exp_folder
    sv = np.load(folder + "synthetic_00/trans_all/region_shapley_value.npy")
    assert sv.shape == (2, 32) and np.isfinite(sv).all()
