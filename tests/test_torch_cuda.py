"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with nvcc and skips without one.  The
file imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""
import pytest
import torch

from interpret_quality_tpu_torch.ops.cuda import fps as fp
from interpret_quality_tpu_torch.ops.cuda import groups as gr
from interpret_quality_tpu_torch.ops.cuda import neighbors as nb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from interpret_quality_tpu_torch.models.common import set_fp32_matmuls
    set_fp32_matmuls()
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
    nb.reset_launches()
    idx = nb.knn(xs, xs, 20)
    assert torch.equal(idx, nb.knn_plain(xs, xs, 20))
    pmax, pmin = nb.gather_extrema_plain(idx, a)
    kmax, kmin = nb.knn_gather_extrema(xs, a, 20)
    gmax, gmin = nb.gather_extrema(idx, a)
    torch.cuda.synchronize()
    assert torch.equal(kmax, pmax) and torch.equal(kmin, pmin)
    assert torch.equal(gmax, pmax) and torch.equal(gmin, pmin)
    assert nb.LAUNCHES == {"knn": 1, "gather_extrema": 1,
                           "knn_gather_extrema": 1}


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
                                      (100, 7)])
def test_fps_bit_equal_to_plain(cuda, N, npoint):
    xyz = _cloud(cuda, 5, N, N)
    fp.reset_launches()
    got = fp.fps(xyz, npoint)
    assert torch.equal(got, fp.fps_plain(xyz, npoint))
    assert (got[:, 0] == 0).all() and fp.LAUNCHES == {"fps": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("k,collapse", [(32, True), (64, True), (20, False),
                                        (64, False)])
def test_knn_with_density_matches_plain(cuda, k, collapse):
    xyz = _cloud(cuda, 3, 256, k, collapse)
    query = xyz[:, :77].contiguous()
    inv = torch.rand(3, 256, device=cuda) + 0.5
    gr.reset_launches()
    idx, den, dmax = gr.knn_with_density(query, xyz, inv, k)
    pidx, pden, pdmax = gr.knn_with_density_plain(query, xyz, inv, k)
    assert torch.equal(idx, pidx)
    assert torch.equal(den, pden) and torch.equal(dmax, pdmax)
    assert gr.LAUNCHES["knn_with_density"] == 1


def _affine(g, cin, cout, cuda):
    return ((torch.randn(cin, cout, generator=g) / cin ** 0.5).to(cuda),
            (0.1 * torch.randn(cout, generator=g)).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("widths,k,radius,with_uf", [
    ((32, 32, 64), 16, 0.1, False), ((64, 96, 128), 128, 0.4, False),
    ((64, 64, 128), 32, 0.2, True), ((128, 128, 256), 64, 0.4, True)])
def test_ball_mlp3_matches_plain(cuda, widths, k, radius, with_uf):
    """Within rtol 1e-4, atol 1e-5 (f32 sums in another order); the clouds
    are random, so no point sits on a ball's boundary at f32 noise."""
    g = torch.Generator().manual_seed(k)
    xyz = _cloud(cuda, 2, 512, k, collapse=False)
    new_xyz = xyz[:, :128].contiguous()
    C1, C2, C3 = widths
    (a1, b1), (a2, b2), (a3, b3) = (_affine(g, 3 + (5 if with_uf else 0), C1, cuda),
                                    _affine(g, C1, C2, cuda),
                                    _affine(g, C2, C3, cuda))
    uf = None
    if with_uf:
        uf = torch.randn(2, 512, 5, generator=g).to(cuda) @ a1[:5]
        a1 = a1[5:]
    gr.reset_launches()
    got = gr.fused_ball_mlp3(new_xyz, xyz, uf, b1, a1, a2, b2, a3, b3,
                             radius=radius, k=k)
    want = gr.fused_ball_mlp3_plain(new_xyz, xyz, uf, b1, a1, a2, b2, a3, b3,
                                    radius=radius, k=k)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert gr.LAUNCHES["fused_ball_mlp3"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("widths,k,D", [((64, 64, 128), 32, 0),
                                        ((128, 128, 256), 64, 128),
                                        ((32, 32, 64), 20, 8)])
def test_pointconv_sa_matches_plain(cuda, widths, k, D):
    g = torch.Generator().manual_seed(k)
    xyz = _cloud(cuda, 2, 256, k)
    new_xyz = xyz[:, ::4].contiguous()
    inv = torch.rand(2, 256, generator=g).to(cuda) + 0.5
    idx, den, dmax = gr.knn_with_density(new_xyz, xyz, inv, k)
    C1, C2, C3 = widths
    (a1, b1), (a2, b2), (a3, b3) = (_affine(g, 3 + D, C1, cuda),
                                    _affine(g, C1, C2, cuda),
                                    _affine(g, C2, C3, cuda))
    src = torch.cat([xyz, torch.randn(2, 256, D, generator=g).to(cuda)], -1)
    u = src @ a1 + b1
    csw = new_xyz @ a1[:3]
    dnet = [_affine(g, 1, 16, cuda), _affine(g, 16, 8, cuda),
            _affine(g, 8, 1, cuda)]
    wnet = [_affine(g, 3, 8, cuda), _affine(g, 8, 8, cuda),
            _affine(g, 8, 16, cuda)]
    gr.reset_launches()
    args = (idx, den, dmax, new_xyz, u, xyz, csw, a2, b2, a3, b3, dnet, wnet)
    got = gr.fused_pointconv_sa(*args, k=k)
    want = gr.fused_pointconv_sa_plain(*args, k=k)
    assert got.shape == (2, 64, C3 * 16)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert gr.LAUNCHES["fused_pointconv_sa"] == 1


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
    gr.reset_launches()
    got = gr.gather_rows(values, idx)
    torch.cuda.synchronize()
    assert got.shape == (3, 256, 20, F)
    assert torch.equal(got, gr.gather_rows_plain(values, idx))
    assert gr.LAUNCHES["gather_rows"] == 1
