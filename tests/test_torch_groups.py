"""The plain versions of kernels 4-7 against the JAX package's Pallas
functions, in interpret mode at the exact settings (``select="two_pass"``:
lowest-index ties; ``parts=2``: hi/lo bf16 feature planes).

On the CPU the wrappers of ``ops/cuda/{fps,groups}`` run their plain
versions; the CUDA kernels are held against those on the card
(tests/test_torch_cuda.py and ``chip_smoke.py``).

Tolerances:
  * FPS and kNN indices: exactly equal, on random clouds and on a
    masked-coalition batch (whole regions on the centre: exact ties), and
    FPS with npoint > N;
  * gathered inverse densities and their max: 1e-6 relative;
  * fused_ball_mlp3 and fused_pointconv_sa: rtol 1e-4, atol 1e-5.  The
    Pallas side gathers the features as bf16 hi/lo planes (about 2^-16
    relative) and sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.ops.pallas import (fps_pallas, fused_ball_mlp3,
                                              fused_pointconv_sa,
                                              knn_with_density)
from interpret_quality_tpu_torch.attrib.coalitions import (
    keep_matrix_from_orders, masked_coalitions)
from interpret_quality_tpu_torch.ops.cuda import emulation as em
from interpret_quality_tpu_torch.ops.cuda import fps as fp
from interpret_quality_tpu_torch.ops.cuda import groups as gr
from interpret_quality_tpu_torch.ops.cuda import launch

TOL = dict(rtol=1e-4, atol=1e-5)


def _clouds(kind: str, n: int = 128) -> np.ndarray:
    rng = np.random.RandomState({"random": 0, "masked": 1}[kind])
    if kind == "random":
        return (rng.rand(2, n, 3) - 0.5).astype(np.float32)
    cloud = (rng.rand(n, 3) - 0.5).astype(np.float32)
    region_id = torch.from_numpy(rng.randint(0, 4, n))
    keep = torch.from_numpy(keep_matrix_from_orders(rng.permutation(4)[None]))
    data = torch.from_numpy(cloud)
    return masked_coalitions(data, data.mean(0), keep, region_id)[1:3].numpy()


KINDS = ["random", "masked"]


def _affines(rng, widths):
    out = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        out.append(((rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32),
                    (0.1 * rng.randn(cout)).astype(np.float32)))
    return out


def _t(tree):
    """numpy leaves -> torch (port) and jnp (JAX) copies."""
    if isinstance(tree, (list, tuple)):
        pairs = [_t(x) for x in tree]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return torch.from_numpy(tree), jnp.asarray(tree)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("npoint", [32, 200])
def test_fps_plain_equals_pallas(kind, npoint):
    xyz = _clouds(kind)
    got = fp.fps(torch.from_numpy(xyz), npoint).numpy()
    want = np.asarray(fps_pallas(jnp.asarray(xyz), npoint, interpret=True))
    assert got.dtype == np.int32 and (got[:, 0] == 0).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [16, 32])
def test_knn_with_density_plain_equals_pallas(kind, k):
    xyz = _clouds(kind)
    query = xyz[:, :32]
    inv = (np.random.RandomState(3).rand(2, 128) + 0.5).astype(np.float32)
    got = gr.knn_with_density(torch.from_numpy(query), torch.from_numpy(xyz),
                              torch.from_numpy(inv), k)
    want = knn_with_density(jnp.asarray(query), jnp.asarray(xyz),
                            jnp.asarray(inv), k, select="two_pass",
                            interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("D,widths,radius,k", [
    (0, (32, 32, 64), 0.1, 16), (0, (64, 96, 128), 0.4, 128),
    (24, (64, 64, 128), 0.2, 32)])
def test_fused_ball_mlp3_plain_equals_pallas(kind, D, widths, radius, k):
    """Without uf (SA1's branches) and with it (SA2's)."""
    rng = np.random.RandomState(k)
    xyz = _clouds(kind)
    new_xyz = xyz[:, ::4]                        # centres are cloud points
    (a1, b1), (a2, b2), (a3, b3) = _affines(rng, (D + 3,) + widths)
    feats = rng.randn(2, 128, D).astype(np.float32)
    uf = feats @ a1[:D] if D else None
    args = [new_xyz, xyz, uf, b1, a1[D:], a2, b2, a3, b3]
    tt = [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
          for a in args]
    jj = [None if a is None else jnp.asarray(a) for a in args]
    got = gr.fused_ball_mlp3(*tt, radius=radius, k=k).numpy()
    want = np.asarray(fused_ball_mlp3(*jj, radius=radius, k=k, parts=2,
                                      interpret=True))
    assert got.shape == (2, 32, widths[-1])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("D,widths,k", [(0, (64, 64, 128), 16),
                                        (16, (32, 48, 64), 32)])
def test_fused_pointconv_sa_plain_equals_pallas(kind, D, widths, k):
    rng = np.random.RandomState(k + D)
    xyz = _clouds(kind)
    new_xyz = xyz[:, ::4]
    inv = (rng.rand(2, 128) + 0.5).astype(np.float32)
    idx, den, dmax = gr.knn_with_density_plain(
        torch.from_numpy(new_xyz), torch.from_numpy(xyz),
        torch.from_numpy(inv), k)
    (a1, b1), (a2, b2), (a3, b3) = _affines(rng, (D + 3,) + widths)
    src = np.concatenate([xyz, rng.randn(2, 128, D).astype(np.float32)], -1)
    u = src @ a1 + b1
    csw = new_xyz @ a1[:3]
    dnet = _affines(rng, (1, 16, 8, 1))
    wnet = _affines(rng, (3, 8, 8, 16))
    arrays = [idx.numpy(), den.numpy(), dmax.numpy(), new_xyz, u, xyz, csw,
              a2, b2, a3, b3]
    tt, jj = _t([np.ascontiguousarray(a) for a in arrays])
    (td, jd), (tw, jw) = _t(dnet), _t(wnet)
    got = gr.fused_pointconv_sa(*tt, td, tw, k=k).numpy()
    want = np.asarray(fused_pointconv_sa(*jj, jd, jw, k=k, parts=2,
                                         interpret=True))
    assert got.shape == (2, 32, widths[-1] * 16)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_fps_register_route_argmax_equals_pallas(kind):
    """The argmax rule of the CUDA kernel's register route (emulated in
    plain PyTorch) against the Pallas kernel: exactly equal indices."""
    xyz = _clouds(kind)
    got = em.fps_register_route(torch.from_numpy(xyz), 48).numpy()
    want = np.asarray(fps_pallas(jnp.asarray(xyz), 48, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_pointconv_sa_kernel_arithmetic_close_to_pallas(kind):
    """The CUDA kernel's arithmetic (three TF32 products in layers 2-3 and
    in the contraction, emulated in plain PyTorch) against the Pallas
    kernel at SA1's widths: the tolerance of the plain version."""
    rng = np.random.RandomState(11)
    xyz = _clouds(kind)
    new_xyz, k = xyz[:, ::4], 16
    inv = (rng.rand(2, 128) + 0.5).astype(np.float32)
    idx, den, dmax = gr.knn_with_density_plain(
        torch.from_numpy(new_xyz), torch.from_numpy(xyz),
        torch.from_numpy(inv), k)
    (a1, b1), (a2, b2), (a3, b3) = _affines(rng, (3, 64, 64, 128))
    arrays = [idx.numpy(), den.numpy(), dmax.numpy(), new_xyz, xyz @ a1 + b1,
              xyz, new_xyz @ a1, a2, b2, a3, b3]
    tt, jj = _t([np.ascontiguousarray(a) for a in arrays])
    (td, jd), (tw, jw) = _t(_affines(rng, (1, 16, 8, 1))), _t(
        _affines(rng, (3, 8, 8, 16)))
    got = em.pointconv_sa_3xtf32(*tt, td, tw, k=k).numpy()
    want = np.asarray(fused_pointconv_sa(*jj, jd, jw, k=k, parts=2,
                                         interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    xyz = torch.from_numpy(_clouds("masked"))
    inv = torch.rand(2, 128) + 0.5
    launch.reset_launches()
    assert torch.equal(fp.fps(xyz, 16), fp.fps_plain(xyz, 16))
    for g, w in zip(gr.knn_with_density(xyz, xyz, inv, 8),
                    gr.knn_with_density_plain(xyz, xyz, inv, 8)):
        assert torch.equal(g, w)
    assert launch.launches("fps") == {"fps": 0}
    assert set(launch.LAUNCHES.values()) == {0}


def test_launch_registry_counts_kernels_and_routes():
    """A launch counts under its kernel, and at a setting other than the
    exact one under "<kernel>:<setting>" as well; a reading since an
    earlier one subtracts it, a kernel or setting the registry does not
    know raises and counts nothing, and a reset zeroes every count."""
    launch.reset_launches()
    before = launch.launches()
    launch.count_launch("fused_ball_mlp3", "highest")
    launch.count_launch("fused_ball_mlp3", "default")
    launch.count_launch("knn", "exact")
    launch.count_launch("gather_rows")
    assert launch.launches(since=before) == dict(
        dict.fromkeys(launch.KERNELS, 0), fused_ball_mlp3=2, knn=1,
        gather_rows=1)
    assert {k: v for k, v in launch.LAUNCHES.items()
            if v and k not in launch.KERNELS} == {"fused_ball_mlp3:default": 1}
    counted = dict(launch.LAUNCHES)
    for kernel, setting in (("fps", "bf16"), ("knn", "high"),
                            ("ball_query", None)):
        with pytest.raises(KeyError):
            launch.count_launch(kernel, setting)
    assert launch.LAUNCHES == counted
    launch.reset_launches()
    assert set(launch.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("call", ["fps", "knn_with_density",
                                  "fused_ball_mlp3", "fused_pointconv_sa"])
def test_non_cpu_tensors_never_reach_a_plain_version(call):
    """A tensor off the CPU goes to the kernel or raises; here meta tensors
    (neither CPU nor CUDA) must raise, not compute."""
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype,
                                                        device="meta")
    w = torch.zeros(8, 8)
    calls = {
        "fps": lambda: fp.fps(m(2, 16, 3), 4),
        "knn_with_density": lambda: gr.knn_with_density(
            m(2, 4, 3), m(2, 16, 3), m(2, 16), 4),
        "fused_ball_mlp3": lambda: gr.fused_ball_mlp3(
            m(2, 4, 3), m(2, 16, 3), None, w[0], w[:3], w, w[0], w, w[0],
            radius=0.2, k=4),
        "fused_pointconv_sa": lambda: gr.fused_pointconv_sa(
            m(2, 4, 4, dtype=torch.int32), m(2, 4, 4), m(2, 4, 1), m(2, 4, 3),
            m(2, 16, 8), m(2, 16, 3), m(2, 4, 8), w, w[0], w, w[0], [], [],
            k=4),
    }
    with pytest.raises(ValueError):
        calls[call]()
