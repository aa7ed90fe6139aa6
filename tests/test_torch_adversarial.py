"""The port's axis-angle rotation and BIM attacks against the JAX
package's, on the same inputs.

  * ``rot_angle_axis``: values in float32 within 1e-6; gradients with
    respect to all four arguments in float64 against ``jax.grad`` within
    1e-10.
  * Both attacks on the JAX tests' toy loss (``tests/test_training.py``) in
    float64: the attacked clouds within 1e-10, and the JAX tests'
    invariants (norms kept by a rotation, one translation per cloud inside
    the ball).
  * Both attacks through GCNN (``make_adv_batch_fn``: the eval model on
    its un-fused forward), at 96 points with k = 4 and 128 points with
    k = 20, in float64 within 1e-8.  The weights are a seeded port model's
    with every BatchNorm randomised, carried into JAX variables by the JAX
    package's ``convert_state_dict``.

Why the GCNN comparison holds to 1e-8, and what it checks first:

  * A rotation destroys the exact distances of a 1/64 grid (the train-step
    tests' clouds), so the clouds here are random, non-grid, float64.  The
    kNN graph is a selection: the test asserts the port's own gap between
    every k-th and (k+1)-th squared distance at the attacked clouds, where
    two float64 arithmetic orders cannot swap a neighbour.
  * ``sign(g_alpha)`` turns any difference near 0 into a whole step: the
    test records the port's |g_alpha| at every step and asserts it stays
    far above float64 noise.
  * Max ties and LeakyReLU at exactly 0 differ between the packages (flax
    takes ``x >= 0``); random float64 data meet neither.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpret_quality_tpu.models import build_model as jax_build_model
from interpret_quality_tpu.models.torch_convert import convert_state_dict
from interpret_quality_tpu.ops.transforms import \
    rot_angle_axis as jax_rot_angle_axis
from interpret_quality_tpu.train import adversarial as jax_adv
from interpret_quality_tpu_torch.models import build_model
from interpret_quality_tpu_torch.ops.transforms import rot_angle_axis
from interpret_quality_tpu_torch.train import adversarial as adv

from test_torch_checkpoint import seeded_state

GRAD_MARGIN = 1e-9      # kNN gap at the attacked cloud, relative to max |x|^2
G_ALPHA_FLOOR = 1e-9    # |g_alpha| at every step, far above f64 noise
TOY_TOL = dict(rtol=1e-10, atol=1e-10)
GCNN_TOL = dict(rtol=1e-8, atol=1e-8)


def angles(rng, B):
    return (rng.uniform(-np.pi / 2, np.pi / 2, B),
            rng.uniform(0, np.pi, B), rng.uniform(0, 2 * np.pi, B))


def test_rot_angle_axis_values_match_jax_in_float32():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 50, 3).astype(np.float32)
    a, t, p = (v.astype(np.float32) for v in angles(rng, 3))
    got = rot_angle_axis(*(torch.from_numpy(v) for v in (x, a, t, p)))
    want = np.asarray(jax_rot_angle_axis(*(jnp.asarray(v)
                                           for v in (x, a, t, p))))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)


def test_rot_angle_axis_gradients_match_jax_in_float64():
    """d/d(x, angle, theta, phi) of sum(rot * w) for a random w."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 20, 3)
    w = rng.randn(2, 20, 3)
    args = (x, *angles(rng, 2))
    with jax.enable_x64(True):
        want = jax.grad(lambda *v: jnp.sum(jax_rot_angle_axis(*v) * w),
                        argnums=(0, 1, 2, 3))(*(jnp.asarray(v) for v in args))
        want = [np.asarray(g) for g in want]
    tensors = [torch.tensor(v, requires_grad=True) for v in args]
    out = (rot_angle_axis(*tensors) * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(out, tensors)
    for g, ref in zip(got, want):
        assert g.dtype == torch.float64 and np.abs(ref).max() > 1e-3
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-10, atol=1e-10)


def toy_losses(target):
    """The JAX tests' toy loss in both packages: lower when the points
    align with ``target``."""
    def jax_loss(clouds, labels):
        return jnp.mean((jnp.mean(clouds @ jnp.asarray(target), axis=1)
                         - 1.0) ** 2)

    def port_loss(clouds, labels):
        return ((torch.mean(clouds @ torch.from_numpy(target), dim=1)
                 - 1.0) ** 2).mean()
    return jax_loss, port_loss


@pytest.mark.parametrize("iterations", [3, adv.ROT_ADV_ITER])
def test_rotation_attack_on_toy_loss_matches_jax(iterations):
    rng = np.random.RandomState(2)
    data = rng.randn(2, 32, 3)
    jax_loss, port_loss = toy_losses(np.array([1.0, 0.0, 0.0]))
    with jax.enable_x64(True):
        want = np.asarray(jax_adv.bim_rotation_attack(
            jax_loss, jnp.asarray(data), jnp.zeros(2, jnp.int32),
            iterations=iterations))
    got = adv.bim_rotation_attack(port_loss, torch.from_numpy(data),
                                  torch.zeros(2, dtype=torch.long),
                                  iterations=iterations).numpy()
    np.testing.assert_allclose(got, want, **TOY_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1),
                               np.linalg.norm(data, axis=-1), rtol=1e-12)
    assert not np.allclose(got, data)


def test_translation_attack_on_toy_loss_matches_jax():
    rng = np.random.RandomState(3)
    data = rng.randn(2, 32, 3)
    jax_loss, port_loss = toy_losses(np.array([0.0, 1.0, 0.0]))
    with jax.enable_x64(True):
        want = np.asarray(jax_adv.bim_translation_attack(
            jax_loss, jnp.asarray(data), jnp.zeros(2, jnp.int32)))
    got = adv.bim_translation_attack(port_loss, torch.from_numpy(data),
                                     torch.zeros(2, dtype=torch.long)).numpy()
    np.testing.assert_allclose(got, want, **TOY_TOL)
    shift = got - data
    assert np.abs(shift - shift[:, :1]).max() < 1e-12    # one per cloud
    norms = np.linalg.norm(shift[:, 0], axis=-1)
    assert (norms <= adv.TRANS_ADV_THRESHOLD + 1e-12).all()
    assert (norms > 0.1).all()


def test_attack_constants_are_the_reference_recipe():
    assert adv.ROT_ADV_ITER == jax_adv.ROT_ADV_ITER == 7
    assert adv.TRANS_ADV_ITER == jax_adv.TRANS_ADV_ITER == 3
    np.testing.assert_allclose([adv.ROT_ADV_STEP, adv.ROT_ADV_THRESHOLD],
                               [np.pi / 10, np.pi / 2])
    np.testing.assert_allclose([adv.TRANS_ADV_STEP, adv.TRANS_ADV_THRESHOLD],
                               [0.4, 1.0])


def knn_gap(x: np.ndarray, k: int) -> float:
    """Smallest gap between a k-th and (k+1)-th squared distance over the
    clouds x (B, N, 3), relative to the cloud's largest |x|^2."""
    d = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    d.sort(-1)
    scale = (x ** 2).sum(-1).max(-1)[:, None, None]
    return float(((d[..., k] - d[..., k - 1])[..., None] / scale).min())


def recorded_alpha_gradients(monkeypatch):
    """|g_alpha| of every rotation step the port's attack takes."""
    seen = []
    original = adv.rot_angle_axis

    def rot(x, angle, theta, phi):
        if angle.requires_grad:
            angle.register_hook(lambda g: seen.append(g.detach().clone()))
        return original(x, angle, theta, phi)
    monkeypatch.setattr(adv, "rot_angle_axis", rot)
    return seen


@pytest.mark.parametrize("n,k", [(96, 4), (128, 20)])
def test_attacks_through_gcnn_match_jax(n, k, monkeypatch):
    B = 4
    rng = np.random.RandomState(k)
    data = rng.uniform(-1, 1, (B, n, 3))
    labels = rng.randint(0, 10, B).astype(np.int32)
    state = seeded_state("gcnn")
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            convert_state_dict("gcnn", {key: v.numpy()
                                        for key, v in state.items()}))
        gen = jax_adv.make_adv_batch_fn(
            jax_build_model("gcnn", num_classes=10, k=k))
        want_rot, want_dis = (np.asarray(v) for v in gen(
            variables, jnp.asarray(data), jnp.asarray(labels)))

    model = build_model("gcnn", num_classes=10, k=k)
    model.load_state_dict(state, strict=True)
    model = model.double().train()          # the attack switches to eval
    model.dp1.eval()                        # ... and back, module by module
    before = {key: v.clone() for key, v in model.state_dict().items()}
    g_alpha = recorded_alpha_gradients(monkeypatch)
    got_rot, got_dis = adv.make_adv_batch_fn(model)(
        torch.from_numpy(data), torch.from_numpy(labels).long())

    assert model.training and not model.dp1.training   # modes restored
    assert all(p.grad is None for p in model.parameters())
    assert all(torch.equal(v, before[key])
               for key, v in model.state_dict().items())
    assert len(g_alpha) == adv.ROT_ADV_ITER
    assert float(torch.stack(g_alpha).abs().min()) > G_ALPHA_FLOOR
    for x in (got_rot.numpy(), got_dis.numpy()):
        assert knn_gap(x, k) > GRAD_MARGIN
    np.testing.assert_allclose(got_rot.numpy(), want_rot, **GCNN_TOL)
    np.testing.assert_allclose(got_dis.numpy(), want_dis, **GCNN_TOL)
    # the attack moved every cloud, within its bounds
    np.testing.assert_allclose(np.linalg.norm(got_rot.numpy(), axis=-1),
                               np.linalg.norm(data, axis=-1), rtol=1e-12)
    shift = (got_dis - got_rot).numpy()[:, 0]
    assert (np.linalg.norm(shift, axis=-1)
            <= adv.TRANS_ADV_THRESHOLD + 1e-12).all()
    assert not np.allclose(got_rot.numpy(), data)
