"""The port's checkpoint loading: flax ``.msgpack`` files written by the JAX
package (``save_variables``) load into every family without flax and give
the JAX XLA path's logits (rtol 1e-4, atol 1e-4, as
``tests/test_torch_models.py``: f32 sums in another order); the decoder
follows flax's own on numpy scalars and chunked arrays; a missing
``msgpack`` package raises; and ``load_frozen_model`` takes the adv-GCNN
``model_best`` fallback only for the default path.

The JAX variables come from a seeded port model with every BatchNorm
randomised (statistics, and scales of both signs), carried over by the JAX
package's own ``convert_state_dict``: no flax init, so the five families
cost seconds, not minutes.
"""
import os
import sys

import numpy as np
import pytest
import torch
from flax import serialization

from interpret_quality_tpu.models import build_model as jax_build_model
from interpret_quality_tpu.models.checkpoint import save_variables
from interpret_quality_tpu.models.torch_convert import convert_state_dict
from interpret_quality_tpu_torch.config import ExperimentConfig
from interpret_quality_tpu_torch.models import build_model, make_forward_fn
from interpret_quality_tpu_torch.models.checkpoint import (load_checkpoint,
                                                           read_msgpack)
from interpret_quality_tpu_torch.pipeline import load_frozen_model

from test_torch_pointmodels import _jax_logits, coalition_batch

TOL = dict(rtol=1e-4, atol=1e-4)


def seeded_state(name, seed=0):
    """A port model's state dict with every BatchNorm randomised."""
    torch.manual_seed(seed)
    model = build_model(name, num_classes=10)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                bn.weight.uniform_(0.5, 1.5).mul_(
                    torch.where(torch.rand_like(bn.weight) < 0.5, -1.0, 1.0))
                bn.bias.normal_(0, 0.1)
                bn.running_mean.normal_(0, 0.1)
                bn.running_var.uniform_(0.5, 1.5)
    return model.state_dict()


@pytest.mark.parametrize("name", ["pointnet", "pointnet2", "pointconv",
                                  "dgcnn", "gcnn"])
def test_msgpack_from_jax_gives_jax_logits(name, tmp_path):
    state = seeded_state(name)
    variables = convert_state_dict(
        name, {key: value.numpy() for key, value in state.items()})
    path = str(tmp_path / "models" / "model_best.msgpack")
    save_variables(path, variables)
    loaded = load_checkpoint(name, path)
    model = build_model(name, num_classes=10)
    model.load_state_dict(loaded, strict=True)
    for key, value in state.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(loaded[key], value), key
    x = coalition_batch()[:2]
    with torch.inference_mode():
        got = make_forward_fn(model.eval())(torch.from_numpy(x)).numpy()
    want = _jax_logits(jax_build_model(name, num_classes=10, k=20),
                       variables, x)
    assert got.shape == want.shape == (2, 10) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, **TOL)


def test_msgpack_decoder_matches_flax(tmp_path, monkeypatch):
    """Numpy scalars (ext 3), integer arrays, nested dicts and arrays flax
    splits into chunks, decoded as flax decodes them; an extension type a
    checkpoint of arrays does not use (2, a complex scalar) raises."""
    rng = np.random.RandomState(0)
    tree = {"params": {"a": rng.randn(3, 4).astype(np.float32),
                       "big": rng.randn(40, 7).astype(np.float32),
                       "b": {"c": np.arange(5, dtype=np.int32)}},
            "step": np.int64(7), "scale": np.float32(0.5)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)  # "big" chunks
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    path = tmp_path / "tree.msgpack"
    path.write_bytes(data)
    got = read_msgpack(str(path))
    want = serialization.msgpack_restore(data)
    assert set(got) == set(want) and set(got["params"]) == set(want["params"])
    for key in ("a", "big"):
        np.testing.assert_array_equal(got["params"][key], want["params"][key])
    np.testing.assert_array_equal(got["params"]["b"]["c"], np.arange(5))
    assert got["step"] == 7 and got["scale"] == np.float32(0.5)
    path.write_bytes(serialization.msgpack_serialize({"z": 1 + 2j}))
    with pytest.raises(ValueError, match="extension type 2"):
        read_msgpack(str(path))


def test_msgpack_without_the_package_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "m.msgpack")
    save_variables(path, {"params": {"w": np.ones(3, np.float32)}})
    monkeypatch.setitem(sys.modules, "msgpack", None)       # import fails
    with pytest.raises(ImportError, match="msgpack"):
        load_checkpoint("dgcnn", path)


def _adv_cfg(root, **kw):
    return ExperimentConfig(model="gcnn_adv", checkpoints_root=str(root),
                            num_points=128, device="cpu", **kw)


def test_adv_gcnn_falls_back_to_model_best(tmp_path, capsys):
    """No model_399.t7 at the default path: the same run's model_best.t7
    loads, and the substitution is printed."""
    state = seeded_state("gcnn_adv", seed=4)
    cfg = _adv_cfg(tmp_path)
    default = cfg.default_model_path()
    assert default.endswith("_clean_with_all_rot_da/models/model_399.t7")
    best = default.replace("model_399.t7", "model_best.t7")
    os.makedirs(os.path.dirname(best))
    torch.save(state, best)
    model, forward, device = load_frozen_model(cfg)
    assert "substituting best checkpoint" in capsys.readouterr().out
    assert str(device) == "cpu"
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_explicit_missing_path_raises(tmp_path):
    cfg = _adv_cfg(tmp_path)
    best = cfg.default_model_path().replace("model_399.t7", "model_best.t7")
    os.makedirs(os.path.dirname(best))
    torch.save(seeded_state("gcnn_adv"), best)
    missing = str(tmp_path / "elsewhere" / "model_399.t7")
    with pytest.raises(FileNotFoundError, match="not found"):
        load_frozen_model(_adv_cfg(tmp_path, model_path=missing))
    # no model_best either: the default path raises too
    with pytest.raises(FileNotFoundError, match="not found"):
        load_frozen_model(_adv_cfg(tmp_path / "empty"))
