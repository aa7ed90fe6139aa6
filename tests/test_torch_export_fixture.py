"""The port's small helpers against the JAX package's scripts:
``export_t7_torch`` turns a flax ``.msgpack`` into the same ``.t7`` as
``export_t7.py --template <the port's own .t7>`` (the same keys and
bit-equal tensors) that loads into the port's module with ``strict=True``;
``make_shapenet_fixture_torch`` writes a tree byte-equal to the JAX
script's.
"""
import contextlib
import importlib.util
import io
import os
import pathlib
import sys

import pytest
import torch

from interpret_quality_tpu.models.checkpoint import save_variables
from interpret_quality_tpu.models.torch_convert import convert_state_dict
from interpret_quality_tpu_torch.models import build_model

from test_torch_checkpoint import seeded_state

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_ef_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main()


@pytest.fixture()
def msgpack_and_template(tmp_path):
    """A GCNN checkpoint as the JAX package saves it (every BatchNorm
    randomised) and the port's own .t7 of a fresh model as the template."""
    state = seeded_state("gcnn")
    variables = convert_state_dict(
        "gcnn", {k: v.numpy() for k, v in state.items()})
    ckpt = str(tmp_path / "models" / "model_best.msgpack")
    save_variables(ckpt, variables)
    template = str(tmp_path / "template.t7")
    torch.save(build_model("gcnn", num_classes=10).state_dict(), template)
    return state, ckpt, template


def test_export_t7_equals_jax(msgpack_and_template, tmp_path, monkeypatch):
    state, ckpt, template = msgpack_and_template
    _jax_main(_script("export_t7"), [
        "--model", "gcnn", "--ckpt", ckpt, "--out", str(tmp_path / "jax.t7"),
        "--template", template], monkeypatch)
    port = _script("export_t7_torch")
    with contextlib.redirect_stdout(io.StringIO()):
        port.main(["--model", "gcnn", "--ckpt", ckpt, "--out",
                   str(tmp_path / "port.t7")])
    want = torch.load(tmp_path / "jax.t7")
    got = torch.load(tmp_path / "port.t7")
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], state[key]), key
    model = build_model("gcnn", num_classes=10)
    model.load_state_dict(got, strict=True)
    # --template as a layout check: the same export, and adv-GCNN's too
    with contextlib.redirect_stdout(io.StringIO()):
        port.main(["--model", "gcnn_adv", "--ckpt", ckpt, "--out",
                   str(tmp_path / "adv.t7"), "--template", template])
    adv = torch.load(tmp_path / "adv.t7")
    assert set(adv) == set(got) and all(torch.equal(adv[k], got[k])
                                        for k in got)


def test_export_t7_template_layout(msgpack_and_template, tmp_path):
    """A template with ``module.`` prefixes gets them in the output; a
    template of another family's layout is refused."""
    _, ckpt, template = msgpack_and_template
    port = _script("export_t7_torch")
    prefixed = str(tmp_path / "prefixed.t7")
    torch.save({"module." + k: v for k, v in torch.load(template).items()},
               prefixed)
    with contextlib.redirect_stdout(io.StringIO()):
        port.main(["--model", "gcnn", "--ckpt", ckpt, "--out",
                   str(tmp_path / "out.t7"), "--template", prefixed])
    out = torch.load(tmp_path / "out.t7")
    assert all(k.startswith("module.") for k in out)
    other = str(tmp_path / "pointnet.t7")
    torch.save(build_model("pointnet", num_classes=10).state_dict(), other)
    with pytest.raises(SystemExit, match="template"):
        port.main(["--model", "gcnn", "--ckpt", ckpt, "--out",
                   str(tmp_path / "bad.t7"), "--template", other])
    assert not os.path.exists(tmp_path / "bad.t7")


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(pathlib.Path(root).rglob("*")) if p.is_file()}


def test_shapenet_fixture_is_byte_equal(tmp_path, monkeypatch):
    argv = ["--train_per_class", "2", "--test_per_class", "1",
            "--points", "64"]
    _jax_main(_script("make_shapenet_fixture"),
              argv + ["--data_root", str(tmp_path / "jax")], monkeypatch)
    port = _script("make_shapenet_fixture_torch")
    with contextlib.redirect_stdout(io.StringIO()):
        port.main(argv + ["--data_root", str(tmp_path / "port")])
    want = _files(tmp_path / "jax")
    got = _files(tmp_path / "port")
    assert got.keys() == want.keys()
    splits = [n for n in got if "/train_test_split/" in n]
    assert len(splits) == 3 and len(got) > 40
    for name, data in want.items():
        assert got[name] == data, name
