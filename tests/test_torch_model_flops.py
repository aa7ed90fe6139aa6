"""``scripts/model_flops_torch.py`` re-derives ``bench.py``'s GFLOP table
from the port's models: the count it takes (un-fused forward for PointNet,
PointNet++ and PointConv, the hoisted edge conv of the eval path for DGCNN
and GCNN) lies within 10% of the JAX package's XLA count for every family
(``FlopCounterMode`` counts matmuls and convolutions only, XLA elementwise
work too), and the port's un-fused edge conv shows its k-fold gap.
"""
import ast
import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REL_TOL = 0.10


def _bench_py_table():
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "GFLOP_PER_FORWARD"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("no GFLOP_PER_FORWARD in bench.py")


@pytest.fixture(scope="module")
def flops():
    spec = importlib.util.spec_from_file_location(
        "_model_flops_torch", REPO / "scripts" / "model_flops_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["pointnet", "pointnet2", "pointconv",
                                  "dgcnn", "gcnn"])
def test_count_is_bench_py_s_within_ten_percent(flops, name):
    want = _bench_py_table()[name]
    edge = name in flops.EDGE_CONV
    counted = flops.forward_gflop(name, fused=edge)
    assert abs(counted - want) <= REL_TOL * want, (name, counted, want)
    if edge:
        # the port's un-fused edge conv multiplies all k gathered edge
        # features: 2.7x (DGCNN) and 3.6x (GCNN) the hoisted count
        unfused = flops.forward_gflop(name, fused=False)
        assert unfused > 2.5 * counted, (name, unfused, counted)


def test_cli_prints_both_columns(flops, capsys):
    flops.main(["--num_points", "64"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# GFLOP per forward at N=64")
    rows = lines[1:]
    assert [r.split('"')[1] for r in rows] == flops.MODELS
    assert all("unfused" in r and "eval" in r for r in rows)
