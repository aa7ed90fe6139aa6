"""The frozen counts against hand counts at small shapes: distinct points
of masked clouds, PointNet++'s ball counts, kernel 3's and kernel 5's
least times and the operations behind the MFU metric."""
import os

import numpy as np
import pytest
import torch

from iqbench import harness, work
from iqbench.reference import dgcnn as ref_dgcnn
from iqbench.reference import pointnet2 as ref_pointnet2

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAKS = {"hbm_bytes_per_s": 1.0, "f32_flops_per_s": 1.0,
         "tf32_flops_per_s": 1.0, "tf32_passes_for_f32": 3}


def metric(name):
    return harness.load_module(os.path.join(PKG, "metrics", name + ".py"),
                               "m_" + name.replace(".", "_"))


def test_distinct_points():
    region = np.array([0, 0, 1, 2, 2, 2])
    keep = np.array([[True, True, True],      # all kept: 6 distinct
                     [False, False, False],   # all collapsed: 1
                     [True, False, True]])    # 5 kept + the centre
    assert work.distinct_points(keep, region).tolist() == [6, 1, 6]


def brute_ball(cfg, x, ident):
    """The same counts by plain loops."""
    from iqbench.reference.pointnet2 import fps
    out = {}
    for level in ("sa1", "sa2"):
        spec = cfg[level]
        idx = fps(x[None], spec["npoint"])[0].tolist()
        seen, centres = set(), []
        for i in idx:
            if ident[i] not in seen:
                seen.add(ident[i])
                centres.append(i)
        slots = []
        for r, k in zip(spec["radii"], spec["nsamples"]):
            total = 0
            for c in centres:
                inb = [j for j in range(len(x))
                       if float(((x[j] - x[c]) ** 2).sum()) <= r * r][:k]
                total += len({ident[j] for j in inb})
            slots.append(total)
        db = len(set(ident))
        out[level] = {"centres": len(centres), "db": db,
                      "centres_db": len(centres) * db, "slots": slots}
        x, ident = x[idx], [ident[i] for i in idx]
    return out


def test_ball_counts_by_hand():
    cfg = {"sa1": {"npoint": 6, "radii": [0.3, 0.9], "nsamples": [2, 8]},
           "sa2": {"npoint": 3, "radii": [1.0], "nsamples": [4]}}
    g = torch.Generator().manual_seed(0)
    x = torch.rand(10, 3, generator=g)
    ident = list(range(10))
    x[7:] = x[:3].mean(0)                   # three collapsed points
    ident[7:] = [10, 10, 10]
    got = ref_pointnet2.ball_counts(cfg, x[None], torch.tensor([ident]))
    assert got == brute_ball(cfg, x, ident)


def test_k3_least_time_by_hand():
    k3 = metric("k3_roofline")
    # B=1, N=4, C=2, F=3, k=2, one cloud of 3 distinct rows
    nbytes = 4 * 1 * 4 * (2 + 3 * 3)
    tc = 2 * 2 * 3 * 3
    f32 = 3 * 9 + 2 * 2 * 3 * 3
    assert k3.launch_seconds(1, 4, 2, 3, 2, 3, 9, PEAKS) == max(nbytes, f32, 3 * tc)


def small_dgcnn():
    return {"family": "dgcnn", "reference": "iqbench/reference/dgcnn.py",
            "num_points": 5, "input_channels": 3, "k": 2,
            "edge_widths": [4, 6], "emb_dims": 7, "fc_widths": [3, 2],
            "num_classes": 2}


@pytest.mark.parametrize("plans", [0, 1])
def test_mfu_attrib_dgcnn_operations_by_hand(plans):
    c = small_dgcnn()
    d = np.array([5, 2])
    entry = {"clouds": 2, "d": d, "forwards": 3, "plans": plans}
    per = sum(2 * 3 * 4 * n + 2 * 4 * 6 * n + 10 * 7 * n for n in d)
    per += 4 * (d ** 2).sum() + (0 if plans else 3 * (d ** 2).sum())
    per += 2 * (14 * 3 + 3 * 2 + 2 * 2)
    want = 2 * (3 * per + plans * 3 * (d ** 2).sum())
    assert ref_dgcnn.flops(c, entry) == want
    # the reader finds the family's count through the configuration
    ctx = FakeContext(c, [entry, entry], window_s=2.0)
    assert metric("mfu.attrib").read(ctx) == pytest.approx(100.0 * want)


class FakeTrace:
    def __init__(self, seconds):
        self.seconds = seconds

    def device_s(self, inside, outside=()):
        return self.seconds


class FakeContext:
    def __init__(self, cfg, entries, device_s=1.0, window_s=1.0):
        self.cfg, self.entries, self.peaks = cfg, entries, PEAKS
        self.trace, self.window_s = FakeTrace(device_s), window_s

    def work(self):
        return self.entries


def small_pointnet2():
    return {"family": "pointnet2", "reference": "iqbench/reference/pointnet2.py",
            "num_points": 8, "num_classes": 2,
            "sa1": {"npoint": 4, "radii": [0.5], "nsamples": [3],
                    "mlps": [[2, 3, 4]]},
            "sa2": {"npoint": 2, "radii": [1.0], "nsamples": [2],
                    "mlps": [[5, 6, 7]]},
            "sa3_mlp": [3], "fc_widths": [2]}


def pointnet2_entry():
    return {"clouds": 2, "forwards": 3, "plans": 1, "balls": {
        "sa1": {"centres": 7, "db": 15, "centres_db": 50, "slots": [11]},
        "sa2": {"centres": 3, "db": 6, "centres_db": 9, "slots": [5]}}}


def test_k5_least_time_by_hand():
    c, e = small_pointnet2(), pointnet2_entry()
    # SA1: B=2, M=8 rows, S=4, widths 2, 3, 4, no features
    b1 = 4 * (2 * 8 * 3 + 2 * 4 * 3 + 2 * 4 * 4)
    tc1 = 2 * (11 * (3 * 2 + 2 * 3 + 3 * 4) + 3 * 50)
    f1 = 11 * 4 + 50
    # SA2: B=2, M=4 rows (SA1's centres) with features, S=2, widths 5, 6, 7
    b2 = 4 * (2 * 4 * 3 + 2 * 2 * 3 + 2 * 2 * 7 + 2 * 4 * 5)
    tc2 = 2 * (5 * (3 * 5 + 5 * 6 + 6 * 7) + 3 * 9)
    f2 = 5 * 7 + 9
    want = 3 * (max(b1, f1, 3 * tc1) + max(b2, f2, 3 * tc2))
    assert metric("k5_roofline").read(FakeContext(c, [e])) == pytest.approx(100.0 * want)


def test_mfu_attrib_pointnet2_operations_by_hand():
    c, e = small_pointnet2(), pointnet2_entry()
    macs = 3 * 50 + 11 * (3 * 2 + 2 * 3 + 3 * 4)            # SA1
    macs += 3 * 9 + 5 * (3 * 5 + 5 * 6 + 6 * 7) + 6 * 4 * 5  # SA2, 4 features
    macs += 3 * (7 + 3) * 3                                  # SA3 on 3 centres
    macs += 2 * (3 * 2 + 2 * 2)                              # the head
    assert ref_pointnet2.flops(c, e) == 2 * 3 * macs
    ctx = FakeContext(c, [e])
    assert metric("mfu.attrib").read(ctx) == pytest.approx(100.0 * 2 * 3 * macs)
