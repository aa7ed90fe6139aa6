"""A run whose timed path is broken underneath reads ``correct`` false:
the harness's look for a card skipped (the CPU, at small sizes), the rest
of the run as it is, one fault of ``iqbench/faults.py`` at a time:

  * an answer altered where it is produced (every cell);
  * the tail quarter of each forward's clouds wrong (a minority of clouds,
    which a median cannot see);
  * one cloud of each forward NaN (a reading that is not finite);
  * two regions' marginals swapped in the Shapley engine (the enumeration).

(The cells take one chip, so no exchange between chips can be left out;
no cell trains, so no step can leave its state unchanged or drop half its
batch.)"""
import time

import pytest

from iqbench import faults, harness

SMALL = {
    "dgcnn.enum_trans": {"config": {"num_points": 128},
                         "traffic": {"orders_per_pose": 2, "poses_per_call": 2,
                                     "check_poses": 2}},
    "pointnet2.enum_trans": {"config": {"num_points": 128},
                             "traffic": {"orders_per_pose": 1, "poses_per_call": 1,
                                         "check_poses": 1}},
    "dgcnn.interaction": {"config": {"num_points": 128},
                          "traffic": {"pairs_per_call": 2, "max_contexts": 3,
                                      "check_cells": 12}},
}
CELL_FAULTS = {
    "dgcnn.enum_trans": ["answer_altered", "tail_quarter", "one_nan",
                         "regions_swapped"],
    "pointnet2.enum_trans": ["answer_altered", "tail_quarter", "one_nan",
                             "regions_swapped"],
    "dgcnn.interaction": ["answer_altered", "tail_quarter", "one_nan"],
}


def run(cell, seed=11):
    return harness.run_cell(cell, seed, 0.3, False, time.monotonic(),
                            device="cpu", overrides=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    got = run(cell)
    assert got["correct"], got["check"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELL_FAULTS)
                                        for f in CELL_FAULTS[c]])
def test_fault_is_not_correct(cell, fault):
    with faults.plant(fault):
        got = run(cell)
    assert not got["correct"], got["check"]
    if fault == "one_nan":
        assert any(v["value"] is None for v in got["check"].values())
