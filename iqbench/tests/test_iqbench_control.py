"""On the card: each cell's control (the reference one precision below
the configurations' in the program's place: TF32 products for float32
with TF32 off, bfloat16 reward and marginals for the engine's float32)
fails the cell's check on three seeds, at the cell's own sizes with a
run's window; and the program passes it on the same seeds.
``python -m pytest iqbench/tests -m cuda`` on a machine with the card."""
import time

import pytest

from iqbench import harness

CELLS = ["dgcnn.enum_trans", "pointnet2.enum_trans", "dgcnn.interaction"]


def readings(cell_name, seed, card):
    cell = harness.Cell(cell_name)
    harness.prepare_environment(cell.cfg)
    harness.set_port_precision(cell.cfg)
    ctx = harness.Context(cell, seed, card)
    driver = ctx.driver = cell.driver_class()(ctx)
    driver.warmup()
    deadline = time.perf_counter() + cell.bench["run_seconds"]
    driver.step()
    while time.perf_counter() < deadline:
        driver.step()
    driver.finish()
    driver.release()
    program = harness.readings(driver, lambda s: s["program"], cell.limits)
    control = harness.readings(driver, lambda s: driver.reference(s, True),
                               cell.limits)
    return cell.limits, program, control


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, seed, card):
    limits, program, control = readings(cell, seed, card)
    assert all(program[n] <= limits[n] for n in limits), program
    assert any(control[n] > limits[n] for n in limits), control
