"""``correct`` on a run at a small size, the look for a card skipped:
true as the program stands, false with each fault that the cell can
have planted under the timed path, and false for the control (the
reference in the precision below the configuration's) in the program's
place."""
from __future__ import annotations

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests import tiny


def correct(outcome) -> bool:
    return all(c.ok for c in outcome.checks) and bool(outcome.checks)


@pytest.mark.parametrize("cell", ["fp32_rollout_b5", "fp32_train_n8"])
def test_sound_run_is_correct(cell, tmp_path):
    out = tiny.run(cell, tmp_path)
    assert correct(out), out.checks
    assert out.attempted > 0 and out.failed == 0
    assert all(v > 0 for v in out.metrics.values())


@pytest.mark.parametrize("fault", sorted(faults.ROLLOUT))
def test_rollout_fault_is_caught(fault, tmp_path):
    with faults.ROLLOUT[fault]():
        out = tiny.run("fp32_rollout_b5", tmp_path)
    assert not correct(out), out.checks


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_fault_is_caught(fault, tmp_path):
    with faults.TRAIN[fault]():
        out = tiny.run("fp32_train_n8", tmp_path)
    assert not correct(out), out.checks


def limits_failed(cell: str, gaps: dict) -> list[str]:
    limits = harness.load_json("workloads", cell)["limits"]
    return [k for k, v in gaps.items() if v > limits[k]]


def test_fp8_control_fails_the_bf16_cell(tmp_path):
    c = tiny.ctx("bf16_rollout_b5", tmp_path)
    driver = harness.import_file("drivers", "rollout")
    out = driver.run(c, keep=True)
    assert limits_failed("bf16_rollout_b5",
                         driver.control_gaps(c, out.kept, "fp8"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["fp32_rollout_b5", "fp32_train_n8"])
def test_tf32_control_fails_the_fp32_cells(cell, card, tmp_path):
    c = tiny.ctx(cell, tmp_path)
    c.device = card
    driver = harness.import_file("drivers", c.workload["driver"])
    out = driver.run(c, keep=True)
    assert all(ch.ok for ch in out.checks), out.checks
    assert limits_failed(cell, driver.control_gaps(c, out.kept, "tf32"))
