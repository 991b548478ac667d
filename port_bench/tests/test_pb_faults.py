"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have; the controls (the reference in a
lower precision in the program's place) come out not correct; a sound
run comes out correct.  The runs skip the look for a card and drive the
rest of ``run.py`` on the CPU at tiny widths."""

import argparse
import json

import pytest

from port_bench import control, run
from port_bench.lib import common, faults, offline, train
from port_bench.tests.conftest import TINY_SEED

OFFLINE = ["las_blstm_f32.offline_aishell_b128",
           "las_blstm_bf16.offline_aishell_b128"]
TRAIN = "las_blstm_f32.train_aishell_b256"


def _run(cell, seconds=0.5):
    args = argparse.Namespace(workload=cell, seed=TINY_SEED,
                              seconds=seconds, trace=0)
    return run.run_cell(args, device="cpu")


@pytest.mark.parametrize("cell", OFFLINE + [TRAIN])
def test_a_sound_run_is_correct(tiny, cell):
    result, checks = _run(cell)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]


# the selection faults are judged in the float32 cell, which alone
# compares its hypotheses with the reference's beam
@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in OFFLINE for f in ("token_altered", "answer_altered")]
    + [(OFFLINE[0], f) for f in ("topk_shifted", "second_beam")])
def test_an_altered_answer_or_selection_is_not_correct(tiny, cell, fault):
    with faults.FAULTS[fault]():
        result, checks = _run(cell)
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(tiny, fault):
    with faults.FAULTS[fault]():
        result, checks = _run(TRAIN)
    assert not result["correct"], checks
    if fault == "state_unchanged":
        assert checks["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", OFFLINE + [TRAIN])
def test_the_control_is_not_correct(tiny, cell):
    """fp8 on the CPU (TF32, the float32 configuration's control, needs
    the card: ``test_pb_cuda.py``)."""
    c = common.load("workloads", cell)
    cfg = common.load("configs", c["config"])
    mix = common.load("traffic", c["traffic"])
    driver = offline if mix["kind"] == "offline" else train
    got = driver.control(c, cfg, mix, TINY_SEED, "fp8", "cpu")
    ok, checks = common.judge(got, c["check"]["limits"])
    assert not ok, checks


@pytest.mark.parametrize("cell,how", [
    (OFFLINE[0], ["--program"]), (OFFLINE[0], ["--fault", "topk_shifted"]),
    (OFFLINE[1], ["--precision", "fp8"]), (TRAIN, ["--program"]),
    (TRAIN, ["--fault", "half_batch"])])
def test_the_control_script_judges_by_the_cells_limits(tiny, capsys, cell,
                                                        how):
    """``control.py`` exits 0 where the program comes out correct and a
    control or a fault comes out not correct, and prints each verdict."""
    rc = control.main(["--workload", cell, "--seeds", str(TINY_SEED),
                       "--device", "cpu"] + how)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, line
    assert line["correct"] == (how == ["--program"])
    assert set(line["checks"]) == set(
        common.load("workloads", cell)["check"]["limits"])


def test_judge_compares_the_numbers_the_cell_limits():
    limits = {"a": 1.0, "b": 0}
    assert common.judge({"a": 0.5, "b": 0.0, "c": 9.0}, limits) == (
        True, {"a": {"value": 0.5, "limit": 1.0},
               "b": {"value": 0.0, "limit": 0}})
    assert not common.judge({"a": 1.5, "b": 0.0}, limits)[0]
    assert not common.judge({"a": float("nan"), "b": 0.0}, limits)[0]
    ok, checks = common.judge({"a": 0.5}, limits)
    assert not ok and checks["b"]["value"] is None
