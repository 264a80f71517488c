"""The check fails what it must.  The control (the reference in fp8 put in
the program's place) makes a tiny cell's run not correct; and each run
below skips
the look for a card and drives the rest of a run with the timed path
broken underneath, and ``correct`` comes out false: a served token
altered where it is produced, half of the slots left out, a step that
leaves its state unchanged, half of a training batch left out, and a
token altered in the feed.  (No cell spans chips, so no exchange between
chips can be left out.)"""

from __future__ import annotations

import pytest

from perfbench import faults

from .conftest import SERVE_CELLS, TRAIN_CELLS, execute


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_the_control_fails_a_serving_cell(tiny_root, cell):
    out = execute(tiny_root, cell, control=True)
    check = out["checks"]["off_share_worst_request"]
    assert out["correct"] is False
    assert out["failed"] > 0
    assert check["value"] > check["limit"]
    assert check["value"] > \
        3 * out["_detail"]["program_off_share_worst_request"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_the_control_fails_a_training_cell(tiny_root, cell):
    out = execute(tiny_root, cell, control=True)
    ctrl = out["_detail"]["control"]
    assert out["correct"] is False
    assert any(out["checks"][k]["value"] > out["checks"][k]["limit"]
               for k in ctrl)
    assert {k: out["checks"][k]["value"] for k in ctrl} == ctrl


@pytest.mark.parametrize("kind", ["served_altered", "served_half",
                                  "served_stale"])
@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_a_broken_serving_step_is_not_correct(tiny_root, cell, kind):
    with faults.plant(kind):
        out = execute(tiny_root, cell)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("kind", ["train_unchanged", "train_half"])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_broken_train_step_is_not_correct(tiny_root, cell, kind):
    with faults.plant(kind):
        out = execute(tiny_root, cell)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_token_altered_in_the_feed_is_not_correct(tiny_root, cell):
    with faults.plant("feed_altered"):
        out = execute(tiny_root, cell)
    assert out["correct"] is False
    assert out["checks"]["rows_not_delivered_as_stored"]["value"] > 0


def test_an_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        with faults.plant("nothing"):
            pass
