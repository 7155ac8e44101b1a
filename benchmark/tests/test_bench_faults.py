"""Each fault planted under the timed path turns ``correct`` false; the
same run without it is correct."""

import contextlib

import pytest

import faults
import harness


def _run(tiny, cell, fault=None, seconds=0.1):
    root, here = tiny
    c = harness.Cell(root, cell, here=here)
    if fault is None:
        return harness.run(root, cell, 21, seconds, False, device="cpu",
                           cell=c)
    with faults.FAULTS[fault]():
        return harness.run(root, cell, 21, seconds, False, device="cpu",
                           cell=c)


@pytest.mark.parametrize("cell", ["tiny.pair", "tiny.batch"])
@pytest.mark.parametrize("fault", [None, "state_unchanged",
                                   "half_the_samples", "answer_altered"])
def test_a_fault_turns_correct_false(tiny, cell, fault):
    line = _run(tiny, cell, fault)
    assert line["correct"] is (fault is None), line["checks"]


def test_half_of_a_batch_call_left_out_turns_correct_false(tiny):
    line = _run(tiny, "tiny.batch", "half_the_pairs")
    assert line["correct"] is False
    # the pairs left out come back unimproved: failed, never claimed
    assert line["checks"]["failed_share"]["value"] >= 0.5
    assert line["checks"]["wrong_poses_claimed"]["value"] == 0


def test_the_control_turns_correct_false(tiny):
    root, here = tiny
    cell = harness.Cell(root, "tiny.pair", here=here)
    line = harness.run(root, "tiny.pair", 31, 0.1, False, device="cpu",
                       cell=cell, control=True)
    assert line["correct"] is False
    assert line["checks"]["lcp_gap"]["value"] > \
        line["checks"]["lcp_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "control", "half_the_samples"])
def test_on_the_card_the_check_catches_the_control(tiny, fault):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root, here = tiny
    cell = harness.Cell(root, "tiny.pair", here=here)
    ctx = (faults.FAULTS[fault]() if fault not in (None, "control")
           else contextlib.nullcontext())
    with ctx:
        line = harness.run(root, "tiny.pair", 41, 0.1, False,
                           device="cuda", cell=cell,
                           control=fault == "control")
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is (fault is None), line["checks"]
