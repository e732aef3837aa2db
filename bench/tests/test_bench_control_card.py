"""The control at a cell's own size on the card: the reference computed
in TF32 in the program's place, through the cell's own loop and
comparison, reads ``correct`` false, and the program reads it true.
Skips without a card."""
import pytest

from bench import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's "
                    "own size")
    from bench import program
    program.prepare("cuda:0")
    return "cuda:0"


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_benchmark()["workloads"]])
def test_the_tf32_control_fails_and_the_program_passes(card, workload):
    from bench.control import reading
    cell = spec.cell(spec.load_benchmark(), workload)
    program = reading(cell, 4000000001, "program", card)
    control = reading(cell, 4000000001, "control", card)
    assert program["correct"] is True, program
    assert control["correct"] is False, control
    limit = control["checks"]["wrong_rows"]["limit"]
    assert control["checks"]["wrong_rows"]["value"] > limit, control
