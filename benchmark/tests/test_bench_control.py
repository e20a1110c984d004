"""The control on the card: the reference in TF32, put in the program's
place at a cell's own size, fails the cell's limits, where the program
passes them (one seed; benchmark/control.py reads a dozen)."""

from __future__ import annotations

import tempfile

import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hand.fit_stage2", "arm.fit_stage2"])
def test_the_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.control import fit_readings
    from benchmark.inputs import make_inputs
    from benchmark.jobs import KINDS
    from benchmark.run import find_cell

    torch.backends.cuda.matmul.allow_tf32 = False
    _, spec, traffic, _, _ = find_cell(cell)
    kind = KINDS[traffic["kind"]](make_inputs(spec, 2**31 + 99, torch.device("cuda"), traffic),
                                  traffic)
    with tempfile.TemporaryDirectory() as d:
        rec = fit_readings(kind, True, False, d)
    limits = traffic["limits"]
    assert all(rec["program"][k]["value"] <= lim for k, lim in limits.items()), rec["program"]
    assert any(rec["control"][k]["value"] > lim for k, lim in limits.items()), rec["control"]
