"""The control: the plain reference in bfloat16 put in the program's place
has to come out not correct, here at a tiny size and on the card at a
cell's own size; the same reference in float64 against itself reads
within every limit."""

import tempfile

import pytest
import torch

from benchmark.compare import passes
from benchmark.control import control_numbers
from benchmark.reference import hmmbuild
from benchmark.run import Cell, cell_of, load_spec

from .test_benchmark_dryrun import ROOT, tiny_spec


def _numbers(root, wl, cfg, seed, device, dtype):
    with tempfile.TemporaryDirectory() as tmp:
        cell = Cell(root, wl, cfg, seed, device, tmp)
        with open(cell.tree) as f:
            models = hmmbuild.ensemble(cell.bb_names, cell.bb_codes,
                                       f.read(), 10)
        return control_numbers(cell, seed, models, device, dtype)


@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False),
                                           (torch.float64, True)])
def test_control_on_a_tiny_cell(tmp_path, dtype, correct):
    spec, wl = tiny_spec(str(tmp_path), "d8")
    checks = _numbers(str(tmp_path), wl, spec["configs"][0], 31337, "cpu",
                      dtype)
    assert passes(checks) is correct, checks
    # the control fails on what it computes, not on too few samples
    assert checks["decided_short"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dna1k.d1000"])
def test_control_at_the_cell_size_on_the_card(card, workload):
    wl, cfg = cell_of(load_spec(ROOT), workload)
    checks = _numbers(ROOT, wl, cfg, 2 ** 31 + 99, card, torch.bfloat16)
    assert not passes(checks), checks
    assert checks["decided_short"]["value"] == 0
