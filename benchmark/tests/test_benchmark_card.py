"""On the card: a cell's control, the reference computed one precision below
the configuration's in the program's place, fails a limit at the cell's own
size. Run there with ``python -m pytest -m gpu benchmark/tests``."""

import json

import pytest

from conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["large-train-b24", "cnn_rnn-train-b24"])
def test_the_control_fails_a_limit_at_the_cells_size(workload, card):
    from benchmark.common import registry

    cell = registry.cell(registry.load_benchmark(ROOT), workload, ROOT)
    got = cell.generator().control(cell, seed=2**31 + 101, device=card, precision="float8")
    limits = json.load(open(f"{ROOT}/benchmark/limits/{workload}.json"))
    assert any(got[k] > limits[k] for k in limits), (got, limits)
