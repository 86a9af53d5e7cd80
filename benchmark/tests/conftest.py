"""Shared pieces of the benchmark's own tests: cells cut to a size the CPU
runs in seconds (every width of the model scaled down, a short cache)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = dict(n_mels=32, hidden_size=16, num_layers=2, num_attention_heads=2)
# the training rehearsals compute in float32: on the CPU, PyTorch's bfloat16
# convolution backward now and then gives NaN gradients (the step is skipped)
TINY_TRAIN_MODEL = dict(compute_dtype="float32")
TINY_TRAIN = dict(batch=4, cache_chunks=10, validation_chunks=3, chunk_length=4.0,
                  traced_min_s=0.05, traced_min_steps=2)


def tiny_cell(workload: str, root: str = ROOT):
    from benchmark.common import registry

    cell = registry.cell(registry.load_benchmark(root), workload, root)
    cell.config["model"].update(TINY_MODEL, **TINY_TRAIN_MODEL)
    cell.traffic.update(TINY_TRAIN)
    return cell


@pytest.fixture
def cpu():
    import torch

    torch.manual_seed(0)
    return torch.device("cpu")
