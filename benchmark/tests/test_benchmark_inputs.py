"""The same seed gives the same cache, batches and weights; the cache's
rolls hold the notes it draws."""

import numpy as np
import pytest
import torch

from benchmark.common import inputs, seeds
from benchmark.reference import training as ref_train

BIG = [2**31 + 5, 2**40 + 3, 7]


@pytest.mark.parametrize("seed", BIG)
def test_batches_and_weights_repeat(seed, cpu):
    mel, roll = inputs.train_cache(8, 16, 12, seeds.part(seed, "data"), cpu, block=3)
    mel2, roll2 = inputs.train_cache(8, 16, 12, seeds.part(seed, "data"), cpu, block=3)
    assert np.array_equal(mel, mel2) and np.array_equal(roll, roll2)
    assert mel.dtype == np.float16 and roll.dtype == np.uint8
    a = ref_train.staged_batches(mel, roll, 3, seeds.part(seed, "loader") % 2**32, 4, True, cpu)
    b = ref_train.staged_batches(mel, roll, 3, seeds.part(seed, "loader") % 2**32, 4, True, cpu)
    for x, y in zip(a, b):
        assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert len({tuple(x[0][:, 0, 0, 0].tolist()) for x in a[:2]}) == 2  # rows differ
    module = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 3), torch.nn.BatchNorm2d(4))
    w1, w2 = (inputs.seeded_weights(module, seed, cpu) for _ in range(2))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert (w1["1.running_var"] > 0).all()


def test_rolls_hold_sustained_notes(cpu):
    """Every chunk has notes, each on for at least 10 frames or up to the
    chunk's end, and a key is never on for longer than the notes allow."""
    frames = 200
    _, roll = inputs.train_cache(6, 8, frames, 5, cpu, block=4)
    assert set(np.unique(roll)) <= {0, 1}
    for chunk in roll:
        assert 0 < chunk.sum() <= 119 * 119
        padded = np.pad(chunk.astype(np.int8), ((0, 0), (1, 1)))
        starts = np.argwhere(np.diff(padded, axis=1) == 1)
        ends = np.argwhere(np.diff(padded, axis=1) == -1)
        runs = ends[:, 1] - starts[:, 1]
        assert ((runs >= 10) | (ends[:, 1] == frames)).all()
