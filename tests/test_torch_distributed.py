"""PyTorch port: the processes of a data-parallel run
(``parallel/distributed.py``), its data axis (``parallel/mesh.py``) and
``data/pipeline.device_prefetch``, in one process on the CPU.

``ProcessShard`` and ``local_batch_size`` case for case as
tests/test_multihost.py; the backend each placement of ranks gets; the
environment's checks; ``make_mesh``'s and ``shard_batch``'s errors.
"""

import threading
import time

import numpy as np
import pytest
import torch

from music_transcription_tpu_torch.data import pipeline
from music_transcription_tpu_torch.parallel import distributed as D
from music_transcription_tpu_torch.parallel import mesh as M


class _Rng:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return i


def test_process_shard_round_robin_equal_lengths():
    shards = [D.ProcessShard(_Rng(), process_index=p, process_count=3) for p in range(3)]
    # ceil(10/3) = 4 on EVERY shard (wraparound keeps collective counts equal)
    assert all(len(s) == 4 for s in shards)
    seen = [s[i] for s in shards for i in range(4)]
    assert set(seen) == set(range(10))  # covers everything (some repeats)
    assert shards[1][2] == 2 * 3 + 1


def test_process_shard_exact_partitions_without_duplicates():
    shards = [D.ProcessShard(_Rng(), process_index=p, process_count=3, exact=True)
              for p in range(3)]
    assert [len(s) for s in shards] == [4, 3, 3]
    seen = sorted(s[i] for s in shards for i in range(len(s)))
    assert seen == list(range(10))  # exact cover, no duplicates
    with pytest.raises(IndexError):
        shards[1][3]


def test_process_shard_reads_rank_and_world_outside_a_group():
    shard = D.ProcessShard(_Rng())
    assert (shard.p, shard.n, len(shard)) == (0, 1, 10)


def test_local_batch_size(monkeypatch):
    assert D.local_batch_size(8) == 8  # one process: the identity
    monkeypatch.setattr(D, "rank_and_world", lambda: (1, 3))
    assert D.local_batch_size(9) == 3
    with pytest.raises(ValueError, match="divisible by the world size 3"):
        D.local_batch_size(8)


@pytest.mark.parametrize("device_type, local_ranks, cards, want", [
    ("cuda", 1, 1, "nccl"),   # a card a rank
    ("cuda", 2, 2, "nccl"),
    ("cuda", 2, 8, "nccl"),
    ("cuda", 2, 1, "gloo"),   # two ranks share the card
    ("cuda", 4, 2, "gloo"),
    ("cpu", 2, 0, "gloo"),    # ranks on the CPU
    ("cpu", 1, 8, "gloo"),
])
def test_backend_follows_where_the_ranks_run(device_type, local_ranks, cards, want):
    assert D.choose_backend(device_type, local_ranks, cards) == want


def test_initialize_is_a_no_op_at_world_1_and_needs_a_rank(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert D.maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="RANK is not"):
        D.maybe_initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()
    assert D.backend() is None and D.rank_and_world() == (0, 1)
    D.shutdown()  # outside a group: nothing to do


def test_rank_device(monkeypatch):
    assert D.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.rank_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")  # two ranks on one card share it
    assert D.rank_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert D.rank_device("cuda") == torch.device("cuda", 1)


def test_make_mesh_refuses_more_ranks_than_the_run_has():
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        M.make_mesh(2, "cpu")


class _Mesh:
    """DeviceMesh's coordinates of a rank: ``_Mesh(r, n)`` is rank r of a
    1-D ``data`` mesh of n, ``_Mesh(r, n, n_model)`` of an (n, n_model)
    ``(data, model)`` mesh."""

    def __init__(self, rank, n, n_model=None):
        self.shape = (n,) if n_model is None else (n, n_model)
        self.mesh_dim_names = ("data",) if n_model is None else ("data", "model")
        self.coords = (rank,) if n_model is None else divmod(rank, n_model)

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]

    def get_local_rank(self, dim=None):
        return self.coords[0 if dim is None else self.mesh_dim_names.index(dim)]


def test_shard_batch_takes_contiguous_rows_in_rank_order():
    batch = (np.arange(8).reshape(8, 1), torch.arange(8))
    parts = [M.shard_batch(batch, _Mesh(r, 4)) for r in range(4)]
    assert [p[0][:, 0].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [p[1].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="does not divide the data axis"):
        M.shard_batch((np.zeros((6, 2)),), _Mesh(0, 4))
    # a (2, 2) mesh: by data index, the model peers (ranks 0, 1 and 2, 3) alike
    parts = [M.shard_batch(batch, _Mesh(r, 2, 2)) for r in range(4)]
    assert [p[1].tolist() for p in parts] == [[0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7],
                                              [4, 5, 6, 7]]
    assert M.pad_to_multiple is pipeline.pad_to_multiple  # one copy, re-exported


def _batches(sizes):
    for n in sizes:
        yield (np.full((n, 3), float(n), np.float32), np.full((n,), n, np.int32))


def test_device_prefetch_moves_batches_in_order():
    got = list(pipeline.device_prefetch(_batches([4, 4, 2]), "cpu"))
    assert [tuple(a.shape[0] for a in b) for b in got] == [(4, 4), (4, 4), (2, 2)]
    assert all(isinstance(a, torch.Tensor) for b in got for a in b)
    assert float(got[2][0][0, 0]) == 2.0


def test_device_prefetch_pads_an_evaluation_tail_on_one_process():
    *_, tail = pipeline.device_prefetch(_batches([4, 4, 3]), "cpu", pad_to_mesh=True)
    assert tail[0].shape == (4, 3) and tail[1].tolist() == [3, 3, 3, 0]
    assert not tail[0][3].any()
    # under world > 1 each rank's Loader aligns its tail: nothing to pad
    *_, tail = pipeline.device_prefetch(_batches([4, 3]), "cpu", pad_to_mesh=True, world=2)
    assert tail[0].shape == (3, 3)


def test_device_prefetch_raises_the_producer_error():
    def broken():
        yield from _batches([2])
        raise OSError("bad chunk")

    it = pipeline.device_prefetch(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="bad chunk"):
        next(it)


def test_device_prefetch_releases_an_abandoned_producer():
    produced = []

    def endless():
        while True:
            produced.append(1)
            yield from _batches([2])

    it = pipeline.device_prefetch(endless(), "cpu", depth=2)
    next(it)
    it.close()  # the consumer breaks off
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            t.name == "device-prefetch" and t.is_alive() for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "device-prefetch" and t.is_alive() for t in threading.enumerate())
    assert len(produced) <= 5  # it stopped instead of running on
