"""PyTorch port: ``SlabRotatingLoader`` (and the staging it builds on)
against the JAX package's, staged on the CPU here.

At the same seed both size the same slabs (``n_slabs``, ``items_per_slab``,
``len``) from one collated probe item and yield the same items in the same
order, over 2 epochs, with 1 and 2 passes a slab; compact int16 fields
widen bit for bit as ``load_chunk`` does; every batch has one shape; no
staged tensor outlives an epoch or an early break, and the prefetch thread
is joined."""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from music_transcription_tpu.data import pipeline as JP
from music_transcription_tpu_torch.data import cache as C
from music_transcription_tpu_torch.data import pipeline as P


class _IdDS:
    """n items, each marked by its index at mel[0, 0]; T=5, padded to 6."""

    def __init__(self, n=23, t=5):
        self.n, self.t = n, t

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        mel = rng.standard_normal((4, self.t)).astype(np.float32)
        mel[0, 0] = i
        roll = (rng.random((88, self.t)) > 0.7).astype(np.float32)
        return mel, roll


class _PcmDS(_IdDS):
    """Mel values on the PCM16 grid, and off it (quantization rounds those)."""

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        mel = rng.integers(-32768, 32768, (4, self.t)).astype(np.float32) / 32768.0
        mel[1] = rng.uniform(-1.0, 1.0, self.t)
        mel[0, 0] = i / 32768.0
        return mel, np.zeros((88, self.t), np.float32)


def _ids(batch, compact=False):
    col = np.asarray(batch[0])[:, 0, 0, 0]
    return [int(round(v * 32768)) if compact else int(v) for v in col]


def _loaders(ds, slab_items, **kw):
    item_bytes = sum(a.nbytes for a in P.collate_mel([ds[0]], pad_to=6))
    kw = dict(pad_to=6, num_workers=0, slab_bytes=item_bytes * slab_items, **kw)
    return (P.SlabRotatingLoader(ds, 2, device="cpu", **kw),
            JP.SlabRotatingLoader(ds, 2, collate=JP.collate_mel, **kw))


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("n,slab_items,seed", [(23, 7, 3), (16, 4, 0), (9, 100, 5)])
def test_same_slabs_and_item_order_as_jax(n, slab_items, seed, passes):
    ours, ref = _loaders(_IdDS(n), slab_items, seed=seed, passes_per_slab=passes)
    assert (ours.n_slabs, ours.items_per_slab, len(ours)) == (
        ref.n_slabs, ref.items_per_slab, len(ref))
    for _ in range(2):  # a new permutation each epoch, the same in both
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want, strict=True):
            for x, y in zip(a, b, strict=True):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert ours.epoch == ref.epoch == 2


def test_plan_is_the_order_the_loader_yields():
    ours, _ = _loaders(_IdDS(23), 7, seed=3, passes_per_slab=2)
    want = [int(slab[o]) for slab, orders in ours.plan(0) for order in orders
            for b in range(ours.items_per_slab // 2) for o in order[2 * b:2 * b + 2]]
    assert [i for batch in ours for i in _ids(batch)] == want
    items = [i for slab, _ in ours.plan(1) for i in slab]
    assert len(items) == len(set(items)) == ours.n_slabs * ours.items_per_slab


@pytest.mark.parametrize("fields", [dict(compact_fields=(0,)),
                                    dict(bf16_fields=(0,), u8_fields=(1,))],
                         ids=["int16", "bf16_u8"])
def test_compact_fields_widen_as_jax_and_load_chunk(fields):
    ds = _PcmDS(12)
    ours, ref = _loaders(ds, 6, seed=0, passes_per_slab=2, **fields)
    got, want = list(ours), list(ref)
    for a, b in zip(got, want, strict=True):
        assert a[0].dtype == a[1].dtype == torch.float32
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    if "compact_fields" in fields:  # the widened batch is load_chunk's decode of the int16
        for batch in got:
            for row, i in zip(batch[0].numpy(), _ids(batch, compact=True)):
                mel = ds[i][0]
                decoded = C.quantize_i16(mel).astype(np.float32) / C.PCM16_SCALE
                np.testing.assert_array_equal(row[0, :, :5], decoded)
                np.testing.assert_array_equal(row[0, 0, :5], mel[0])  # on the grid: exact


def test_one_batch_shape():
    ours, _ = _loaders(_IdDS(23), 7, seed=1)
    shapes = {tuple(tuple(a.shape) for a in batch) for batch in ours}
    assert shapes == {((2, 1, 4, 6), (2, 88, 6), (2,))}


def _recording(loader):
    staged = []
    real = loader._stage

    def stage(idx):
        arrays, ready = real(idx)
        staged.extend(weakref.ref(a) for a in arrays)
        return arrays, ready

    loader._stage = stage
    return staged


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name.startswith("slab-prefetch")]


@pytest.mark.parametrize("stop_after", [None, 1, 4], ids=["epoch", "first_batch", "mid_epoch"])
def test_no_staged_tensor_outlives_an_epoch_or_a_break(stop_after):
    ours, _ = _loaders(_IdDS(16), 4, seed=0)
    assert ours.n_slabs == 4
    staged = _recording(ours)
    it = iter(ours)
    batches = [next(it) for _ in range(stop_after)] if stop_after else list(it)
    it.close()
    del it, batches
    assert staged and all(r() is None for r in staged)
    if stop_after is None:
        assert len(staged) == 3 * ours.n_slabs
    assert _prefetch_threads() == []
    gc.collect()
    assert all(r() is None for r in staged)


@pytest.mark.parametrize("n,slab_items,want", [(5, 2, (2, 2, 2)), (3, 2, (1, 2, 1)),
                                               (1, 2, (0, 2, 0))])
def test_a_budget_under_two_batches_drops_short_slabs(n, slab_items, want):
    """Slabs of whole batches that the items cannot fill are dropped (the
    JAX package's loader would gather clamped duplicates in them): every
    batch holds distinct items of the dataset."""
    ours, _ = _loaders(_IdDS(n), slab_items, seed=2)
    assert (ours.n_slabs, ours.items_per_slab, len(ours)) == want
    for _ in range(2):
        ids = [i for batch in ours for i in _ids(batch)]
        assert len(ids) == len(set(ids)) == ours.n_slabs * ours.items_per_slab
        assert set(ids) <= set(range(n))
    assert _prefetch_threads() == []
