"""PyTorch port: the data layer against the JAX package's.

``collate_mel``, ``Loader`` (batches and their order per epoch, the padded
tail batch), ``epoch_index_batches`` and ``DeviceStagedLoader`` (staged on
the CPU here) give the JAX package's arrays; ``MaestroDataset``,
``CachedMaestroDataset`` and ``HybridMaestroDataset`` give its items on the
synthetic MAESTRO tree of tests/maestro_fixture.py, bit for bit.
"""

import time

import numpy as np
import pytest
import torch

from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.data import cache as JC
from music_transcription_tpu.data import pipeline as JP
from music_transcription_tpu.data.maestro import MaestroDataset as JMaestroDataset
from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.data import cache as C
from music_transcription_tpu_torch.data import pipeline as P
from music_transcription_tpu_torch.data.maestro import MaestroDataset

from tests.maestro_fixture import make_maestro_root

CFG = dict(n_mels=32, chunk_length=2.0)


@pytest.fixture(scope="module")
def maestro_root(tmp_path_factory):
    return make_maestro_root(tmp_path_factory.mktemp("maestro"))


class _Items:
    """n items of varying length, each marked by its index."""

    def __init__(self, n=11, m=5):
        self.n, self.m = n, m

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        t = 3 + i % 4
        mel = np.full((self.m, t), float(i), np.float32)
        roll = (np.arange(88 * t).reshape(88, t) % (i + 2) == 0).astype(np.float32)
        return mel, roll


def _equal(a, b):
    for x, y in zip(a, b, strict=True):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("pad_to", [None, 8])
def test_collate_mel_matches_jax(pad_to):
    items = [_Items()[i] for i in (0, 5, 2)]
    _equal(P.collate_mel(items, pad_to=pad_to), JP.collate_mel(items, pad_to=pad_to))


@pytest.mark.parametrize("num_workers", [0, 3])
def test_loader_yields_jax_batches_in_jax_order(num_workers):
    ds = _Items()
    ours = P.Loader(ds, 3, shuffle=True, seed=7, num_workers=num_workers, drop_last=True, pad_to=6)
    ref = JP.Loader(ds, 3, shuffle=True, seed=7, num_workers=0, drop_last=True, pad_to=6)
    assert len(ours) == len(ref) == 3
    for _ in range(3):  # a new order every epoch, the same in both
        for a, b in zip(ours, ref, strict=True):
            _equal(a, b)


def test_loader_pads_last_batch_with_zero_length_rows():
    ds = _Items(n=7)
    ours = list(P.Loader(ds, 3, num_workers=0, pad_to=6, pad_last_batch=True))
    ref = list(JP.Loader(ds, 3, num_workers=0, pad_to=6, pad_last_batch=True))
    assert len(ours) == 3 and ours[-1][0].shape[0] == 3
    assert list(ours[-1][2]) == [5, 0, 0]  # item 6 is 5 frames long
    for a, b in zip(ours, ref, strict=True):
        _equal(a, b)


def test_epoch_index_batches_match_jax():
    for epoch in range(3):
        kw = dict(shuffle=True, seed=3, epoch=epoch, drop_last=False)
        _equal(list(P.epoch_index_batches(10, 4, **kw)), list(JP.epoch_index_batches(10, 4, **kw)))


@pytest.mark.parametrize("compact", [False, True])
def test_device_staged_loader_matches_loader(compact):
    ds = _Items(n=10)
    kw = dict(bf16_fields=(0,), u8_fields=(1,)) if compact else {}
    staged = P.DeviceStagedLoader(ds, 4, device="cpu", shuffle=True, seed=1, pad_to=6,
                                  drop_last=True, num_workers=0, **kw)
    stream = P.Loader(ds, 4, shuffle=True, seed=1, pad_to=6, drop_last=True, num_workers=0)
    for _ in range(2):
        for a, b in zip(staged, stream, strict=True):
            assert a[0].dtype == torch.float32 and a[1].dtype == torch.float32
            _equal(a, b)  # the marks are small integers: exact in bf16
    val = P.DeviceStagedLoader(ds, 4, device="cpu", pad_to=6, pad_last_batch=True,
                               num_workers=0, **kw)
    last = list(val)[-1]
    assert last[2].tolist() == [3, 4, 0, 0]  # items 8, 9, then rows of length 0
    with pytest.raises(ValueError, match="binary"):
        P.DeviceStagedLoader(_Items(n=3), 1, device="cpu", u8_fields=(0,), num_workers=0)  # mel 2.0


def test_maestro_dataset_items_equal_jax(maestro_root):
    for split in ("train", "validation"):
        ours = MaestroDataset(maestro_root, split=split, chunk_length=2.0,
                              audio_cfg=AudioConfig(**CFG))
        ref = JMaestroDataset(maestro_root, split=split, chunk_length=2.0,
                              audio_cfg=JAudioConfig(**CFG))
        assert len(ours) == len(ref) > 0
        assert ours.chunks == ref.chunks
        for i in range(len(ref)):
            _equal(ours[i], ref[i])
    whole = MaestroDataset(maestro_root, split="train", audio_cfg=AudioConfig(**CFG))
    _equal(whole[1], JMaestroDataset(maestro_root, split="train",
                                     audio_cfg=JAudioConfig(**CFG))[1])


def test_cached_datasets_read_a_jax_written_cache(maestro_root, tmp_path):
    ref = JMaestroDataset(maestro_root, split="train", chunk_length=2.0,
                          audio_cfg=JAudioConfig(**CFG))
    cache = tmp_path / "cache"
    for i in range(len(ref)):
        mel, roll = ref[i]
        JC.save_chunk(cache / "train", i, {"mel": mel, "roll": roll.astype(np.uint8)})
    JC.save_metadata(cache, "train", {"num_chunks": len(ref), "chunk_length": 2.0,
                                      "overlap": 0.0, "n_mels": 32, "chunks": ref.chunks})
    ours = C.CachedMaestroDataset(cache, "train", verbose=False)
    theirs = JC.CachedMaestroDataset(cache, "train", verbose=False)
    hybrid = C.HybridMaestroDataset(maestro_root, cache, "train", chunk_length=2.0,
                                    verbose=False)
    assert hybrid.use_cache and len(ours) == len(theirs) == len(ref)
    for i in range(len(ref)):
        _equal(ours[i], theirs[i])
        _equal(hybrid[i], ref[i])
    # another chunk length: the raw dataset, the same items as JAX's
    raw = C.HybridMaestroDataset(maestro_root, cache, "train", chunk_length=3.0, verbose=False,
                                 audio_cfg=AudioConfig(**CFG))
    assert not raw.use_cache
    _equal(raw[0], JMaestroDataset(maestro_root, split="train", chunk_length=3.0,
                                   audio_cfg=JAudioConfig(**CFG))[0])


class _SlowItems:
    """12 items that take 0.3 s each to decode."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        time.sleep(0.3)
        return np.full((2, 3), i, np.float32), np.zeros((88, 3), np.float32)


def test_an_abandoned_iteration_does_not_wait_for_its_look_ahead():
    """A Loader iteration left early (validation's break after --val_batches)
    shuts its pool down without waiting for the items it decodes ahead: a
    SIGTERM that landed in that wait, inside the generator's finalizer, was
    dropped and the run went on."""
    loader = P.Loader(_SlowItems(), 2, num_workers=2)
    it = iter(loader)
    assert next(it)[0].reshape(2, -1)[:, 0].tolist() == [0.0, 1.0]
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 0.25  # 4 look-ahead items queued, 0.3 s each
    # a whole epoch still yields every batch, in order
    assert [b[0].reshape(2, -1)[:, 0].tolist() for b in loader] == [
        [float(2 * k), float(2 * k + 1)] for k in range(6)]
