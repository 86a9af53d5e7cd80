"""Host input pipeline and device-staged feeding, a port of the JAX
package's ``data/pipeline.py``.

  * ``collate_mel``: pad mel / roll to the batch's longest T (or ``pad_to``)
    and return (mel (B, 1, M, T), roll (B, 88, T), lengths (B,)) as numpy
  * ``Loader``: epoch iteration with a thread pool decoding items ahead;
    its shuffle is ``np.random.default_rng(seed + epoch)``, so it yields the
    JAX package's batches in the JAX package's order
  * ``DeviceStagedLoader``: the whole dataset staged on the card once
    (mel as bf16 and the binary roll as uint8 under bf16 compute), batches
    gathered there by index, so a step moves one index vector to the card
  * ``epoch_index_batches``: the index batches of one epoch over a staged set

The JAX package's ``SlabRotatingLoader`` (caches larger than device memory)
is not ported yet.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from music_transcription_tpu_torch.config import NUM_KEYS


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> tuple[np.ndarray, int]:
    """Zero-pad ``axis`` up to a multiple; returns the padded array and the
    original size."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad), n


def collate_mel(items: list, pad_to: int | None = None):
    """[(mel (M, T_i), roll (88, T_i))] -> (mel (B, 1, M, T), roll (B, 88, T),
    lengths (B,) int32), zero-padded at the tail."""
    lengths = np.array([m.shape[-1] for m, _ in items], np.int32)
    max_t = int(pad_to) if pad_to else int(lengths.max())
    b, n_mels = len(items), items[0][0].shape[0]
    mel = np.empty((b, 1, n_mels, max_t), np.float32)
    roll = np.empty((b, NUM_KEYS, max_t), np.float32)
    for i, (m, r) in enumerate(items):
        t = min(m.shape[-1], max_t)
        mel[i, 0, :, :t] = m[:, :t]
        mel[i, 0, :, t:] = 0.0
        tr = min(r.shape[-1], max_t)
        roll[i, :, :tr] = r[:, :tr]
        roll[i, :, tr:] = 0.0
    return mel, roll, np.minimum(lengths, max_t)


class Loader:
    """Epoch loader over an indexable dataset: threaded item decode with a
    bounded lookahead, deterministic order given ``seed`` (reshuffled every
    epoch). ``pad_last_batch`` pads the tail batch to ``batch_size`` with
    zero rows whose length is 0, which the masked loss excludes exactly (for
    evaluation; training drops the tail, since BatchNorm's batch statistics
    are not neutral to padding)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4, drop_last: bool = False, collate=collate_mel,
                 pad_to: int | None = None, pad_last_batch: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.collate = collate
        self.pad_to = pad_to
        self.pad_last_batch = pad_last_batch and not drop_last
        self.epoch = 0

    def _maybe_pad(self, batch):
        if not self.pad_last_batch or batch[0].shape[0] == self.batch_size:
            return batch
        return tuple(pad_to_multiple(np.asarray(a), self.batch_size)[0] for a in batch)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self):
        order = self._order()
        self.epoch += 1
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]
        if self.num_workers == 0:
            for bidx in batches:
                yield self._maybe_pad(self.collate([self.dataset[int(i)] for i in bidx],
                                                   pad_to=self.pad_to))
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            lookahead = max(2, self.num_workers)
            futures = [[pool.submit(self.dataset.__getitem__, int(i)) for i in bidx]
                       for bidx in batches[:lookahead]]
            for bi in range(len(batches)):
                fs = futures.pop(0)
                if bi + lookahead < len(batches):
                    futures.append([pool.submit(self.dataset.__getitem__, int(i))
                                    for i in batches[bi + lookahead]])
                yield self._maybe_pad(self.collate([f.result() for f in fs], pad_to=self.pad_to))


def stage_to_device(dataset, collate, *, device, pad_to: int | None = None,
                    num_workers: int = 4, verbose: bool = False,
                    bf16_fields: tuple[int, ...] = (), u8_fields: tuple[int, ...] = ()):
    """Collate a whole dataset into one batch per field and put it on
    ``device``. ``bf16_fields`` are staged as bfloat16 (half the bytes; for
    model inputs under bf16 compute, whose first layer makes the same
    round-to-nearest cast), ``u8_fields`` as uint8 (binary piano rolls,
    exact; anything but 0 and 1 raises). Returns (tensors, n_items)."""
    n = len(dataset)
    if num_workers > 0:
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            items = list(pool.map(dataset.__getitem__, range(n)))
    else:
        items = [dataset[i] for i in range(n)]
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in collate(items, pad_to=pad_to)]
    del items
    for i in bf16_fields:
        if not host[i].is_floating_point():
            raise ValueError(f"bf16 field {i} must be float, got {host[i].dtype}")
        host[i] = host[i].to(torch.bfloat16)
    for i in u8_fields:
        a = host[i]
        if not a.is_floating_point() or not bool(((a == 0) | (a == 1)).all()):
            raise ValueError(f"u8 field {i} must be a binary float array (piano roll); "
                             f"got dtype={a.dtype}")
        host[i] = a.to(torch.uint8)
    if verbose:
        mb = sum(a.numel() * a.element_size() for a in host) / 1e6
        print(f"Staging {n} items ({mb:.0f} MB) on {device}...")
    return tuple(a.to(device) for a in host), n


def epoch_index_batches(n: int, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                        epoch: int = 0, drop_last: bool = True):
    """Index batches (int32) of one epoch over a staged dataset."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(n_batches):
        yield idx[b * batch_size:(b + 1) * batch_size].astype(np.int32)


class DeviceStagedLoader:
    """Loader-compatible iteration over a dataset staged on ``device``:
    batches are gathered there, and compact fields widened back to float32,
    so they come out as the streaming Loader's would. With
    ``pad_last_batch`` the tail batch is padded to full size with rows of
    length 0 (the last collate field must be the lengths)."""

    def __init__(self, dataset, batch_size: int, *, device, collate=collate_mel,
                 pad_to: int | None = None, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4, drop_last: bool = False, pad_last_batch: bool = False,
                 verbose: bool = False,
                 bf16_fields: tuple[int, ...] = (), u8_fields: tuple[int, ...] = ()):
        self.device = torch.device(device)
        self.arrays, self.n = stage_to_device(
            dataset, collate, device=self.device, pad_to=pad_to, num_workers=num_workers,
            verbose=verbose, bf16_fields=bf16_fields, u8_fields=u8_fields)
        self.widen = frozenset(bf16_fields) | frozenset(u8_fields)
        self.batch_size = batch_size
        self.shuffle, self.seed = shuffle, seed
        self.drop_last = drop_last
        self.pad_last_batch = pad_last_batch and not drop_last
        self.epoch = 0

    def __len__(self) -> int:
        return self.n // self.batch_size if self.drop_last else -(-self.n // self.batch_size)

    def __iter__(self):
        batches = epoch_index_batches(self.n, self.batch_size, shuffle=self.shuffle,
                                      seed=self.seed, epoch=self.epoch, drop_last=self.drop_last)
        self.epoch += 1
        for idx in batches:
            n_real = len(idx)
            if n_real < self.batch_size and self.pad_last_batch:
                idx = np.pad(idx, (0, self.batch_size - n_real))
            sel = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            out = [a.index_select(0, sel) for a in self.arrays]
            out = [a.float() if i in self.widen else a for i, a in enumerate(out)]
            if self.pad_last_batch:
                out[-1][n_real:] = 0
            yield tuple(out)
