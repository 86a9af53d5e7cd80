"""Host input pipeline and device-staged feeding, a port of the JAX
package's ``data/pipeline.py``.

  * ``collate_mel``: pad mel / roll to the batch's longest T (or ``pad_to``)
    and return (mel (B, 1, M, T), roll (B, 88, T), lengths (B,)) as numpy
  * ``collate_tokens`` / ``collate_wave_roll``: the AST tier's batches,
    (wave (B, N), tokens (B, L)) and (wave (B, N), roll (B, 88, T), lengths)
  * ``Loader``: epoch iteration with a thread pool decoding items ahead;
    its shuffle is ``np.random.default_rng(seed + epoch)``, so it yields the
    JAX package's batches in the JAX package's order
  * ``DeviceStagedLoader``: the whole dataset (or its first ``limit``
    items) staged on the card once (mel as bf16 and the binary roll as uint8
    under bf16 compute, waves as int16 PCM with ``compact_fields``), batches
    gathered there by index, so a step moves one index vector to the card
  * ``SlabRotatingLoader``: for caches larger than the staging limit, each
    epoch's permutation cut into equal slabs, one slab staged at a time
    while the next stages behind it; the JAX package's batches in its order
  * ``epoch_index_batches``: the index batches of one epoch over a staged set
  * ``device_prefetch``: a loader's batches moved to the rank's device by a
    producer thread, ``depth`` batches ahead, through pinned memory
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from music_transcription_tpu_torch.config import NUM_KEYS
from music_transcription_tpu_torch.data.cache import PCM16_SCALE, quantize_i16


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


def collate_tokens(items: list, pad_to: int | None = None):
    """[(waveform (n_i,), tokens (L,))] -> (wave (B, N) float32, tokens (B, L)
    int64): waves zero-padded or cut to ``pad_to`` (default the longest)."""
    n = max(w.shape[-1] for w, _ in items) if pad_to is None else int(pad_to)
    wave = np.zeros((len(items), n), np.float32)
    for i, (w, _) in enumerate(items):
        t = min(w.shape[-1], n)
        wave[i, :t] = w[:t]
    return wave, np.stack([np.asarray(t, np.int64) for _, t in items])


def collate_wave_roll(items: list, pad_to: int | None = None, roll_pad_to: int | None = None):
    """[(waveform (n_i,), roll (88, T_i))] -> (wave (B, N) float32, roll (B, 88,
    T) float32, lengths (B,) int32) for encoder pretraining: waves padded or
    cut to ``pad_to``, rolls to ``roll_pad_to`` (defaults: the longest)."""
    n = max(w.shape[-1] for w, _ in items) if pad_to is None else int(pad_to)
    lengths = np.array([r.shape[-1] for _, r in items], np.int32)
    max_t = int(roll_pad_to) if roll_pad_to else int(lengths.max())
    wave = np.zeros((len(items), n), np.float32)
    roll = np.zeros((len(items), NUM_KEYS, max_t), np.float32)
    for i, (w, r) in enumerate(items):
        t = min(w.shape[-1], n)
        wave[i, :t] = w[:t]
        tr = min(r.shape[-1], max_t)
        roll[i, :, :tr] = r[:, :tr]
    return wave, roll, np.minimum(lengths, max_t)


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
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        finished = False
        try:
            lookahead = max(2, self.num_workers)
            futures = [[pool.submit(self.dataset.__getitem__, int(i)) for i in bidx]
                       for bidx in batches[:lookahead]]
            for bi in range(len(batches)):
                fs = futures.pop(0)
                if bi + lookahead < len(batches):
                    futures.append([pool.submit(self.dataset.__getitem__, int(i))
                                    for i in batches[bi + lookahead]])
                yield self._maybe_pad(self.collate([f.result() for f in fs], pad_to=self.pad_to))
            finished = True
        finally:
            # an iteration left early (a break, an error) does not wait for
            # its look-ahead items: its close may run in the generator's
            # finalizer, where a KeyboardInterrupt (Ctrl-C, SIGTERM through
            # train.loop.install_graceful_sigterm) landing in a long wait is
            # dropped and the run goes on
            pool.shutdown(wait=finished, cancel_futures=not finished)


def collate_subset(dataset, collate, indices, *, pad_to: int | None = None,
                   num_workers: int = 4, compact_fields: tuple[int, ...] = (),
                   bf16_fields: tuple[int, ...] = (),
                   u8_fields: tuple[int, ...] = ()) -> list[torch.Tensor]:
    """The items at ``indices`` collated into one batch per field, as CPU
    tensors in their staged dtypes: ``compact_fields`` as int16 at PCM16
    scale (``quantize_i16``: exact for audio decoded from 16-bit PCM),
    ``bf16_fields`` as bfloat16 (for model inputs under bf16 compute, whose
    first layer makes the same round-to-nearest cast), ``u8_fields`` as
    uint8 (binary piano rolls, exact; anything but 0 and 1 raises)."""
    indices = [int(i) for i in indices]
    if num_workers > 0:
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            items = list(pool.map(dataset.__getitem__, indices))
    else:
        items = [dataset[i] for i in indices]
    host = list(collate(items, pad_to=pad_to))
    del items
    for i in compact_fields:
        if not np.issubdtype(host[i].dtype, np.floating):
            raise ValueError(f"compact field {i} must be float, got {host[i].dtype}")
        host[i] = quantize_i16(host[i])
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in host]
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
    return host


def stage_to_device(dataset, collate, *, device, pad_to: int | None = None,
                    limit: int | None = None, num_workers: int = 4, verbose: bool = False,
                    compact_fields: tuple[int, ...] = (), bf16_fields: tuple[int, ...] = (),
                    u8_fields: tuple[int, ...] = (), indices=None):
    """Collate the dataset (its first ``limit`` items, or the items at
    ``indices``) into one batch per field, in the dtypes of
    ``collate_subset``, and put it on ``device``. Returns (tensors, n_items)."""
    if indices is None:
        indices = range(len(dataset) if limit is None else min(limit, len(dataset)))
    host = collate_subset(dataset, collate, indices, pad_to=pad_to, num_workers=num_workers,
                          compact_fields=compact_fields, bf16_fields=bf16_fields,
                          u8_fields=u8_fields)
    if verbose:
        mb = sum(a.numel() * a.element_size() for a in host) / 1e6
        print(f"Staging {len(indices)} items ({mb:.0f} MB) on {device}...")
    return tuple(a.to(device) for a in host), len(indices)


def dequantize_i16(a: torch.Tensor) -> torch.Tensor:
    """Inverse of ``cache.quantize_i16``. 1 / 32768 is a power of two, so the
    product equals ``load_chunk``'s quotient bit for bit."""
    return a.float() * (1.0 / PCM16_SCALE)


def _make_dequantizer(compact_fields=(), bf16_fields=(), u8_fields=()):
    """Per field, the inverse of the staged dtype: int16 PCM dequantized,
    bf16 and uint8 widened to float32, so gathered batches come out in the
    streaming Loader's dtypes."""
    cf = frozenset(compact_fields)
    widen = frozenset(bf16_fields) | frozenset(u8_fields)

    def dq(out):
        return tuple(dequantize_i16(a) if i in cf else a.float() if i in widen else a
                     for i, a in enumerate(out))

    return dq


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
    """Loader-compatible iteration over a dataset (its first ``limit``
    items) staged on ``device``: batches are gathered there, and compact
    fields widened back to float32, so they come out as the streaming
    Loader's would. With ``pad_last_batch`` the tail batch is padded to full
    size with rows of length 0 (the last collate field must be the
    lengths)."""

    def __init__(self, dataset, batch_size: int, *, device, collate=collate_mel,
                 pad_to: int | None = None, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4, drop_last: bool = False, pad_last_batch: bool = False,
                 verbose: bool = False, limit: int | None = None,
                 compact_fields: tuple[int, ...] = (), bf16_fields: tuple[int, ...] = (),
                 u8_fields: tuple[int, ...] = ()):
        self.device = torch.device(device)
        fields = dict(compact_fields=tuple(compact_fields), bf16_fields=tuple(bf16_fields),
                      u8_fields=tuple(u8_fields))
        self.arrays, self.n = stage_to_device(
            dataset, collate, device=self.device, pad_to=pad_to, limit=limit,
            num_workers=num_workers, verbose=verbose, **fields)
        self.dequantize = _make_dequantizer(**fields)
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
            out = list(self.dequantize(tuple(a.index_select(0, sel) for a in self.arrays)))
            if self.pad_last_batch:
                out[-1][n_real:] = 0
            yield tuple(out)


class SlabRotatingLoader:
    """Device-staged feeding for caches larger than the staging limit.

    Each epoch draws a permutation of the dataset and cuts it into
    ``n_slabs`` equal slabs of ``items_per_slab`` items (whole batches; the
    permutation's remainder sits the epoch out, different items each epoch).
    One slab at a time is staged on ``device`` and its batches gathered there
    by index, as in ``DeviceStagedLoader``; ``passes_per_slab`` > 1 walks a
    staged slab again in a new order before it rotates. Slab s + 1 stages on
    one background thread while slab s trains, so the data on the device
    peaks at 2 slabs; size ``slab_bytes`` for that.

    The order is the JAX package's: one ``np.random.default_rng(seed +
    epoch)`` draws ``permutation(n)`` for the slabs, then
    ``permutation(items_per_slab)`` per slab and pass, in that sequence, so
    the batches hold the same items in the same order at the same seed.

    On a CUDA device a slab is staged from pinned host memory on a side
    stream, with an event recorded there; the consumer's stream waits on the
    event before the slab's first gather, and the slab's tensors are marked
    as used by that stream (``record_stream``), so the caching allocator
    does not hand their memory to the next slab's copy while a gather still
    reads it. ``stage_log`` holds each slab's items, bytes, host time
    (reading and collating the items) and copy time. When the consumer
    abandons an epoch (an early break or an exception), the current slab
    and any prefetched one are dropped and the prefetch thread is joined.
    """

    def __init__(self, dataset, batch_size: int, *, device, collate=collate_mel,
                 pad_to: int | None = None, slab_bytes: float = 4e9,
                 passes_per_slab: int = 1, seed: int = 0, num_workers: int = 4,
                 verbose: bool = False,
                 compact_fields: tuple[int, ...] = (), bf16_fields: tuple[int, ...] = (),
                 u8_fields: tuple[int, ...] = ()):
        self.device = torch.device(device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.pad_to = pad_to
        self.seed = seed
        self.num_workers = num_workers
        self.verbose = verbose
        self.fields = dict(compact_fields=tuple(compact_fields),
                           bf16_fields=tuple(bf16_fields), u8_fields=tuple(u8_fields))
        self.dequantize = _make_dequantizer(**self.fields)
        self.passes_per_slab = max(1, int(passes_per_slab))
        self.epoch = 0
        self.stage_log: list[dict] = []

        n = len(dataset)
        probe = collate([dataset[0]], pad_to=pad_to)
        item_bytes = 0
        for i, a in enumerate(probe):
            b = int(np.asarray(a).nbytes)
            if i in compact_fields or i in bf16_fields:
                b //= 2  # staged as int16 / bfloat16
            elif i in u8_fields:
                b //= 4  # staged as uint8
            item_bytes += b
        budget_items = max(batch_size, int(slab_bytes // max(1, item_bytes)))
        n_slabs = max(1, -(-n // budget_items))
        # equal slabs of whole batches: one gather shape for the whole run
        self.items_per_slab = max(batch_size, (n // n_slabs) // batch_size * batch_size)
        # a budget under 2 batches can leave the last slabs short of items:
        # they are dropped (the JAX package's loader gathers clamped
        # duplicates there)
        self.n_slabs = min(n_slabs, n // self.items_per_slab)
        self.item_bytes = item_bytes
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if verbose:
            print(f"Slab rotation: {self.n_slabs} slabs x {self.items_per_slab} items "
                  f"({self.items_per_slab * item_bytes / 1e9:.2f} GB/slab, {n} items, "
                  f"{item_bytes / 1e6:.2f} MB/item)")

    def __len__(self) -> int:
        return self.n_slabs * self.passes_per_slab * (self.items_per_slab // self.batch_size)

    def plan(self, epoch: int) -> list[tuple[np.ndarray, list[np.ndarray]]]:
        """Epoch ``epoch``'s slabs: for each, its dataset indices and, per
        pass, the order of its positions; batch b of a pass holds
        ``slab[order[b * batch_size:(b + 1) * batch_size]]``."""
        rng = np.random.default_rng(self.seed + epoch)
        m = self.items_per_slab
        perm = rng.permutation(len(self.dataset))
        return [(perm[s * m:(s + 1) * m], [rng.permutation(m) for _ in range(self.passes_per_slab)])
                for s in range(self.n_slabs)]

    def _stage(self, idx):
        """(tensors on the device, the event of their copy or None)."""
        t0 = time.perf_counter()
        host = collate_subset(self.dataset, self.collate, idx, pad_to=self.pad_to,
                              num_workers=self.num_workers, **self.fields)
        nbytes = sum(a.numel() * a.element_size() for a in host)
        ready = None
        if self._stream is None:
            arrays = tuple(a.to(self.device) for a in host)
            t1 = t2 = time.perf_counter()
        else:
            host = [a.pin_memory() for a in host]
            t1 = time.perf_counter()
            with torch.cuda.stream(self._stream):
                arrays = tuple(a.to(self.device, non_blocking=True) for a in host)
                ready = torch.cuda.Event()
                ready.record(self._stream)
            ready.synchronize()  # this thread only: the staging time ends here
            t2 = time.perf_counter()
        self.stage_log.append(dict(items=len(idx), bytes=nbytes, host_s=t1 - t0,
                                   copy_s=t2 - t1))
        if self.verbose:
            print(f"Slab of {len(idx)} items staged ({nbytes / 1e6:.0f} MB): host "
                  f"{t1 - t0:.2f} s, copy {t2 - t1:.3f} s")
        return arrays, ready

    def _gather(self, arrays, positions):
        sel = torch.from_numpy(positions.astype(np.int64)).to(self.device)
        return self.dequantize(tuple(a.index_select(0, sel) for a in arrays))

    def __iter__(self):
        plan = self.plan(self.epoch)
        self.epoch += 1
        if not plan:  # fewer items than a batch
            return
        bs, n_batches = self.batch_size, self.items_per_slab // self.batch_size
        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="slab-prefetch")
        pending = pool.submit(self._stage, plan[0][0])
        arrays = ()
        try:
            for s, (_, orders) in enumerate(plan):
                arrays, ready = pending.result()
                pending = pool.submit(self._stage, plan[s + 1][0]) if s + 1 < len(plan) else None
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    for a in arrays:
                        a.record_stream(stream)
                for order in orders:
                    for b in range(n_batches):
                        yield self._gather(arrays, order[b * bs:(b + 1) * bs])
                arrays = ()
        finally:
            # on abandonment too: drop the current slab, cancel or wait out the
            # prefetch and drop what it staged, join the thread
            arrays = ()
            pool.shutdown(wait=True, cancel_futures=True)
            pending = None


def device_prefetch(iterator, device, depth: int = 2, pad_to_mesh: bool = False, world: int = 1):
    """The batches of ``iterator`` (tuples of numpy arrays or tensors) as
    tensors on ``device``, moved by a producer thread that keeps ``depth``
    batches in flight; the counterpart of the JAX package's
    ``device_prefetch``. On a card a host batch is pinned and copied on a
    side stream; the consumer's stream waits for the copy's event, and the
    tensors are marked as used by it (``record_stream``). A batch already on
    ``device`` (a staged loader's) passes as it is.

    ``pad_to_mesh`` pads a tail batch with zero rows (length 0, which the
    masked loss leaves out of both its sum and its denominator) to the
    first batch's size: for evaluation, which keeps the tail (training
    drops it, since BatchNorm's batch statistics are not neutral to
    padding). Under ``world`` > 1 each rank feeds its own rows and the
    Loader's ``pad_last_batch`` aligns the sizes on every rank, as in JAX,
    so ``pad_to_mesh`` does nothing there.

    When the consumer abandons the iteration (an early break, an exception
    in the loop), the producer notices, stops, and the queue is emptied.
    """
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    first_n: list[int] = []

    def pad(tensors):
        n = tensors[0].shape[0]
        if not first_n:
            first_n.append(n)
        if n >= first_n[0]:
            return tensors
        return [torch.cat([t, t.new_zeros((first_n[0] - n,) + t.shape[1:])]) for t in tensors]

    def put(batch):
        tensors = [torch.as_tensor(a) for a in batch]
        if pad_to_mesh and world == 1:
            tensors = pad(tensors)
        if stream is None or all(t.device == device for t in tensors):
            return tuple(t.to(device) for t in tensors), None
        with torch.cuda.stream(stream):
            out = tuple(t if t.device == device else t.pin_memory().to(device, non_blocking=True)
                        for t in tensors)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def blocking_put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not blocking_put(put(batch)):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            blocking_put(done)

    thread = threading.Thread(target=producer, daemon=True, name="device-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            batch, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for t in batch:
                    t.record_stream(current)
            yield batch
    finally:
        # the consumer finished or abandoned the iteration: release the producer
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
