"""Processes of a data-parallel run, a port of the JAX package's
``parallel/distributed.py``.

One process per rank, started by ``torchrun``:

    torchrun --standalone --nproc_per_node N -m music_transcription_tpu_torch.train ...

``maybe_initialize_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) where the JAX package reads ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``, and joins the process group.
The backend follows from where the ranks run: NCCL when every local rank
has a card of its own, gloo when ranks share a card or run on the CPU
(gloo takes CUDA tensors for ``broadcast``, ``all_reduce`` and ``barrier``,
which is what ``dp`` and ZeRO-1 need; FSDP's all-gather and reduce-scatter
on CUDA tensors need NCCL). At world 1 it does nothing.

``ProcessShard`` gives each rank its slice of a dataset (round-robin, equal
lengths by wrap-around), ``local_batch_size`` its rows of a global batch.
Both go by the rank's data index (``data_coordinate``): on a 2-D
``(data, model)`` mesh of ``n_model`` ranks a row, the ranks of one row
(model peers) load the same rows, as ``P(DATA_AXIS)`` lays a batch out.
``all_reduce_sum`` is an all-reduce whose backward sums the gradients over
the ranks, as ``jax.lax.psum`` differentiates. ``spawn_ranks`` starts the
ranks of a run as subprocesses without ``torchrun`` (the dryrun gate, the
tests), every wait bounded.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_world_size() -> int:
    """Ranks on this node (torchrun's ``LOCAL_WORLD_SIZE``; the world size
    when it is not set)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", rank_and_world()[1]))


def choose_backend(device_type: str, local_ranks: int, cards: int) -> str:
    """NCCL when every one of ``local_ranks`` ranks has a card of its own,
    gloo when they share cards or run on the CPU."""
    return "nccl" if device_type == "cuda" and cards >= local_ranks else "gloo"


def maybe_initialize_distributed(device="cuda", verbose: bool = True) -> bool:
    """Join the process group that torchrun's environment describes, on
    the rank's ``device`` type. Returns True when the run has more than one
    process. A group that already exists (a caller made it, e.g. over a
    ``file://`` store) is kept as it is."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = os.environ.get("RANK")
    if rank is None:
        # a default of 0 would make every process claim rank 0
        raise RuntimeError("WORLD_SIZE is set but RANK is not; set a distinct rank per "
                           "process (torchrun does)")
    device_type = torch.device(device).type
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = choose_backend(device_type, local_world_size(), cards)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device))  # NCCL's and "cuda"'s device
    dist.init_process_group(backend, rank=int(rank), world_size=world)
    if verbose:
        print(f"distributed: rank {rank}/{world} ({local_world_size()} on this node), "
              f"backend {backend}, device {rank_device(device)}")
    return True


def rank_device(device) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK % device_count`` on the card
    (ranks beyond the cards share them), the CPU when asked for."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: no GPU is visible to PyTorch")
    local_rank = int(os.environ.get("LOCAL_RANK", rank_and_world()[0]))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend() -> str | None:
    """The default group's backend ("nccl", "gloo"), None outside a group."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def shutdown() -> None:
    """Leave the process group (a no-op outside one), so that ranks that
    stop early do not hold the others in a collective."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def data_coordinate(n_model: int = 1) -> tuple[int, int]:
    """(data index, data axis size) of this rank on a ``(world / n_model,
    n_model)`` mesh: (rank // n_model, world // n_model). With ``n_model``
    1 it is (rank, world)."""
    rank, world = rank_and_world()
    if n_model < 1 or world % n_model:
        raise ValueError(f"model_parallel={n_model} does not divide the {world} rank(s) of "
                         f"this run; launch a multiple of {n_model} ranks (torchrun "
                         f"--nproc_per_node)")
    return rank // n_model, world // n_model


def local_batch_size(global_batch_size: int, n_model: int = 1) -> int:
    """A rank's rows of a global batch: its share of the data axis (which
    must divide it: uneven batches would desynchronise the collectives of a
    step)."""
    n = data_coordinate(n_model)[1]
    if global_batch_size % n:
        axis = f"world size {n}" if n_model == 1 else f"data axis ({n} rows of {n_model} ranks)"
        raise ValueError(f"global batch_size={global_batch_size} must be divisible by the {axis}")
    return global_batch_size // n


class ProcessShard:
    """The view of an indexable dataset that holds this rank's slice.

    Round-robin (i -> global index i * P + p). By default every shard has
    the SAME length, ceil(total / P), wrapping around to the first indices:
    ranks with different lengths would issue different numbers of steps
    and deadlock in a collective. ``exact=True`` drops the wrap-around
    (lengths may differ by one), for evaluation without collectives, where
    duplicates would bias a metric. The index and count default to the
    rank and the world size (on a 2-D mesh the caller passes the rank's
    ``data_coordinate``)."""

    def __init__(self, dataset, process_index: int | None = None,
                 process_count: int | None = None, exact: bool = False):
        rank, world = rank_and_world()
        self.dataset = dataset
        self.p = rank if process_index is None else process_index
        self.n = world if process_count is None else process_count
        self.exact = exact

    def __len__(self) -> int:
        if self.exact:
            total = len(self.dataset)
            return total // self.n + (1 if self.p < total % self.n else 0)
        return -(-len(self.dataset) // self.n)

    def __getitem__(self, i: int):
        g = i * self.n + self.p
        if self.exact:
            if g >= len(self.dataset):
                raise IndexError(g)
            return self.dataset[g]
        return self.dataset[g % len(self.dataset)]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, on every rank. Its
    backward is the same sum of the incoming gradients: each rank's output
    feeds every rank's loss."""
    return _AllReduceSum.apply(x, group)


def spawn_ranks(argv_of_rank, world: int, *, timeout: float, env=None, cwd=None,
                stop_on_failure: bool = False) -> tuple[list[int], list[str]]:
    """Run ``argv_of_rank(r)`` for each rank r < ``world`` as a subprocess:
    (exit codes, outputs, stdout and stderr together). With
    ``stop_on_failure`` the other ranks are killed once one exits non-zero
    (their codes are then negative). Raises ``TimeoutError`` with the
    outputs' tails when a rank outlives ``timeout`` seconds; no rank
    outlives the call."""
    logs = [tempfile.TemporaryFile() for _ in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            procs.append(subprocess.Popen(argv_of_rank(r), stdout=log,
                                          stderr=subprocess.STDOUT, env=env, cwd=cwd))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if stop_on_failure and any(p.poll() for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"a rank outlived {timeout} s:\n" + "\n".join(
                    f"rank {r}: {_read(log)[-2000:]}" for r, log in enumerate(logs)))
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [_read(log) for log in logs]
    for log in logs:
        log.close()
    return [p.returncode for p in procs], outs


def _read(log) -> str:
    log.seek(0)
    return log.read().decode(errors="replace")
