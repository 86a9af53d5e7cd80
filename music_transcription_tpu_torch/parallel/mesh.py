"""The data axis of a run, a port of the JAX package's ``parallel/mesh.py``.

Training is data-parallel over a 1-D ``data`` mesh of the run's ranks (one
process each): the state replicated, each global batch split into
contiguous blocks of rows in rank order (``P(DATA_AXIS)``'s layout), the
gradients reduced over the axis (``parallel/train_step.py``). JAX's
``positional_arity`` is a helper of its ``jit`` wrappers and has no
counterpart here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from music_transcription_tpu_torch.data.pipeline import pad_to_multiple  # noqa: F401 (re-export)
from music_transcription_tpu_torch.parallel.distributed import rank_and_world

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """1-D ``DeviceMesh`` over the run's ranks (``n_devices``, default all
    of them; a mesh over some of the ranks would leave the others idle)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = rank_and_world()[1]
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n != world:
        raise ValueError(f"a mesh of {n} of the {world} ranks would leave ranks idle; "
                         f"launch {n} ranks (torchrun --nproc_per_node {n})")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(DATA_AXIS,))


def shard_batch(batch, mesh):
    """This rank's rows of a global batch: the contiguous block of
    ``len / mesh.size()`` rows at its rank, for each array of ``batch``."""
    n, rank = mesh.size(), mesh.get_local_rank()

    def rows(a):
        if a.shape[0] % n:
            raise ValueError(f"batch of {a.shape[0]} rows does not divide the data axis ({n})")
        k = a.shape[0] // n
        return a[rank * k:(rank + 1) * k]

    return tuple(rows(a) for a in batch)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 over the
    mesh, in place: every rank then holds rank 0's state."""
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module
