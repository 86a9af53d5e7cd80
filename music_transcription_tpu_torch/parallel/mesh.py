"""The data axis of a run, a port of the JAX package's ``parallel/mesh.py``.

Training is data-parallel over the ``data`` axis of a mesh of the run's
ranks (one process each): a 1-D ``data`` mesh, or the 2-D ``(data, model)``
mesh of ``parallel/partitioning.make_mesh_2d``, whose rank r sits at
(r // n_model, r % n_model). Each global batch is split into contiguous
blocks of rows in data-index order (``P(DATA_AXIS)``'s layout): the ranks
of one row of a 2-D mesh (model peers) take the same rows. The state is
replicated over every rank, the gradients reduced over all of them
(``parallel/train_step.py``). JAX's ``positional_arity`` is a helper of its
``jit`` wrappers and has no counterpart here.
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


def data_index(mesh) -> int:
    """This rank's coordinate on the mesh's ``data`` axis."""
    return mesh.get_local_rank(DATA_AXIS)


def data_size(mesh) -> int:
    """The number of rows of the ``data`` axis (the batch's shards)."""
    return mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def mesh_group(mesh):
    """The process group of all the mesh's ranks. A 2-D ``DeviceMesh`` has
    no group of its own (``get_group()`` raises); a mesh spans every rank
    of the run (``make_mesh``, ``make_mesh_2d``), so it is the default one."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def shard_batch(batch, mesh):
    """This rank's rows of a global batch: the contiguous block of
    ``len / data_size`` rows at its data index, for each array of ``batch``."""
    n, index = data_size(mesh), data_index(mesh)

    def rows(a):
        if a.shape[0] % n:
            raise ValueError(f"batch of {a.shape[0]} rows does not divide the data axis ({n})")
        k = a.shape[0] // n
        return a[index * k:(index + 1) * k]

    return tuple(rows(a) for a in batch)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's first
    rank over all its ranks, in place: every rank then holds that state."""
    group = mesh_group(mesh)
    src = dist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module
