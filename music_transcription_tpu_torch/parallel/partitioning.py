"""Sharded train state: ZeRO-1, FSDP and tensor-parallel placement, on a
1-D ``data`` mesh or a 2-D ``(data, model)`` mesh; a port of the JAX
package's ``parallel/partitioning.py``.

  * **ZeRO-1** (``strategy="zero1"``): the Adam moments shard over the
    shard axis. The optimizer becomes a ``ZeroRedundancyOptimizer`` around
    the same Adam over that axis's group: each rank updates the parameters
    it owns and broadcasts them. The gradients are reduced in full over all
    ranks first, as under ``dp``.
  * **FSDP** (``"fsdp"``): parameters, gradients and moments shard over the
    shard axis (``fully_shard``, FSDP2), each parameter on its first dim.
  * **TP** (``"tp"``): FSDP2 with JAX's tensor-parallel placement
    (``_leaf_spec_tp``, read in torch layout through
    ``checkpoints.jax_axes``): the dim that holds JAX's last (feature) axis
    when the axis size n divides it and it is at least 2n, else the largest
    other such dim. It partitions the state, not the compute: every rank
    runs the whole forward on its rows with the parameters all-gathered
    (the hand-written recurrence kernels take whole weights; a column-split
    recurrence would all-gather h at every time step), where JAX leaves the
    compute's partitioning to GSPMD.

On a 1-D mesh the shard axis is ``data`` itself (classic ZeRO); on a 2-D
mesh it is ``model``, and the state is replicated over ``data`` (FSDP2's
HSDP: ``(Replicate(), Shard(d))``), as JAX's ``state_shardings`` places it.
FSDP2 shards unevenly, so every parameter shards, small ones too: JAX's
``min_leaf_size`` (leaves under it replicated) has no counterpart, and a
leaf that JAX would replicate for want of a divisible axis shards on its
first dim. The forward and backward all-gather the parameters, the backward
reduce-scatters the gradients; the hand-written kernels see the gathered,
contiguous fp32 tensors. The step is the data-parallel one
(``parallel/train_step.py``: sync-BN, frame-weighted gradients), so the
numerics are those of ``dp``. ``sharded_param_bytes`` says what each rank
holds.

Checkpoints keep one format whatever the placement:
``full_model_state_dict`` and ``full_optimizer_state_dict`` gather the
model's state_dict and plain Adam's optimizer state_dict on rank 0 (ZeRO-1
consolidates its shards; FSDP2 gathers through
``torch.distributed.checkpoint.state_dict``, full and on the CPU), so a
sharded run's checkpoint resumes on one device, and a one-device checkpoint
loads before ``shard_state`` and carries its Adam state into the shards.
FSDP2's collectives on CUDA tensors need NCCL: ranks that share a card
(gloo) cannot run ``fsdp`` or ``tp``.
"""

from __future__ import annotations

import torch

from music_transcription_tpu_torch.checkpoints import jax_axes
from music_transcription_tpu_torch.parallel.distributed import backend, rank_and_world
from music_transcription_tpu_torch.parallel.mesh import DATA_AXIS
from music_transcription_tpu_torch.parallel.train_step import FSDP2, TrainState

MODEL_AXIS = "model"
STRATEGIES = ("zero1", "fsdp", "tp")


def make_mesh_2d(n_data: int, n_model: int, device_type: str = "cuda"):
    """2-D ``(data, model)`` ``DeviceMesh`` over the run's ranks: rank r at
    (r // n_model, r % n_model), so ``model`` groups neighbouring ranks (the
    cards of one node first). It must cover every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    check_mesh_2d(n_data, n_model)
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def check_mesh_2d(n_data: int, n_model: int) -> None:
    """``make_mesh_2d``'s checks, JAX's messages: each dim at least 1, and
    the run's ranks exactly n_data x n_model."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh dims must be >= 1, got ({n_data}, {n_model})")
    need, world = n_data * n_model, rank_and_world()[1]
    if need > world:
        raise ValueError(f"requested {need} devices, have {world}; launch {need} ranks "
                         f"(torchrun --nproc_per_node {need})")
    if need != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh of {need} of the {world} ranks would "
                         f"leave ranks idle; launch {need} ranks (torchrun --nproc_per_node "
                         f"{need})")


def shard_axis(mesh) -> str:
    """The axis the state shards over: ``model`` on a 2-D mesh, else ``data``."""
    return MODEL_AXIS if MODEL_AXIS in mesh.mesh_dim_names else DATA_AXIS


def tp_axis(shape: tuple[int, ...], n: int) -> int | None:
    """JAX's ``_leaf_spec_tp`` on a JAX-layout shape, without its size
    threshold: the last (feature) axis if ``n`` divides it and it is at
    least 2n, else the largest other such axis, else None (replicated)."""
    last = len(shape) - 1
    for i in [last] + sorted(range(last), key=lambda i: -shape[i]):
        if shape[i] % n == 0 and shape[i] >= 2 * n:
            return i
    return None


def tp_shard_dims(module: torch.nn.Module, n: int) -> dict[str, int]:
    """The dim each parameter of ``module`` shards on under ``tp`` over an
    axis of ``n`` ranks, by name: ``tp_axis`` of its JAX layout, mapped
    back to torch's; 0 where JAX replicates (FSDP2 shards every parameter
    it holds)."""
    owners = dict(module.named_modules())
    dims = {}
    for name, p in module.named_parameters():
        axes = jax_axes(owners[name.rpartition(".")[0]], p)
        i = tp_axis(tuple(p.shape[d] for d in axes), n)
        dims[name] = 0 if i is None else axes[i]
    return dims


def _named_params(module: torch.nn.Module) -> list[str]:
    return [name for name, _ in module.named_parameters()]


def _by_name(optim_sd: dict, names: list[str]) -> dict:
    """Plain optimizer state_dict (parameter indices) ->
    torch.distributed.checkpoint's full form (parameter names)."""
    return {"state": {names[i]: v for i, v in optim_sd["state"].items()},
            "param_groups": [dict(g, params=[names[i] for i in g["params"]])
                             for g in optim_sd["param_groups"]]}


def shard_state(state: TrainState, mesh, *, strategy: str) -> TrainState:
    """``state`` (replicated over ``mesh`` by ``train_step.data_parallel``)
    with its Adam moments (``zero1``) or also its parameters and gradients
    (``fsdp``, ``tp``) sharded over the mesh's shard axis; Adam's state so
    far carried over."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} ({' | '.join(STRATEGIES)})")
    if state.group is None:
        raise ValueError("shard_state needs a data-parallel state (train_step.data_parallel)")
    old = state.optimizer
    defaults = {k: v for k, v in old.defaults.items() if k != "params"}
    old_sd = old.state_dict()
    params = list(state.model.parameters())
    axis = shard_axis(mesh)
    if strategy == "zero1":
        from torch.distributed.optim import ZeroRedundancyOptimizer

        state.optimizer = ZeroRedundancyOptimizer(params, optimizer_class=type(old),
                                                  process_group=mesh.get_group(axis),
                                                  **defaults)
        if old_sd["state"]:
            state.optimizer.load_state_dict(old_sd)
        state.partitioning = "zero1"
        return state

    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_optimizer_state_dict
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    module = state.model.model
    if params[0].device.type == "cuda" and backend() == "gloo":
        raise ValueError(f"partitioning={strategy!r} all-gathers and reduce-scatters CUDA "
                         "tensors, which needs NCCL: one card a rank (these ranks share a "
                         "card, over gloo)")
    names = _named_params(module)
    placement = None
    if strategy == "tp":
        dims = tp_shard_dims(module, mesh.size(mesh.mesh_dim_names.index(axis)))
        by_param = {id(p): Shard(dims[n]) for n, p in module.named_parameters()}

        def placement(p):
            return by_param[id(p)]
    fully_shard(module, mesh=mesh, shard_placement_fn=placement)
    state.optimizer = type(old)(state.model.parameters(), **defaults)
    if old_sd["state"]:
        set_optimizer_state_dict(module, state.optimizer, _by_name(old_sd, names),
                                 options=StateDictOptions(full_state_dict=True))
        # the hyperparameters as they were (the loaded form lists their tuples)
        for new, was in zip(state.optimizer.param_groups, old.param_groups):
            new.update((k, v) for k, v in was.items() if k != "params")
    state.partitioning = strategy
    return state


def full_model_state_dict(state: TrainState) -> dict | None:
    """The model's whole state_dict (``state.model.model``'s keys) on rank 0,
    None on the others. Every rank must call it: under FSDP2 it gathers."""
    rank = rank_and_world()[0]
    if state.partitioning in FSDP2:
        from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

        sd = get_model_state_dict(state.model.model,
                                  options=StateDictOptions(full_state_dict=True, cpu_offload=True))
        return sd if rank == 0 else None
    return state.model.model.state_dict() if rank == 0 else None


def full_optimizer_state_dict(state: TrainState) -> dict | None:
    """plain Adam's state_dict of the whole model on rank 0, None on the
    others. Every rank must call it: ZeRO-1 consolidates (in each shard
    group, on its first rank), FSDP2 gathers."""
    rank = rank_and_world()[0]
    if state.partitioning == "zero1":
        state.optimizer.consolidate_state_dict(to=0)
        return state.optimizer.state_dict() if rank == 0 else None
    if state.partitioning in FSDP2:
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_optimizer_state_dict,
        )

        module = state.model.model
        sd = get_optimizer_state_dict(module, state.optimizer,
                                      options=StateDictOptions(full_state_dict=True,
                                                               cpu_offload=True))
        if rank != 0:
            return None
        # the state by parameter index, the hyperparameters as the optimizer
        # holds them (the gathered form lists their tuples)
        index = {name: i for i, name in enumerate(_named_params(module))}
        return {"state": {index[k]: v for k, v in sd["state"].items()},
                "param_groups": state.optimizer.state_dict()["param_groups"]}
    return state.optimizer.state_dict() if rank == 0 else None


def _local_bytes(t: torch.Tensor) -> int:
    if hasattr(t, "to_local"):
        t = t.to_local()
    return t.numel() * t.element_size()


def sharded_param_bytes(state: TrainState) -> dict[str, int]:
    """The bytes this rank holds of the parameters and of the optimizer
    state (diagnostic)."""
    optim = getattr(state.optimizer, "optim", state.optimizer)  # ZeRO-1's local Adam
    return {"params": sum(_local_bytes(p) for p in state.model.parameters()),
            "opt_state": sum(_local_bytes(v) for s in optim.state.values() for v in s.values()
                             if torch.is_tensor(v))}
