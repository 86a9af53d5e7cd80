"""Sharded train state on the data axis: ZeRO-1 and FSDP, a port of the
JAX package's ``parallel/partitioning.py``.

  * **ZeRO-1** (``shard_params=False``): the Adam moments shard over the
    ranks. The optimizer becomes a ``ZeroRedundancyOptimizer`` around the
    same Adam: each rank updates the parameters it owns and broadcasts them.
    The gradients are reduced in full first, as under ``dp``.
  * **FSDP** (``shard_params=True``): parameters, gradients and moments
    shard over the ranks (``fully_shard``, FSDP2). The forward and backward
    all-gather the parameters, the backward reduce-scatters the gradients;
    the hand-written kernels see the gathered, contiguous fp32 tensors.

The step is the data-parallel one (``parallel/train_step.py``: sync-BN,
frame-weighted gradients), so the numerics are those of ``dp``. JAX's
leaf-by-leaf rule (``_leaf_spec``: the largest divisible axis, leaves under
``min_leaf_size`` replicated) has no counterpart: ZeRO-1 gives each rank
whole parameters' moments, FSDP2 shards every parameter on its first axis.
``sharded_param_bytes`` says what each rank holds.

Checkpoints keep one format whatever the placement:
``full_model_state_dict`` and ``full_optimizer_state_dict`` gather the
model's state_dict and plain Adam's optimizer state_dict on rank 0 (ZeRO-1
consolidates its shards; FSDP gathers through
``torch.distributed.checkpoint.state_dict``, full and on the CPU), so a
sharded run's checkpoint resumes on one device, and a one-device checkpoint
loads before ``shard_state`` and carries its Adam state into the shards.
FSDP's collectives on CUDA tensors need NCCL: ranks that share a card
(gloo) cannot run it.
"""

from __future__ import annotations

import torch

from music_transcription_tpu_torch.parallel.distributed import backend, rank_and_world
from music_transcription_tpu_torch.parallel.train_step import TrainState


def _named_params(module: torch.nn.Module) -> list[str]:
    return [name for name, _ in module.named_parameters()]


def _by_name(optim_sd: dict, names: list[str]) -> dict:
    """Plain optimizer state_dict (parameter indices) ->
    torch.distributed.checkpoint's full form (parameter names)."""
    return {"state": {names[i]: v for i, v in optim_sd["state"].items()},
            "param_groups": [dict(g, params=[names[i] for i in g["params"]])
                             for g in optim_sd["param_groups"]]}


def shard_state(state: TrainState, mesh, *, shard_params: bool) -> TrainState:
    """``state`` (replicated over ``mesh`` by ``train_step.data_parallel``)
    with its Adam moments (ZeRO-1) or also its parameters and gradients
    (FSDP) sharded over the ranks; Adam's state so far carried over."""
    if state.group is None:
        raise ValueError("shard_state needs a data-parallel state (train_step.data_parallel)")
    old = state.optimizer
    defaults = {k: v for k, v in old.defaults.items() if k != "params"}
    old_sd = old.state_dict()
    params = list(state.model.parameters())
    if not shard_params:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        state.optimizer = ZeroRedundancyOptimizer(params, optimizer_class=type(old),
                                                  process_group=state.group, **defaults)
        if old_sd["state"]:
            state.optimizer.load_state_dict(old_sd)
        state.partitioning = "zero1"
        return state

    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_optimizer_state_dict
    from torch.distributed.fsdp import fully_shard

    module = state.model.model
    if params[0].device.type == "cuda" and backend() == "gloo":
        raise ValueError("partitioning='fsdp' all-gathers and reduce-scatters CUDA tensors, which "
                         "needs NCCL: one card a rank (these ranks share a card, over gloo)")
    names = _named_params(module)
    fully_shard(module, mesh=mesh)
    state.optimizer = type(old)(state.model.parameters(), **defaults)
    if old_sd["state"]:
        set_optimizer_state_dict(module, state.optimizer, _by_name(old_sd, names),
                                 options=StateDictOptions(full_state_dict=True))
        # the hyperparameters as they were (the loaded form lists their tuples)
        for new, was in zip(state.optimizer.param_groups, old.param_groups):
            new.update((k, v) for k, v in was.items() if k != "params")
    state.partitioning = "fsdp"
    return state


def full_model_state_dict(state: TrainState) -> dict | None:
    """The model's whole state_dict (``state.model.model``'s keys) on rank 0,
    None on the others. Every rank must call it: under FSDP it gathers."""
    rank = rank_and_world()[0]
    if state.partitioning == "fsdp":
        from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

        sd = get_model_state_dict(state.model.model,
                                  options=StateDictOptions(full_state_dict=True, cpu_offload=True))
        return sd if rank == 0 else None
    return state.model.model.state_dict() if rank == 0 else None


def full_optimizer_state_dict(state: TrainState) -> dict | None:
    """plain Adam's state_dict of the whole model on rank 0, None on the
    others. Every rank must call it: ZeRO-1 consolidates, FSDP gathers."""
    rank = rank_and_world()[0]
    if state.partitioning == "zero1":
        state.optimizer.consolidate_state_dict(to=0)
        return state.optimizer.state_dict() if rank == 0 else None
    if state.partitioning == "fsdp":
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
