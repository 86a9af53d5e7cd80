"""Checkpoints: reference-format ``.pth`` files, training checkpoints, and
the JAX weight and optimizer-state mapping.

``load_torch_checkpoint`` loads a bare ``state_dict`` ``.pth`` (the
reference's format, and what the JAX package's ``save_torch_checkpoint``
writes) into a port module.

Training writes two kinds, each with an ``X.json`` sidecar (model and audio
config, as ``transcribe.load_model`` reads it):

  * ``model_best.pth``: the inference state only (a bare state_dict), its
    step in the sidecar;
  * ``model_epoch_N.pt`` / ``model_final.pt``: everything a resume needs:
    the model state_dict (under ``model_state``, so ``load_torch_checkpoint``
    and ``transcribe.load_model`` read it too), the optimizer state_dict, the
    step and the dropout seed. A data-parallel run writes the same files
    from rank 0, its sharded state gathered, so they resume at any world
    size. The dropout generator of a step is derived
    from (dropout seed, step), so the two are its whole state.

``state_dict_from_jax`` carries the JAX package's weights across: it takes
the ``{"params", "batch_stats"}`` tree as numpy arrays and returns the
port's state_dict; ``optimizer_state_from_jax`` carries optax's Adam
moments and count to ``torch.optim.Adam``. The mapping is the port's own
copy of the one in the JAX package's ``export_torch_state_dict``:

  flax (JAX package)                       torch (this package)
  ------------------                       --------------------
  {name}/conv kernel (kh,kw,I,O)        -> Conv2d weight (O,I,kh,kw)
  {name}/bn scale/bias, mean/var        -> BatchNorm2d weight/bias, running_mean/var
  Dense kernel (I,O)                    -> Linear weight (O,I)
  l{k}_wi_fwd|bwd (I,4H)                -> weight_ih_l{k}[_reverse] (4H,I)
  l{k}_wh_fwd|bwd (H,4H)                -> weight_hh_l{k}[_reverse] (4H,H)
  l{k}_b_fwd|bwd combined bias          -> bias_ih (the combined bias), bias_hh = 0

The AST tier has no ``.pth`` export in the JAX package, so its state_dict
names are the port's own: the flax tree's paths joined by dots
(``dec0.self_attn.q``, ``enc0.LayerNorm_0``, ``frame_head``, ...), with
Dense ``kernel`` (I,O) -> ``weight`` (O,I), ``bias`` -> ``bias``, LayerNorm
``scale`` -> ``weight`` and Embed ``embedding`` -> ``weight``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch
import torch.nn as nn

from music_transcription_tpu_torch.config import ModelConfig


def _put_conv(out: dict, name: str, tree) -> None:
    out[f"{name}.weight"] = np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1))
    out[f"{name}.bias"] = np.asarray(tree["bias"])


def _put_bn(out: dict, name: str, ptree, stree) -> None:
    """A flax BatchNorm's params (and, unless ``stree`` is None, its
    batch_stats) as BatchNorm2d entries."""
    out[f"{name}.weight"] = np.asarray(ptree["scale"])
    out[f"{name}.bias"] = np.asarray(ptree["bias"])
    if stree is None:
        return
    out[f"{name}.running_mean"] = np.asarray(stree["mean"])
    out[f"{name}.running_var"] = np.asarray(stree["var"])
    out[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)


def _res_block_arrays(p, s) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    names = [("conv1", "bn1", "conv1", "bn1"), ("conv2", "bn2", "conv2", "bn2")]
    if "skip_conv" in p:  # C_in != C_out; else the skip is x itself
        names.append(("skip_conv", "skip_bn", "skip.0", "skip.1"))
    for conv, bn, conv_name, bn_name in names:
        _put_conv(out, conv_name, p[conv])
        _put_bn(out, bn_name, p[bn], None if s is None else s[bn])
    return out


def res_block_state_dict_from_jax(block: dict) -> dict[str, torch.Tensor]:
    """One JAX ``ResidualBlock``'s ``{"params", "batch_stats"}`` (numpy
    leaves; without ``batch_stats`` the running statistics are left out) ->
    the port ``ResidualBlock``'s state_dict. A block without ``skip_conv``
    (C_in == C_out) has no ``skip.*`` entries."""
    arrays = _res_block_arrays(block["params"], block.get("batch_stats"))
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def _put_flax_tree(out: dict, prefix: str, tree) -> None:
    """A flax params tree by its own paths (the AST mapping above)."""
    for key, node in tree.items():
        if hasattr(node, "items"):
            _put_flax_tree(out, f"{prefix}{key}.", node)
        elif key == "kernel":
            out[f"{prefix}weight"] = np.asarray(node).T
        elif key in ("scale", "embedding"):
            out[f"{prefix}weight"] = np.asarray(node)
        elif key == "bias":
            out[f"{prefix}bias"] = np.asarray(node)
        else:
            raise ValueError(f"no mapping for the flax leaf {prefix}{key}")


def state_dict_from_jax(variables: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX variables tree (numpy leaves) -> the port module's state_dict
    (keys without the ``model.`` prefix). Without ``batch_stats`` the
    BatchNorm running statistics are left out. For ``model_type="ast"`` the
    tree may be an ``ASTTranscriber``'s or an ``ASTEncoderPretrainer``'s."""
    p = variables["params"]
    s = variables.get("batch_stats")
    out: dict[str, np.ndarray] = {}

    def put_bn(name, *path):
        ptree, stree = p, s
        for key in path:
            ptree = ptree[key]
            stree = None if stree is None else stree[key]
        _put_bn(out, name, ptree, stree)

    def put_dense(name, tree):
        out[f"{name}.weight"] = np.asarray(tree["kernel"]).T
        out[f"{name}.bias"] = np.asarray(tree["bias"])

    def put_lstm(name, tree, num_layers):
        for li in range(num_layers):
            for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
                out[f"{name}.weight_ih_l{li}{sfx}"] = np.asarray(tree[f"l{li}_wi_{d}"]).T
                out[f"{name}.weight_hh_l{li}{sfx}"] = np.asarray(tree[f"l{li}_wh_{d}"]).T
                b = np.asarray(tree[f"l{li}_b_{d}"])
                out[f"{name}.bias_ih_l{li}{sfx}"] = b
                out[f"{name}.bias_hh_l{li}{sfx}"] = np.zeros_like(b)

    if cfg.model_type == "cnn_rnn":
        _put_conv(out, "cnn.0", p["block1"]["conv"])
        put_bn("cnn.1", "block1", "bn")
        _put_conv(out, "cnn.4", p["block2"]["conv"])
        put_bn("cnn.5", "block2", "bn")
        put_lstm("rnn", p["rnn"], cfg.num_layers)
        put_dense("fc", p["fc"])
    elif cfg.model_type == "cnn_rnn_large":
        _put_conv(out, "conv1.0", p["conv1"]["conv"])
        put_bn("conv1.1", "conv1", "bn")
        for rb in ("res_block1", "res_block2"):
            block = _res_block_arrays(p[rb], None if s is None else s[rb])
            out.update((f"{rb}.{k}", v) for k, v in block.items())
        _put_conv(out, "freq_aware_conv.0", p["freq_aware_conv"]["conv"])
        put_bn("freq_aware_conv.1", "freq_aware_conv", "bn")
        put_lstm("rnn_main", p["rnn_main"], cfg.num_layers)
        put_lstm("rnn_local", p["rnn_local"], 1)
        if cfg.use_attention:
            put_dense("attention.qkv", p["attention"]["qkv"])
            put_dense("attention.proj", p["attention"]["proj"])
            out["attention_norm.weight"] = np.asarray(p["attention_norm"]["scale"])
            out["attention_norm.bias"] = np.asarray(p["attention_norm"]["bias"])
        if cfg.use_onset_offset_heads:
            put_dense("shared_fc", p["shared_fc"])
            for head in ("frame_head", "onset_head", "offset_head"):
                put_dense(head, p[head])
        else:
            put_dense("fc", p["fc"])
    elif cfg.is_ast:
        _put_flax_tree(out, "", p)
    else:
        raise ValueError(f"No weight mapping for model type {cfg.model_type}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def optimizer_state_from_jax(opt_state, cfg: ModelConfig,
                             module: nn.Module) -> dict[nn.Parameter, dict]:
    """optax's Adam state (the ``mu``, ``nu`` and ``count`` of the
    ``scale_by_adam`` link anywhere in the chain's state, numpy-convertible
    leaves) -> ``torch.optim.Adam`` per-parameter state for ``module``'s
    parameters: ``optimizer.state.update(optimizer_state_from_jax(...))``."""
    def find(node):
        if all(hasattr(node, a) for a in ("mu", "nu", "count")):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                hit = find(child)
                if hit is not None:
                    return hit
        return None

    adam = find(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the optax state")
    mu = state_dict_from_jax({"params": adam.mu}, cfg)
    nu = state_dict_from_jax({"params": adam.nu}, cfg)
    step = torch.tensor(float(np.asarray(adam.count)))
    return {param: {"step": step.clone(), "exp_avg": mu[name].clone(),
                    "exp_avg_sq": nu[name].clone()}
            for name, param in module.named_parameters()}


def load_torch_checkpoint(path, module: nn.Module) -> nn.Module:
    """Load a ``.pth`` state_dict into ``module`` (strict), stripping the
    ``module.`` / ``model.`` prefixes of wrapped checkpoints."""
    sd = torch.load(path, map_location="cpu")
    for key in ("model_state", "state_dict"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
    sd = {k.removeprefix("module.").removeprefix("model."): v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module


def write_sidecar(path, sidecar: dict) -> None:
    """``X.json`` beside ``X.pth`` / ``X.pt``."""
    with open(os.path.splitext(str(path))[0] + ".json", "w") as f:
        json.dump(sidecar, f)


def save_training_checkpoint(path, model_state: dict, optimizer_state: dict, step: int,
                             dropout_seed: int, sidecar: dict) -> str:
    """Everything a resume needs, in one ``.pt``, and its sidecar: the
    module's state_dict and plain Adam's optimizer state_dict, whole (a
    sharded run gathers them first: ``parallel/partitioning.py``)."""
    torch.save({"model_state": model_state, "optimizer_state": optimizer_state,
                "step": step, "dropout_seed": dropout_seed}, path)
    write_sidecar(path, sidecar)
    return str(path)


def load_training_checkpoint(path, module: nn.Module, optimizer) -> int:
    """Restore a ``.pt`` training checkpoint into ``module`` and
    ``optimizer`` (strict) and return its step. A bare ``.pth`` (model_best)
    restores the weights only, with the step from its sidecar: a partial
    resume, the optimizer starting fresh."""
    ckpt = torch.load(path, map_location="cpu")
    if "optimizer_state" in ckpt:
        module.load_state_dict(ckpt["model_state"], strict=True)
        optimizer.load_state_dict(ckpt["optimizer_state"])
        return int(ckpt["step"])
    load_torch_checkpoint(path, module)
    with open(os.path.splitext(str(path))[0] + ".json") as f:
        return int(json.load(f).get("step", 0))


def epoch_from_checkpoint_name(name) -> int | None:
    """The epoch number in a checkpoint's file name (``model_epoch_7.pt`` -> 7)."""
    m = re.search(r"epoch[_\-](\d+)", os.path.basename(str(name)))
    return int(m.group(1)) if m else None


def latest_resumable_checkpoint(run_dir) -> str | None:
    """The target of ``--resume auto``: the highest-numbered
    ``checkpoints/model_epoch_N.pt`` (exact resume), else
    ``checkpoints/model_best.pth`` (partial resume), else None."""
    ckpt_dir = os.path.join(str(run_dir), "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    best_n, best_path = -1, None
    for name in os.listdir(ckpt_dir):
        n = epoch_from_checkpoint_name(name)
        if name.startswith("model_epoch_") and name.endswith(".pt") and n is not None and n > best_n:
            best_n, best_path = n, os.path.join(ckpt_dir, name)
    if best_path is not None:
        return best_path
    best = os.path.join(ckpt_dir, "model_best.pth")
    return best if os.path.exists(best) else None
