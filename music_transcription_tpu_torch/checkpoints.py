"""Checkpoints: reference-format ``.pth`` load and the JAX weight mapping.

``load_torch_checkpoint`` loads a bare ``state_dict`` ``.pth`` (the
reference's format, and what the JAX package's ``save_torch_checkpoint``
writes) into a port module. ``state_dict_from_jax`` carries the JAX
package's weights across: it takes the ``{"params", "batch_stats"}`` tree as
numpy arrays and returns the port's state_dict. It is the port's own copy of
the mapping in the JAX package's ``export_torch_state_dict``:

  flax (JAX package)                       torch (this package)
  ------------------                       --------------------
  {name}/conv kernel (kh,kw,I,O)        -> Conv2d weight (O,I,kh,kw)
  {name}/bn scale/bias, mean/var        -> BatchNorm2d weight/bias, running_mean/var
  Dense kernel (I,O)                    -> Linear weight (O,I)
  l{k}_wi_fwd|bwd (I,4H)                -> weight_ih_l{k}[_reverse] (4H,I)
  l{k}_wh_fwd|bwd (H,4H)                -> weight_hh_l{k}[_reverse] (4H,H)
  l{k}_b_fwd|bwd combined bias          -> bias_ih (the combined bias), bias_hh = 0
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from music_transcription_tpu_torch.config import ModelConfig


def state_dict_from_jax(variables: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX variables tree (numpy leaves) -> the port module's state_dict
    (keys without the ``model.`` prefix)."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}

    def put_conv(name, tree):
        out[f"{name}.weight"] = np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1))
        out[f"{name}.bias"] = np.asarray(tree["bias"])

    def put_bn(name, ptree, stree):
        out[f"{name}.weight"] = np.asarray(ptree["scale"])
        out[f"{name}.bias"] = np.asarray(ptree["bias"])
        out[f"{name}.running_mean"] = np.asarray(stree["mean"])
        out[f"{name}.running_var"] = np.asarray(stree["var"])
        out[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)

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
        put_conv("cnn.0", p["block1"]["conv"])
        put_bn("cnn.1", p["block1"]["bn"], s["block1"]["bn"])
        put_conv("cnn.4", p["block2"]["conv"])
        put_bn("cnn.5", p["block2"]["bn"], s["block2"]["bn"])
        put_lstm("rnn", p["rnn"], cfg.num_layers)
        put_dense("fc", p["fc"])
    elif cfg.model_type == "cnn_rnn_large":
        put_conv("conv1.0", p["conv1"]["conv"])
        put_bn("conv1.1", p["conv1"]["bn"], s["conv1"]["bn"])
        for rb in ("res_block1", "res_block2"):
            put_conv(f"{rb}.conv1", p[rb]["conv1"])
            put_bn(f"{rb}.bn1", p[rb]["bn1"], s[rb]["bn1"])
            put_conv(f"{rb}.conv2", p[rb]["conv2"])
            put_bn(f"{rb}.bn2", p[rb]["bn2"], s[rb]["bn2"])
            put_conv(f"{rb}.skip.0", p[rb]["skip_conv"])
            put_bn(f"{rb}.skip.1", p[rb]["skip_bn"], s[rb]["skip_bn"])
        put_conv("freq_aware_conv.0", p["freq_aware_conv"]["conv"])
        put_bn("freq_aware_conv.1", p["freq_aware_conv"]["bn"], s["freq_aware_conv"]["bn"])
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
    else:
        raise ValueError(f"No weight mapping for model type {cfg.model_type}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


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
