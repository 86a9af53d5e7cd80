"""Bidirectional multi-layer LSTM with both directions fused into one
recurrence, as in the JAX package's ``ops/lstm.py``.

  * The input projection ``x @ W_ih + b`` for all timesteps is one large
    matmul per direction, hoisted out of the recurrence; it runs in
    ``proj_dtype`` (bf16 in the default model) with fp32 accumulation.
  * The backward direction's projections are time-reversed and stacked on
    the batch axis (2B rows), so one recurrence serves both directions.
  * Gate order is torch's (i, f, g, o) and the bias is ``b_ih + b_hh``.
  * The recurrence itself is fp32 and is a parameter: the K1 wrapper
    ``ops.lstm_kernel.lstm_recurrence`` (default) or its plain version.

Parameters of one layer are a dict in the JAX package's layout:
  {"wi_fwd": (I, 4H), "wh_fwd": (H, 4H), "b_fwd": (4H,),
   "wi_bwd": ..., "wh_bwd": ..., "b_bwd": ...}
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from music_transcription_tpu_torch.ops.lstm_kernel import lstm_recurrence
from music_transcription_tpu_torch.ops.precision import matmul_f32


def fused_direction_inputs(
    x: torch.Tensor, layer_params: dict, proj_dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, I) -> xw (2B, T, 4H) fp32 [forward; time-reversed backward]
    and wh (2, H, 4H) fp32, the stacked recurrent weights."""
    b, t, i = x.shape
    x2 = x.reshape(b * t, i).to(proj_dtype)

    def proj(w, bias):
        return (matmul_f32(x2, w.to(proj_dtype)) + bias).view(b, t, -1)

    xw_f = proj(layer_params["wi_fwd"], layer_params["b_fwd"])
    xw_b = proj(layer_params["wi_bwd"], layer_params["b_bwd"])
    xw = torch.cat([xw_f, torch.flip(xw_b, dims=(1,))], dim=0)
    wh = torch.stack([layer_params["wh_fwd"], layer_params["wh_bwd"]]).float()
    return xw, wh


def split_direction_outputs(hs: torch.Tensor, b: int) -> torch.Tensor:
    """(2B, T, H) fused recurrence output -> (B, T, 2H) in torch order
    [forward_h, backward_h], un-reversing the backward half."""
    return torch.cat([hs[:b], torch.flip(hs[b:], dims=(1,))], dim=-1)


def bilstm_layer(x: torch.Tensor, layer_params: dict, proj_dtype=torch.float32,
                 recurrence=lstm_recurrence) -> torch.Tensor:
    """One bidirectional layer: (B, T, I) -> (B, T, 2H)."""
    xw, wh = fused_direction_inputs(x, layer_params, proj_dtype)
    return split_direction_outputs(recurrence(xw, wh), x.shape[0])


def bilstm_stack(
    x: torch.Tensor,
    layers: list[dict],
    *,
    dropout_rate: float = 0.0,
    training: bool = False,
    proj_dtype=torch.float32,
    recurrence=lstm_recurrence,
) -> torch.Tensor:
    """Multi-layer BiLSTM with torch inter-layer dropout semantics (dropout
    on each layer's output except the last, in training only)."""
    out = x
    for li, params in enumerate(layers):
        out = bilstm_layer(out, params, proj_dtype=proj_dtype, recurrence=recurrence)
        if dropout_rate > 0.0 and training and li < len(layers) - 1:
            out = F.dropout(out, dropout_rate, training=True)
    return out
