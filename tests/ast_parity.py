"""Shared set-up of the AST parity tests: one small AST model initialized by
the JAX package from a seed and carried into the port with
``state_dict_from_jax``, seeded waves and targets, and the near-tie rule for
bf16 tokens."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig
from music_transcription_tpu_torch.models.transcription import TranscriptionModel

# 2 layers x 32 wide, 4 heads, both towers; the real mel-patch encoder at 32
# mel bins; 1 s waves -> 32 mel frames -> 8 encoder tokens
SMALL = dict(model_type="ast", remi_vocab_size=512, decoder_layers=2, decoder_dim=32,
             decoder_heads=4, max_output_len=64, encoder_layers=2, encoder_dim=32,
             encoder_heads=4, encoder_n_mels=32, dropout=0.1)
# max |port - JAX| of logits and memory over their largest magnitude. fp32:
# summation order only. bf16: the two LayerNorms' sums differ in the last
# fp32 bit, so a bf16 cast downstream rounds some values to the neighbouring
# bf16 value (one bf16 ulp is 2^-8 relative)
REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}

# One Adam step of the AST training steps, port against JAX in fp32
# (tests/test_torch_train_ast_step.py, tests/test_torch_train_ast_encoder.py):
#   * LOSS_RTOL: |port - JAX| over |JAX| of the loss (fp32 summation order);
#   * GRAD_TOL: every gradient element within GRAD_TOL of the model's largest;
#   * the update bound (``update_ratio``): Adam's first step moves a parameter
#     by lr g / (|g| + eps), so a gradient error d (GRAD_TOL of the largest)
#     moves it by at most lr eps d / (|g| - d + eps)^2 where |g| > d, and by
#     up to 2 lr where it does not (the attention key biases, whose exact
#     gradient is 0: softmax does not see a shift of a whole row). optax
#     rounds its bias corrections 1 - beta^t in fp32 (0.999 is 0.99900001
#     there: 6.4e-6 in the square root of 1 - beta2), torch in double:
#     UPDATE_RTOL of lr. Four float32 spacings of the parameter cover the
#     roundings of the sum.
LR, EPS = 1e-4, 1e-8
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
UPDATE_RTOL = 2e-5

_CACHE = {}


def pair(dtype: str = "float32", **overrides):
    """(JAX model, its variables as numpy, the port's TranscriptionModel in
    eval mode holding the same weights), built once per configuration."""
    key = (dtype, tuple(sorted(overrides.items())))
    if key not in _CACHE:
        cfg = dict(SMALL, compute_dtype=dtype, **overrides)
        jm = JModel(JModelConfig(**cfg))
        init = jax.jit(jm.init)  # one compile; the forwards below run op by op, as
        # tests/test_ast.py runs them (closer to torch's rounding than a fused program)
        variables = jax.tree.map(np.asarray, init(jax.random.key(0), jnp.zeros((1, 16000))))
        pm = TranscriptionModel(ModelConfig(**cfg)).eval()
        pm.model.load_state_dict(state_dict_from_jax(variables, pm.config), strict=True)
        _CACHE[key] = (jm, variables, pm)
    return _CACHE[key]


def waves(batch: int = 2, seconds: float = 1.0, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((batch, int(16000 * seconds)))).astype(np.float32)


def targets(batch: int = 2, t: int = 24, seed: int = 1) -> np.ndarray:
    tg = np.random.default_rng(seed).integers(3, 512, (batch, t)).astype(np.int32)
    tg[:, 0] = 0  # <sos>
    return tg


def port(pm, wave: np.ndarray, **kwargs):
    """The port's forward on numpy inputs, as numpy."""
    kw = {k: torch.from_numpy(v).long() if isinstance(v, np.ndarray) else v
          for k, v in kwargs.items()}
    with torch.inference_mode():
        return pm(torch.from_numpy(wave), **kw).float().numpy()


def jax_out(jm, variables, wave: np.ndarray, **kwargs) -> np.ndarray:
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    return np.asarray(jm.apply(variables, jnp.asarray(wave), **kw)).astype(np.float32)


def step_logits(pm, wave: np.ndarray, tokens: np.ndarray, row: int, step: int,
                repetition_penalty: float = 0.0, allowed_next=None) -> np.ndarray:
    """The logits greedy decoding ranks at ``step`` of ``row`` after the
    prefix ``tokens[row, :step]``: the teacher-forced logits of <sos> + the
    prefix, with generation's SOS mask, grammar mask and repetition penalty."""
    seq = np.concatenate([[0], tokens[row, :step]]).astype(np.int64)[None]
    logits = port(pm, wave[row:row + 1], targets=seq)[0, step].astype(np.float64)
    if step > 0:
        logits[0] = -1e9
    if allowed_next is not None:
        logits = np.where(allowed_next[seq[0, -1]], logits, -1e9)
    if repetition_penalty:
        logits -= repetition_penalty * np.bincount(seq[0], minlength=logits.shape[0])
    return logits


def agree_up_to_near_tie(pm, wave, got: np.ndarray, ref: np.ndarray, tol: float,
                         **mask_kwargs) -> int:
    """Rows of ``got`` equal ``ref`` (JAX's tokens) up to their first
    difference, where the ranked logits' top-2 margin must fall below
    ``tol`` (a near-tie that either side may break). Returns the count of
    steps that agree."""
    agreed = 0
    for row in range(ref.shape[0]):
        diff = np.nonzero(got[row] != ref[row])[0]
        if diff.size == 0:
            agreed += ref.shape[1]
            continue
        step = int(diff[0])
        top2 = np.sort(step_logits(pm, wave, ref, row, step, **mask_kwargs))[-2:]
        assert top2[1] - top2[0] < tol, (
            f"row {row} departs from JAX at step {step} with a top-2 margin of "
            f"{top2[1] - top2[0]:.4g} >= {tol:.4g}")
        agreed += step
    return agreed


def jax_train_ast_script():
    """The JAX package's ``scripts/train_ast.py`` as a module (its
    ``build_parser``, ``main`` and ``transplant_encoder``), loaded once."""
    if "train_ast" not in _CACHE:
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "scripts", "train_ast.py")
        spec = importlib.util.spec_from_file_location("jax_train_ast", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CACHE["train_ast"] = mod
    return _CACHE["train_ast"]


def grad_err(grads: dict, ref: dict) -> float:
    """The largest gradient error over the model's largest gradient."""
    g_max = max(float(v.abs().max()) for v in ref.values())
    return max(float((grads[k] - ref[k]).abs().max()) for k in grads) / g_max


def update_ratio(module, before: dict, ref_grads: dict, ref_params: dict) -> float:
    """The largest |port - JAX| of ``module``'s parameters after one Adam
    step over its update bound (above)."""
    g_max = max(float(v.abs().max()) for v in ref_grads.values())
    d = GRAD_TOL * g_max
    worst = 0.0
    for k, p in module.named_parameters():
        g = ref_grads[k].double().abs()
        bound = torch.where(g > d, LR * (UPDATE_RTOL + EPS * d / (g - d + EPS) ** 2), 2 * LR)
        scale = torch.maximum(ref_params[k].abs(), before[k].abs()).numpy()
        bound = bound + 4 * torch.from_numpy(np.spacing(scale)).double()
        worst = max(worst, float(((p.detach() - ref_params[k]).abs() / bound).max()))
    return worst
