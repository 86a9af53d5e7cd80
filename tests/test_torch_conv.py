"""PyTorch port: K5 (fused ConvBNRelu [+ (2, 1) max-pool]) against the JAX
package's ``fused_conv_bn_relu`` run in Pallas interpret mode, on the CPU,
where the port's wrapper takes its plain version.

Both sum the exact products of bf16 values in fp32, in different orders, so
a sum that lands next to a bf16 rounding boundary can come out one bf16 unit
apart, before the BatchNorm affine or at the output: at least 99% of the
elements must be the same bits, every element within 2^-7 of the
reference's largest magnitude, and within ``k5_score``'s element-wise bound.
The port's NCHW output is transposed to NHWC for the comparison.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_transcription_tpu.ops.conv_pallas import fused_conv_bn_relu as jax_fused_conv_bn_relu
from music_transcription_tpu.train.checkpoints import load_checkpoint
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.ops import conv_kernel as CK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "demo_checkpoint")


def _stage_inputs(seed, b, c_in, c_out, f, t, kh, kw):
    """NHWC x, the flax kernel (kh, kw, C_in, C_out), the conv bias and BN
    scale, bias, mean (0.3 N) and variance (|N| + 0.5)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, f, t, c_in)).astype(np.float32)
    kernel = (rng.standard_normal((kh, kw, c_in, c_out)) / np.sqrt(kh * kw * c_in)).astype(np.float32)
    vecs = [(0.3 * rng.standard_normal(c_out)).astype(np.float32) for _ in range(4)]
    var = (np.abs(rng.standard_normal(c_out)) + 0.5).astype(np.float32)
    return x, kernel, *vecs, var


def _jax_k5(x_nhwc, kernel, conv_bias, scale, bias, mean, var, pool, f_blk=None):
    out = jax_fused_conv_bn_relu(
        jnp.asarray(x_nhwc).astype(jnp.bfloat16),
        *(jnp.asarray(a) for a in (kernel, conv_bias, scale, bias, mean, var)),
        pool=pool, f_blk=f_blk, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _assert_close(got, ref, args=None, pool=False):
    """``args`` (x, weight, conv bias, BN scale, bias, mean, variance), when
    given, add ``k5_score``'s element-wise bound."""
    if args is not None:
        assert CK.k5_score(got, _nchw(ref), args, pool=pool) <= 1.0
    got = got.float().numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape
    assert float(np.mean(got == ref)) >= 0.99
    assert float(np.abs(got - ref).max()) <= 2.0**-7 * float(np.abs(ref).max())


@pytest.mark.parametrize("b,c_in,c_out,f,t,kh,kw,pool,f_blk", [
    (2, 1, 8, 16, 20, 3, 3, True, 4),       # tests/test_conv_pallas.py's shapes
    (2, 1, 8, 16, 20, 3, 3, False, 4),
    (2, 12, 16, 8, 20, 7, 3, False, 4),
    (1, 1, 32, 320, 24, 3, 3, True, None),  # the 89M model's conv1 + pool
    (1, 128, 256, 80, 24, 7, 3, True, None),  # and its freq_aware_conv + pool
], ids=["3x3-1to8-pool", "3x3-1to8", "7x3-12to16", "conv1-89M", "freq_aware_conv-89M"])
def test_k5_matches_jax(b, c_in, c_out, f, t, kh, kw, pool, f_blk):
    x, kernel, conv_bias, scale, bias, mean, var = _stage_inputs(c_in + f, b, c_in, c_out, f, t, kh, kw)
    ref = _jax_k5(x, kernel, conv_bias, scale, bias, mean, var, pool, f_blk)
    weight = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    args = (_nchw(x), weight, *(torch.from_numpy(v) for v in (conv_bias, scale, bias, mean, var)))
    before = CK.fused_conv_bn_relu.launches
    got = CK.fused_conv_bn_relu(*args, pool=pool)
    assert got.dtype == torch.bfloat16
    assert CK.fused_conv_bn_relu.launches == before  # a CPU tensor: the plain version
    _assert_close(got, ref, args, pool)


@pytest.mark.parametrize("fault", CK.FAULTS)
@pytest.mark.parametrize("c_in,c_out,f,kh", [(1, 32, 320, 3), (128, 256, 80, 7)],
                         ids=["conv1-89M", "freq_aware_conv-89M"])
def test_k5_bound_catches_faults(fault, c_in, c_out, f, kh):
    """Each faulty output ``faulty_plain`` builds fails ``k5_score``'s bound at
    the 89M stages' widths (B=1, T=24, pool), which the plain version meets.
    The walk's faults (a stale weight stage, the x-row ring one step off, a
    segment border's halo rows read as zeros; on the walk's 8-row segments
    at this shape) belong to the tensor-core kernel only."""
    if fault in CK.K5_WALK_FAULTS and c_in < 16:
        pytest.skip("conv1 (C_in = 1) runs the CUDA-core kernel, which has no weight stages, "
                    "x-row ring or segments")
    x, kernel, *vecs = _stage_inputs(c_in + f, 1, c_in, c_out, f, 24, kh, 3)
    args = (_nchw(x), torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
            *(torch.from_numpy(v) for v in vecs))
    ref = CK.fused_conv_bn_relu_plain(*args, pool=True)
    assert CK.k5_score(ref, ref, args, pool=True) == 0.0
    assert CK.k5_score(CK.faulty_plain(args, fault, pool=True), ref, args, pool=True) > 1.0


@pytest.mark.parametrize("b,f,t,rows", [(4, 80, 938, 40), (1, 80, 24, 8), (1, 20, 130, 8),
                                         (64, 80, 938, 80)])
def test_k5_segment_rows(b, f, t, rows):
    """The walk's segment height on 132 SMs: at freq_aware_conv (B=4, T=938:
    15 strips x 4 images) 2 segments of 40 rows, 120 blocks; a few strips
    take segments of the least 8 rows (F=20: 8 + 8 + 4); strips enough to
    fill the card one segment."""
    assert CK.k5_segment_rows(b, f, t, 132) == rows


@pytest.mark.parametrize("c_in,kh,fits", [(128, 7, True), (128, 3, True), (160, 7, True),
                                          (176, 7, False), (256, 7, False), (256, 3, True)])
def test_k5_shared_memory_limit(c_in, kh, fits):
    """The walk's least shared memory (x ring, affines, one weight stage) at
    C_out 256: 128 input channels fit at freq_aware_conv's 7 rows of taps
    (KH + 3 = 10 ring rows of 66 pixels), 176 or more do not, and the
    wrapper refuses those; 3 rows of taps leave room for 256."""
    assert CK._k5_tensor_cores(c_in, 256, kh, 3)
    assert (CK._k5_smem_bytes(c_in, 256, kh, 3) <= CK.K5_SMEM_LIMIT) == fits


def test_k5_traffic_at_the_89m_stages():
    """freq_aware_conv (B=4, T=938, 132 SMs): the walk reads its 1.38 MB of
    weights from L2 once a step of 4 x 64 outputs, 1.65 GB a call (at most
    1.8 GB; 2 x 64 tiles read 3.30 GB), and gathers x about once (at most
    1.5 times the input: a segment's 6 halo rows and a strip's 2 halo
    columns). conv1 takes the CUDA-core chunks: its weights are 1.15 KB a
    block, its input windows some 5 times the input (10 columns and 4 rows
    of a window for 8 x 2 outputs of 16 channels, 2 windows for 32)."""
    tc = CK.k5_traffic(4, 128, 256, 80, 938, 7, 3, True, 132)
    assert tc["weights_l2"] == 60 * 20 * 4 * 8 * 21 * 64 * 32 <= 1.8e9
    assert tc["x_gathered"] <= 1.5 * tc["x_bytes"]
    cc = CK.k5_traffic(4, 1, 32, 320, 938, 3, 3, True, 132)
    assert cc["weights_l2"] == 3 * 132 * 4 * 32 * 9
    assert 4 * cc["x_bytes"] < cc["x_gathered"] < 6 * cc["x_bytes"]


@pytest.fixture(scope="module")
def demo():
    """The demo checkpoint (cnn_rnn, n_mels 48): its orbax variables and the
    port model loaded from them through state_dict_from_jax."""
    with open(os.path.join(CKPT, "config.json")) as f:
        cfg = ModelConfig(**json.load(f)["model"])
    variables = load_checkpoint(CKPT)
    model = TranscriptionModel(cfg)
    model.model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return variables, model.model.eval()


def test_k5_on_demo_checkpoint_stages_matches_jax(demo):
    """block1 (1 -> 32, F=48) and block2 (32 -> 64, F=24), each + pool, through
    ``conv_bn_relu_stage`` on the port model's modules against JAX's kernel on
    the orbax variables; block2's input is JAX's block1 output."""
    variables, model = demo
    p, stats = variables["params"], variables["batch_stats"]
    x = np.random.default_rng(7).standard_normal((2, 48, 30, 1)).astype(np.float32) * 10.0 - 40.0
    for name, conv, bn in (("block1", model.cnn[0], model.cnn[1]), ("block2", model.cnn[4], model.cnn[5])):
        ref = _jax_k5(x, p[name]["conv"]["kernel"], p[name]["conv"]["bias"], p[name]["bn"]["scale"],
                      p[name]["bn"]["bias"], stats[name]["bn"]["mean"], stats[name]["bn"]["var"], True)
        got = CK.conv_bn_relu_stage(_nchw(x), conv, bn, pool=True)
        _assert_close(got, ref)
        x = ref  # bf16 values held in fp32


@pytest.mark.parametrize("f,pool", [(15, False), (18, True)], ids=["F-odd", "F-not-4-with-pool"])
def test_k5_raises_where_jax_raises(f, pool):
    x, kernel, *vecs = _stage_inputs(0, 1, 1, 4, f, 6, 3, 3)
    with pytest.raises(ValueError):
        _jax_k5(x, kernel, *vecs, pool)
    weight = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    with pytest.raises(ValueError):
        CK.fused_conv_bn_relu(_nchw(x), weight, *(torch.from_numpy(v) for v in vecs), pool=pool)


def test_front_end_through_k5_matches_the_model():
    """chip_smoke.py's front-end check on the CPU: the 89M model's widths
    (n_mels 320) at T=40, seeded weights and BatchNorm statistics (variance
    |N| + 0.5, the rest 0.3 N), ``cnn_features`` with both ConvBNRelu stages
    through K5's plain version against the model's own, to FRONT_END_TOL."""
    torch.manual_seed(3)
    model = TranscriptionModel(ModelConfig()).model.eval()
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.running_var.copy_(torch.from_numpy(np.abs(rng.standard_normal(bn.num_features)) + 0.5))
            for v in (bn.running_mean, bn.weight, bn.bias):
                v.copy_(torch.from_numpy(0.3 * rng.standard_normal(bn.num_features)))
    x = torch.from_numpy(rng.standard_normal((1, 1, 320, 40)).astype(np.float32) * 10.0 - 40.0)

    def k5_stage(h, conv, bn, dt):
        return CK.conv_bn_relu_stage(h, conv, bn, pool=True)

    with torch.no_grad():
        got = model.cnn_features(x, stage=k5_stage).float()
        ref = model.cnn_features(x).float()
    assert got.shape == ref.shape == (1, 256, 40, 40)
    err = (got - ref).abs()
    assert float(err.max()) <= CK.FRONT_END_TOL["max"] * float(ref.abs().max())
    assert float(err.pow(2).mean().sqrt()) <= CK.FRONT_END_TOL["rms"] * float(ref.pow(2).mean().sqrt())
