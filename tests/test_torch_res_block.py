"""PyTorch port: K6 (fused ResidualBlock [+ (2, 1) max-pool]) against the
JAX package's ``fused_res_block`` run in Pallas interpret mode, on the CPU,
where the port's wrapper takes its plain version; the repaired port
``ResidualBlock`` against JAX's; the CNN front end through K5 and K6.

The weights are flax's initialisation with BatchNorm statistics made
non-trivial (``tests/test_conv_pallas.py``'s ``_randomize_bn``: variance
|N| + 0.5, the rest 0.3 N, here from a numpy generator), carried to the port
by ``res_block_state_dict_from_jax``. Both versions sum the exact products of
bf16 values in fp32, in different orders, and round where the Pallas kernel
rounds, so an output element may differ only where a sum lands next to a
bf16 rounding boundary: every element must lie within ``k6_score``'s bound,
at least 99% be the same bits, and each within 2^-7 of the reference's
largest magnitude (a bf16 unit of it: what a flip of one rounding carried
through the block's sums comes to at most, at these widths). The port's NCHW
output is transposed to NHWC for the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_transcription_tpu.models.cnn_rnn import ResidualBlock as JaxResidualBlock
from music_transcription_tpu.ops.conv_pallas import fused_res_block as jax_fused_res_block
from music_transcription_tpu_torch.checkpoints import res_block_state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig
from music_transcription_tpu_torch.models.cnn_rnn import ResidualBlock
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.ops import conv_kernel as CK


def _randomize_bn(variables, rng):
    """flax variables as numpy, the batch_stats drawn anew: var |N| + 0.5,
    mean 0.3 N."""
    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                (np.abs(rng.standard_normal(v.shape)) + 0.5 if k == "var"
                 else 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    return {"params": jax.tree.map(np.asarray, dict(variables["params"])),
            "batch_stats": draw(dict(variables["batch_stats"]))}


def _block(seed, b, c_in, c_out, f, t, x=None):
    """NHWC x (bf16 values), the JAX block's variables and the port block
    holding the same weights (eval mode)."""
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.standard_normal((b, f, t, c_in)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    jax_block = JaxResidualBlock(c_out, dtype=jnp.bfloat16)
    variables = _randomize_bn(jax_block.init(jax.random.key(seed), jnp.asarray(x, jnp.bfloat16),
                                             train=True), rng)
    block = ResidualBlock(c_in, c_out)
    block.load_state_dict(res_block_state_dict_from_jax(variables), strict=True)
    return x, variables, block.eval()


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _jax_k6(x, variables, pool, f_blk=None):
    out = jax_fused_res_block(jnp.asarray(x).astype(jnp.bfloat16), variables, pool=pool,
                              f_blk=f_blk, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _assert_close(got, ref, args, pool):
    ref_t = _nchw(ref)
    assert tuple(got.shape) == tuple(ref_t.shape)
    assert CK.k6_score(got, ref_t, args, pool=pool) <= 1.0
    got = got.float()
    assert float((got == ref_t).float().mean()) >= 0.99
    assert float((got - ref_t).abs().max()) <= 2.0**-7 * float(ref_t.abs().max())


@pytest.mark.parametrize("b,c_in,c_out,f,t,pool,f_blk,constant", [
    (2, 8, 16, 16, 20, True, 4, False),     # tests/test_conv_pallas.py: skip + pool
    (2, 16, 16, 16, 20, False, 4, False),   # identity
    (1, 4, 4, 8, 36, False, 4, True),       # edge zeroing: constant input
    (1, 32, 64, 160, 24, True, None, False),  # the 89M model's res_block1 + pool
    (1, 64, 128, 80, 24, False, None, False),  # and its res_block2
], ids=["skip-pool-8to16", "identity-16", "edge-zeroing-4", "res_block1-89M", "res_block2-89M"])
def test_k6_matches_jax(b, c_in, c_out, f, t, pool, f_blk, constant):
    x0 = np.ones((b, f, t, c_in), np.float32) if constant else None
    x, variables, block = _block(c_in + f, b, c_in, c_out, f, t, x0)
    ref = _jax_k6(x, variables, pool, f_blk)
    args = (_nchw(x), *CK.res_block_args(block))
    before = CK.fused_res_block.launches
    got = CK.res_block_stage(args[0], block, pool=pool)
    assert got.dtype == torch.bfloat16
    assert CK.fused_res_block.launches == before  # a CPU tensor: the plain version
    assert (block.skip is None) == (c_in == c_out) == (len(args) == 13)
    _assert_close(got, ref, args, pool)


@pytest.mark.parametrize("f,pool", [(15, False), (18, True)], ids=["F-odd", "F-not-4-with-pool"])
def test_k6_raises_where_jax_raises(f, pool):
    x, variables, block = _block(0, 1, 4, 8, f, 6)
    with pytest.raises(ValueError):
        _jax_k6(x, variables, pool)
    with pytest.raises(ValueError):
        CK.res_block_stage(_nchw(x), block, pool=pool)


def test_identity_residual_block_matches_jax():
    """The port's ResidualBlock(16, 16) has no skip and adds x itself, as
    JAX's ResidualBlock(16) does: eval mode, bf16 compute, the same
    rounding points, so the same bits but where a sum's order moves one."""
    x, variables, block = _block(5, 2, 16, 16, 16, 20)
    assert block.skip is None and not any(k.startswith("skip") for k in block.state_dict())
    ref = np.asarray(JaxResidualBlock(16, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x, jnp.bfloat16), train=False).astype(jnp.float32))
    with torch.no_grad():
        got = block(_nchw(x).to(torch.bfloat16), torch.bfloat16).float()
    ref = _nchw(ref)
    assert float((got == ref).float().mean()) >= 0.99
    assert float((got - ref).abs().max()) <= 2.0**-7 * float(ref.abs().max())


@pytest.mark.parametrize("fault", CK.FAULTS_K6)
@pytest.mark.parametrize("c_in,c_out,f,pool", [(32, 64, 160, True), (64, 128, 80, False)],
                         ids=["res_block1-89M", "res_block2-89M"])
def test_k6_bound_catches_faults(fault, c_in, c_out, f, pool):
    """Each faulty output ``faulty_plain_k6`` builds fails ``k6_score``'s
    bound at the 89M blocks' widths (B=1, T=24: the walk's faults on
    segments of 8 rows), which the plain version meets."""
    x, _, block = _block(c_in + f, 1, c_in, c_out, f, 24)
    args = (_nchw(x), *CK.res_block_args(block))
    ref = CK.fused_res_block_plain(*args, pool=pool)
    assert CK.k6_score(ref, ref, args, pool=pool) == 0.0
    assert CK.k6_score(CK.faulty_plain_k6(args, fault, pool=pool), ref, args, pool=pool) > 1.0


@pytest.mark.parametrize("c_in,c_out,f", [(32, 64, 160), (64, 128, 80)],
                         ids=["res_block1-89M", "res_block2-89M"])
def test_k6_walk_computes_few_h1_rows_again(c_in, c_out, f):
    """At the 30 s route's shape (B=4, T=938) on an H100's 132 SMs, K6's walk
    takes 2 segments (80 and 40 rows), and conv1 executes at most 1.15 times
    the work of computing every h1 pixel of the tensor once (the halo
    columns of each strip and the 2 h1 rows a segment computes again)."""
    assert CK.k6_segment_rows(4, f, 938) == f // 2
    work = CK.k6_work(4, c_in, c_out, c_out, f, 938, skip=True)
    assert 1.0 < work["conv1_executed"] / work["conv1_useful"] <= 1.15
    assert work["conv1_useful"] < work["useful"] < work["executed"]


def test_k6_segment_rows():
    """Segments fill the SMs (one block an SM), are even, at least 8 rows,
    and no taller than F."""
    assert CK.k6_segment_rows(4, 70, 938) == 36  # 64 strips x 2 segments; 36 + 34 rows
    assert CK.k6_segment_rows(1, 52, 200) == 8  # 4 strips: 33 segments wanted, 8 rows at least
    assert CK.k6_segment_rows(1, 4, 20) == 4  # F under 8 rows: one segment
    assert CK.k6_segment_rows(64, 80, 938) == 80  # 1024 strips: one segment
    assert CK.k6_segment_rows(4, 80, 938, sms=114) == 80


def test_k6_shared_memory_limit():
    """The 89M blocks and the identity block fit in K6's shared memory; rings
    of 256 channels do not (the wrapper raises on them)."""
    for c_in, c_mid, c_out in ((32, 64, 64), (64, 128, 128), (64, 64, 64), (16, 256, 256)):
        assert CK._k6_smem_bytes(c_in, c_mid, c_out) <= CK.K6_SMEM_LIMIT
    assert CK._k6_smem_bytes(256, 256, 256) > CK.K6_SMEM_LIMIT


def test_front_end_through_k5_and_k6_matches_the_model():
    """chip_smoke.py's front-end check on the CPU: the 89M model's widths
    (n_mels 320) at T=40, seeded weights and BatchNorm statistics,
    ``cnn_features`` with both ConvBNRelu stages through K5's plain version
    and both residual blocks through K6's against the model's own, to
    FRONT_END_TOL."""
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

    def k6_block(h, block, dt, pool):
        return CK.res_block_stage(h, block, pool=pool)

    with torch.no_grad():
        got = model.cnn_features(x, stage=k5_stage, block=k6_block).float()
        ref = model.cnn_features(x).float()
    assert got.shape == ref.shape == (1, 256, 40, 40)
    err = (got - ref).abs()
    assert float(err.max()) <= CK.FRONT_END_TOL["max"] * float(ref.abs().max())
    assert float(err.pow(2).mean().sqrt()) <= CK.FRONT_END_TOL["rms"] * float(ref.pow(2).mean().sqrt())


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """K5 and K6 include csrc/tile_mma.cuh: an edited header must give their
    libraries new names, so that a stale build is never loaded."""
    from music_transcription_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != before
