"""PyTorch port: the exact three-term bf16 split of an fp32 gradient
(``split_bf16``) and the backward of ``matmul_f32`` built on it
(``split_backward``, ``_TensorCoreMatmulF32``).

The split is held to reproduce the gradient bit for bit wherever bf16 can
hold its lowest bit, and to keep a non-finite gradient non-finite. The
backward's arrangement (the split shared, b repeated 3 times on the
contraction, ``a^T @ hi`` summed in runs of rows and ``a^T @ [lo | mid]``
added on) is run here with a widened fp32 product in place of the tensor
cores and held, against an fp64 product, to the error bound of an fp32 sum
of its terms, which the one-term backward (the gradient rounded to bf16)
misses.
The tensor-core products themselves are held to the fp32 path on the card
in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from music_transcription_tpu_torch.ops import precision as P

U = 2.0 ** -24  # fp32's unit roundoff
EXACT_FROM = 2.0 ** -110  # the least magnitude whose lowest bit bf16 holds


def _widened(x, y, acc=None):
    out = torch.matmul(x.float(), y.float())
    return out if acc is None else acc + out


def _terms(g):
    lo, mid, hi = P.split_bf16(g).float().split(g.shape[-1], dim=-1)
    return hi, mid, lo


def _bits(x):
    return (x + 0.0).view(torch.int32)  # + 0.0: -0 splits into -0, +0, +0, which sum to +0


def _gradient(case, rng):
    if case == "normal":
        return rng.standard_normal((6, 40)) * 10.0 ** rng.uniform(-30, 30, (6, 40))
    if case == "largest_finite":  # over bf16's largest value, where rounding to nearest gives inf
        top = np.finfo(np.float32).max
        return np.concatenate([[top, -top, np.nextafter(top, 0), 3.3961e38, -3.39e38],
                               top * rng.uniform(0.99, 1.0, 35)]).reshape(5, 8)
    if case == "edge_of_exactness":  # 2^-110 up to 2^-100
        return rng.choice([-1, 1], (4, 16)) * 2.0 ** rng.uniform(-110, -100, (4, 16))
    if case == "zeros":  # +0 and -0 among normal values
        pick = rng.random((4, 12))
        return np.where(pick < 0.35, 0.0, np.where(pick < 0.7, -0.0, rng.standard_normal((4, 12))))
    if case == "mixed_signs":  # each row cancels: large terms of both signs beside small ones
        g = rng.standard_normal((8, 32)) * 10.0 ** rng.integers(-6, 7, (8, 32))
        return np.concatenate([g, -g[:, ::-1] * (1 + 2.0 ** -20)], axis=1)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["normal", "largest_finite", "edge_of_exactness", "zeros",
                                  "mixed_signs"])
def test_split_reproduces_the_gradient_bit_for_bit(case):
    g = torch.from_numpy(_gradient(case, np.random.default_rng(len(case))).astype(np.float32))
    hi, mid, lo = _terms(g)
    assert torch.isfinite(hi).all() and torch.isfinite(mid).all() and torch.isfinite(lo).all()
    assert torch.equal(_bits((hi + mid) + lo), _bits(g))
    # each term keeps its share of the bits: |mid| <= 2^-7 |hi|, |lo| <= 2^-7 |mid|
    assert (mid.abs() <= 2.0 ** -7 * hi.abs()).all() and (lo.abs() <= 2.0 ** -7 * mid.abs()).all()


def test_split_near_the_smallest_normal_rounds_only_below_bf16s_least_subnormal():
    """Below 2^-110 a lowest bit of g lies under bf16's least subnormal
    (2^-133): lo rounds there, by at most half of it; from 2^-110 up the
    split stays exact. fp32's subnormals round the same way."""
    rng = np.random.default_rng(7)
    tiny = np.finfo(np.float32).tiny  # 2^-126
    g = np.concatenate([tiny * rng.uniform(0.5, 4.0, 60), -tiny * rng.uniform(1.0, 1.5, 20),
                        [tiny, -tiny, np.nextafter(tiny, 1), 2.0 ** -149],
                        rng.choice([-1, 1], 12) * 2.0 ** rng.uniform(-110, -109, 12)])
    g = torch.from_numpy(g.astype(np.float32)).view(4, -1)
    hi, mid, lo = _terms(g)
    got = (hi + mid) + lo
    assert float((got.double() - g.double()).abs().max()) <= 2.0 ** -134
    exact = g.abs() >= EXACT_FROM
    assert int(exact.sum()) >= 12 and torch.equal(_bits(got[exact]), _bits(g[exact]))


@pytest.mark.parametrize("n,width", [(5, 8), (16, 16), (13, 24)])
def test_split_pads_each_block_with_zeros(n, width):
    """Each of [lo | mid | hi] is ``width`` columns wide: the gradient's n
    terms, then zeros."""
    g = torch.from_numpy(np.random.default_rng(n).standard_normal((2, 3, n)).astype(np.float32))
    parts = P.split_bf16(g, width)
    assert parts.shape == (2, 3, 3 * width) and parts.dtype == torch.bfloat16
    blocks = parts.float().split(width, dim=-1)
    assert all(not blk[..., n:].any() for blk in blocks)
    lo, mid, hi = (blk[..., :n] for blk in blocks)
    assert torch.equal(_bits((hi + mid) + lo), _bits(g))
    assert torch.equal(P.split_bf16(g, width)[..., :n], P.split_bf16(g)[..., :n])


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_a_non_finite_gradient_gives_a_non_finite_gradient(bad):
    """The train step's finiteness guard must still see a NaN or an infinity
    that reaches the projection's backward: its row of grad_a and its column
    of grad_b are non-finite, and every other value finite."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((9, 5)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32))
    g[4, 2] = bad
    grad_a, grad_b = P.split_backward(a, b, g, product=_widened)
    assert not torch.isfinite(grad_a[4]).any() and not torch.isfinite(grad_b[:, 2]).any()
    assert torch.isfinite(torch.cat([grad_a[:4], grad_a[5:]])).all()
    assert torch.isfinite(torch.cat([grad_b[:, :2], grad_b[:, 3:]], dim=1)).all()


# (batch, M, K, N): a projection's (M, K) @ (K, N), and the plain attention's
# two bmm products, q @ k^T (b a transposed view) and p @ v
SHAPES = [((), 96, 40, 64, False), ((3,), 50, 24, 50, True), ((3,), 50, 50, 24, False),
          ((), 257, 33, 130, False)]


@pytest.mark.parametrize("run", [2048, 7])
@pytest.mark.parametrize("lead,m,k,n,b_view", SHAPES)
def test_split_backward_is_the_fp32_product(monkeypatch, lead, m, k, n, b_view, run):
    """grad_a = grad @ b^T and grad_b = a^T @ grad against fp64, each within
    the error bound of an fp32 sum of its terms, (3 N + 2) u and (3 M + 2) u
    times |grad| @ |b^T| and |a^T| @ |grad|, as the fp32 backward (N u and
    M u), in one run and in runs of 7 hi terms; the one-term backward, the
    gradient rounded to bf16 before the product, misses that bound."""
    monkeypatch.setattr(P, "RUN_MIN", run)
    monkeypatch.setattr(P, "RUN_MAX", run)
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((*lead, m, k)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((*lead, n, k) if b_view else (*lead, k, n))
                         .astype(np.float32) / np.sqrt(k)).bfloat16()
    if b_view:
        b = b.transpose(-1, -2)
    scale = 10.0 ** rng.uniform(-3, 1, (*lead, m, n))
    g = torch.from_numpy((rng.standard_normal((*lead, m, n)) * scale).astype(np.float32))
    t = lambda x: x.transpose(-1, -2)  # noqa: E731
    ref = (g.double() @ t(b.double()), t(a.double()) @ g.double())
    mag = (g.double().abs() @ t(b.double()).abs(), t(a.double()).abs() @ g.double().abs())

    def within(got, i, terms):
        assert got.dtype == torch.float32 and got.shape == ref[i].shape
        return bool(((got.double() - ref[i]).abs() <= terms * U * mag[i]).all())

    split = P.split_backward(a, b, g, product=_widened)
    fp32 = P.fp32_backward(a, b, g)
    one_term = (_widened(g.bfloat16(), t(b)), _widened(t(a), g.bfloat16()))
    assert within(split[0], 0, 3 * n + 2) and within(split[1], 1, 3 * m + 2)
    assert within(fp32[0], 0, n) and within(fp32[1], 1, m)
    assert not within(one_term[0], 0, 3 * n + 2) and not within(one_term[1], 1, 3 * m + 2)


@pytest.mark.parametrize("w,run", [(8, 512), (512, 512), (1024, 1024), (2048, 2048),
                                   (4096, 2048)])
def test_a_run_is_as_long_as_the_gradient_is_wide(w, run):
    """dW sums its hi terms in runs of W rows, within [512, 2048]: the
    partial sums of the batched product, (M / W) x I x W fp32, take no more
    than the fp32 widening of ``a`` the fp32 backward makes."""
    assert P.accumulation_run(w) == run


@pytest.mark.parametrize("needs", [(True, True), (True, False), (False, True)])
def test_split_backward_computes_only_the_gradients_asked_for(needs):
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((12, 5)).astype(np.float32))
    grads = P.split_backward(a, b, g, needs, product=_widened)
    assert [x is not None for x in grads] == list(needs)
    assert [tuple(x.shape) for x in grads if x is not None] == [
        s for s, w in zip([(12, 8), (8, 5)], needs) if w]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_matmul_takes_the_split_backward_for_bf16_alone(monkeypatch, dtype):
    """``_TensorCoreMatmulF32`` with a widened product in place of the
    tensor cores: bf16 operands take the split (one count on
    ``matmul_f32.split_backwards``), each gradient in bf16, equal to the
    split's fp32 gradient rounded; any other narrow dtype (fp16, whose
    exponent range cannot hold the split) is refused at the forward."""
    monkeypatch.setattr(P, "_tensor_core_product", _widened)
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype).requires_grad_()
            for shape in ((2, 16, 8), (2, 8, 4)))
    g = torch.from_numpy(rng.standard_normal((2, 16, 4)).astype(np.float32))
    before = P.matmul_f32.split_backwards
    if dtype != torch.bfloat16:
        with pytest.raises(TypeError, match="bf16 or fp32"):
            P._TensorCoreMatmulF32.apply(a, b)
        assert P.matmul_f32.split_backwards == before
        return
    out = P._TensorCoreMatmulF32.apply(a, b)
    assert out.dtype == torch.float32
    out.backward(g)
    assert P.matmul_f32.split_backwards - before == 1
    want = P.split_backward(a.detach(), b.detach(), g, product=_widened)
    assert a.grad.dtype == dtype and torch.equal(a.grad, want[0].to(dtype))
    assert b.grad.dtype == dtype and torch.equal(b.grad, want[1].to(dtype))


@pytest.mark.parametrize("model_type,split", [("cnn_rnn_large", 10), ("cnn_rnn", 6)])
def test_a_bf16_train_step_takes_the_split_backward_for_every_product(monkeypatch, model_type,
                                                                       split):
    """A bf16 step of each model with ``_TensorCoreMatmulF32`` taken on the
    CPU too (its product widened): the BiLSTM projections (``rnn_main`` 3
    layers x 2 directions; the large model's ``rnn_local`` 1 x 2) and the
    large model's plain attention (q @ k^T, p @ v) each take the split
    backward once. The card test counts the same step
    on the tensor cores."""
    from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.ops import attention_kernel, lstm
    from music_transcription_tpu_torch.parallel.train_step import TrainState, train_step
    from music_transcription_tpu_torch.train.optim import make_optimizer

    def through_the_function(a, b):
        if a.dtype == torch.float32 and b.dtype == torch.float32:
            return torch.matmul(a, b)
        return P._TensorCoreMatmulF32.apply(a, b)

    monkeypatch.setattr(P, "_tensor_core_product", _widened)
    monkeypatch.setattr(lstm, "matmul_f32", through_the_function)
    monkeypatch.setattr(attention_kernel, "matmul_f32", through_the_function)
    torch.manual_seed(0)
    cfg = ModelConfig(model_type=model_type, n_mels=32, hidden_size=16, num_layers=3,
                      num_attention_heads=4, attention_backend="xla")
    model = TranscriptionModel(cfg)
    rng = np.random.default_rng(4)
    batch = (torch.from_numpy((rng.standard_normal((2, 1, 32, 20)) * 10).astype(np.float32)),
             torch.from_numpy((rng.random((2, 88, 20)) > 0.9).astype(np.float32)),
             torch.tensor([20, 15], dtype=torch.int32))
    before = P.matmul_f32.split_backwards
    train_step(TrainState(model, make_optimizer(model.parameters(), TrainConfig())), batch, 1,
               max_grad_norm=1.0)
    assert P.matmul_f32.split_backwards - before == split
