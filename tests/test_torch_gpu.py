"""PyTorch port on a CUDA card: each hand-written kernel against its plain
version, and the serving path and a training step on the card against the
CPU.

Every test needs a card, carries the ``gpu`` marker and skips without one.
This file imports neither JAX nor the JAX package, so it runs on a machine
without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import json
import wave

import numpy as np
import pytest
import torch

from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, TrainConfig, config_to_dict
from music_transcription_tpu_torch.data.midi import load_midi
from music_transcription_tpu_torch.models.cnn_rnn import CNNRNNLarge, ResidualBlock
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.ops import attention_kernel as AK
from music_transcription_tpu_torch.ops import conv_kernel as CK
from music_transcription_tpu_torch.ops import lstm_kernel as LK
from music_transcription_tpu_torch.ops.mel import log_mel_batch
from music_transcription_tpu_torch.parallel.train_step import TrainState, train_step
from music_transcription_tpu_torch.train.optim import make_optimizer
from music_transcription_tpu_torch.transcribe import transcribe_audio

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_log_mel_on_card_matches_cpu(cuda):
    y = torch.from_numpy((0.1 * np.random.default_rng(5).standard_normal((3, 16000))).astype(np.float32))
    cpu = log_mel_batch(y, AudioConfig())
    card = log_mel_batch(y.to(cuda), AudioConfig()).cpu()
    assert float((card - cpu).abs().max()) < 6e-2  # dB, the frontend's parity bound


# the shapes the port runs, and the design's edges: 2B=16; 2B=50 (one row
# past a pass of 24); 2B=160 (rows in more than one pass); T=1; H=99 (no
# 16-byte rows, two blocks an SM)
@pytest.mark.parametrize("two_b,t,h", [(2, 5, 16), (6, 37, 48), (8, 938, 512), (32, 938, 256),
                                       (8, 17, 99), (16, 40, 512), (50, 20, 512), (160, 7, 512),
                                       (8, 1, 512)])
def test_lstm_kernel_matches_plain(cuda, two_b, t, h):
    rng = np.random.default_rng(two_b + t + h)
    xw = torch.from_numpy(rng.standard_normal((two_b, t, 4 * h)).astype(np.float32)).to(cuda)
    k = 1.0 / np.sqrt(h)
    wh = torch.from_numpy(rng.uniform(-k, k, (2, h, 4 * h)).astype(np.float32)).to(cuda)
    before = LK.lstm_recurrence.launches
    got = LK.lstm_recurrence(xw, wh)
    ref = LK.lstm_recurrence_plain(xw, wh)
    torch.cuda.synchronize()
    assert LK.lstm_recurrence.launches == before + 1
    # fp32; the summation order differs over up to 938 sequential steps
    assert float((got - ref).abs().max()) < 1e-4
    # a barrier that races shows as launches that disagree
    assert all(torch.equal(LK.lstm_recurrence(xw, wh), got) for _ in range(4))


@pytest.mark.parametrize("two_b,t,h", [(2, 5, 16), (6, 37, 48), (48, 938, 512), (48, 938, 256),
                                       (8, 17, 99), (16, 40, 512), (50, 20, 512), (160, 7, 512),
                                       (48, 1, 512)])
def test_lstm_training_kernels_match_plain(cuda, two_b, t, h):
    """K2a: h and c within 1e-4; K2b: dxw and dW_hh within 1e-4 of their
    largest magnitude (they grow with the sums over T)."""
    rng = np.random.default_rng(two_b + t + h + 1)
    xw = torch.from_numpy(rng.standard_normal((two_b, t, 4 * h)).astype(np.float32)).to(cuda)
    k = 1.0 / np.sqrt(h)
    wh = torch.from_numpy(rng.uniform(-k, k, (2, h, 4 * h)).astype(np.float32)).to(cuda)
    dh = torch.from_numpy(rng.standard_normal((two_b, t, h)).astype(np.float32)).to(cuda)
    fwd, bwd = LK.lstm_recurrence_fwd.launches, LK.lstm_recurrence_bwd.launches
    h_seq, c_seq = LK.lstm_recurrence_fwd(xw, wh)
    ref_h, ref_c = LK.lstm_recurrence_fwd_plain(xw, wh)
    dxw = LK.lstm_recurrence_bwd(xw, wh, ref_h, ref_c, dh)
    ref_dxw = LK.lstm_recurrence_bwd_plain(xw, wh, ref_h, ref_c, dh)
    torch.cuda.synchronize()
    assert (LK.lstm_recurrence_fwd.launches, LK.lstm_recurrence_bwd.launches) == (fwd + 1, bwd + 1)
    assert float((h_seq - ref_h).abs().max()) < 1e-4
    assert float((c_seq - ref_c).abs().max()) < 1e-4
    assert float((dxw - ref_dxw).abs().max()) <= 1e-4 * float(ref_dxw.abs().max())
    dwh, ref_dwh = (LK.recurrent_weight_grad(ref_h, g) for g in (dxw, ref_dxw))
    assert float((dwh - ref_dwh).abs().max()) <= 1e-4 * float(ref_dwh.abs().max())
    # a barrier that races shows as launches that disagree
    for _ in range(4):
        h2, c2 = LK.lstm_recurrence_fwd(xw, wh)
        assert torch.equal(h2, h_seq) and torch.equal(c2, c_seq)
        assert torch.equal(LK.lstm_recurrence_bwd(xw, wh, ref_h, ref_c, dh), dxw)


def test_lstm_kernels_raise_on_shapes_they_do_not_take(cuda):
    """H=520 takes 8 units a block (65 blocks a direction), past the 512 the
    register-held weight slice covers: ValueError, and no launch counted."""
    xw = torch.zeros(2, 2, 4 * 520, device=cuda)
    wh = torch.zeros(2, 520, 4 * 520, device=cuda)
    before = LK.lstm_recurrence.launches
    with pytest.raises(ValueError, match="do not take"):
        LK.lstm_recurrence(xw, wh)
    assert LK.lstm_recurrence.launches == before
    h = torch.zeros(2, 2, 520, device=cuda)
    with pytest.raises(ValueError, match="do not take"):
        LK.lstm_recurrence_bwd(xw, wh, h, h, h)


def test_lstm_recurrence_function_matches_autograd_through_plain(cuda):
    rng = np.random.default_rng(3)
    xw = torch.from_numpy(rng.standard_normal((6, 37, 4 * 48)).astype(np.float32)).to(cuda)
    wh = torch.from_numpy((0.2 * rng.standard_normal((2, 48, 4 * 48))).astype(np.float32)).to(cuda)
    dh = torch.from_numpy(rng.standard_normal((6, 37, 48)).astype(np.float32)).to(cuda)
    grads = []
    for fn in (LK.recurrence, LK.lstm_recurrence_plain):
        a, w = xw.clone().requires_grad_(), wh.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(a, w), (a, w), dh))
    for got, ref in zip(*grads):
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_flash_attention_refuses_a_gradient_on_card(cuda):
    """A gradient through the flash route on the card is not refused: it
    takes K3 with lse forward and K4a / K4b backward; without one, K3."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
               .to(cuda).requires_grad_() for _ in range(3))
    counters = (AK.flash_attention_clamped, AK.flash_attention_clamped_fwd,
                AK.flash_attention_clamped_dq, AK.flash_attention_clamped_dkv)
    before = [c.launches for c in counters]
    AK.flash_attention_clamped(q, k, v, 0.25).sum().backward()
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 1, 1, 1]
    assert all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v))
    with torch.no_grad():  # serving: K3 without lse
        AK.flash_attention_clamped(q, k, v, 0.25)
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1, 1]


# K3 with lse, K4a and K4b against their plain versions: lse to 1e-5 |lse| +
# 1e-5 (fp32 summation order); each gradient to a share of its largest
# magnitude: fp32 1e-5 (summation order), bf16 2^-7 (both round dS, p and the
# result to bf16; where their fp32 values straddle a rounding boundary they
# come out a bf16 unit apart).
FLASH_GRAD_TOL = {torch.bfloat16: 2.0**-7, torch.float32: 1e-5}


def _flash_training_kernels_match_plain(cuda, b, t, nh, d, dtype):
    rng = np.random.default_rng(t + d + 1)
    q, k, v, do = (torch.from_numpy((m * rng.standard_normal((b, t, nh, d))).astype(np.float32))
                   .to(cuda, dtype) for m in (6.0, 1.0, 1.0, 1.0))
    scale = d**-0.5
    before = [c.launches for c in (AK.flash_attention_clamped_fwd, AK.flash_attention_clamped_dq,
                                   AK.flash_attention_clamped_dkv)]
    o, lse = AK.flash_attention_clamped_fwd(q, k, v, scale)
    ref_o, ref_lse = AK.attention_clamped_fwd_plain(q, k, v, scale)
    dq = AK.flash_attention_clamped_dq(q, k, v, ref_o, do, ref_lse, scale)
    dk, dv = AK.flash_attention_clamped_dkv(q, k, v, ref_o, do, ref_lse, scale)
    ref = AK.attention_clamped_bwd_plain(q, k, v, ref_o, do, ref_lse, scale)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip((AK.flash_attention_clamped_fwd,
                                            AK.flash_attention_clamped_dq,
                                            AK.flash_attention_clamped_dkv), before)] == [1, 1, 1]
    rtol, ptol = FLASH_TOL[dtype]
    ref_abs_v = AK.attention_clamped_plain(q, k, v.abs(), scale).float()
    assert bool(((o.float() - ref_o.float()).abs() <= rtol * ref_o.float().abs() + ptol * ref_abs_v).all())
    assert lse.shape == (b, nh, t)
    assert bool(((lse - ref_lse).abs() <= 1e-5 * ref_lse.abs() + 1e-5).all())
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == dtype
        err = float((got.float() - want.float()).abs().max())
        assert err <= FLASH_GRAD_TOL[dtype] * float(want.float().abs().max())


# T=257: a partial last tile of both K3's 128 query rows and K4b's 64 key
# rows, and of the 64-row tiles both stream (one row each)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,t,nh,d", [(1, 37, 2, 192), (2, 130, 8, 192), (1, 100, 2, 24),
                                      (1, 70, 1, 18), (1, 150, 2, 256), (1, 257, 2, 192)])
def test_flash_training_kernels_match_plain(cuda, b, t, nh, d, dtype):
    _flash_training_kernels_match_plain(cuda, b, t, nh, d, dtype)


# T = 2 tiles + 1 of the fp32 K3's and K4a's key tiles, K4a's query-row
# blocks and K4b's query tiles: the ring's chunks of a third, partial tile
# (a third, partial block), at D=192, 24 (16-byte rows padded to 64 columns)
# and 18 (plain loads)
@pytest.mark.parametrize("b,t,nh,d", sorted({(1, 2 * tile + 1, nh, d)
                                             for tile in (AK.K3_KEY_TILE_F32,
                                                          AK.K4A_KEY_TILE_F32,
                                                          AK.K4A_QUERY_ROWS_F32,
                                                          AK.K4B_QUERY_TILE_F32)
                                             for nh, d in ((2, 192), (3, 24), (1, 18))}))
def test_fp32_flash_training_kernels_match_plain_at_the_tile_edges(cuda, b, t, nh, d):
    _flash_training_kernels_match_plain(cuda, b, t, nh, d, torch.float32)


@pytest.mark.parametrize("attention", ["xla", "pallas"])
def test_train_step_on_card_matches_cpu(cuda, monkeypatch, attention):
    """One step at dropout 0, fp32: loss within 1e-4 relative; K2a and K2b
    launched once per BiLSTM layer, and on the flash route K3 with lse, K4a
    and K4b once each; each gradient within 1e-3 of its largest
    magnitude, but for the convolutions and BatchNorms (1e-2: under a
    training-mode BatchNorm their per-channel sums cancel) and the
    convolutions' biases, whose exact gradient is 0 (the BatchNorm after them
    removes them): those stay below 1e-6 of the model's largest gradient."""
    monkeypatch.setattr(CNNRNNLarge, "CHANNEL_DROPOUT", (0.0, 0.0, 0.0))
    torch.manual_seed(0)
    cfg = ModelConfig(n_mels=64, hidden_size=32, num_layers=2, dropout=0.0,
                      compute_dtype="float32", lstm_backend="pallas", attention_backend=attention)
    models = [TranscriptionModel(cfg), TranscriptionModel(cfg)]
    models[1].load_state_dict(models[0].state_dict())
    models[1].to(cuda)
    rng = np.random.default_rng(4)
    batch = (torch.from_numpy((rng.standard_normal((3, 1, 64, 63)) * 10).astype(np.float32)),
             torch.from_numpy((rng.random((3, 88, 63)) > 0.9).astype(np.float32)),
             torch.tensor([63, 50, 20], dtype=torch.int32))
    fwd, bwd = LK.lstm_recurrence_fwd.launches, LK.lstm_recurrence_bwd.launches
    flash = (AK.flash_attention_clamped_fwd, AK.flash_attention_clamped_dq,
             AK.flash_attention_clamped_dkv)
    flash_before = [c.launches for c in flash]
    metrics = []
    for m in models:
        dev = next(m.parameters()).device
        state = TrainState(m, make_optimizer(m.parameters(), TrainConfig()))
        metrics.append(train_step(state, tuple(x.to(dev) for x in batch), 1, max_grad_norm=1.0))
    assert (LK.lstm_recurrence_fwd.launches, LK.lstm_recurrence_bwd.launches) == (fwd + 3, bwd + 3)
    assert [c.launches - n for c, n in zip(flash, flash_before)] == [int(attention == "pallas")] * 3
    ref, got = metrics
    assert got["skipped"] == 0.0 and abs(got["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    cnn = {f"{m}.{p}": type(mod) for m, mod in models[0].named_modules()
           if isinstance(mod, (torch.nn.Conv2d, torch.nn.BatchNorm2d)) for p in ("weight", "bias")}
    card = dict(models[1].named_parameters())
    g_max = max(float(p.grad.abs().max()) for p in models[0].parameters())
    for name, p in models[0].named_parameters():
        other = card[name].grad.cpu()
        if cnn.get(name) is torch.nn.Conv2d and name.endswith(".bias"):
            assert max(float(p.grad.abs().max()), float(other.abs().max())) <= 1e-6 * g_max, name
            continue
        tol = 1e-2 if name in cnn else 1e-3
        assert float((other - p.grad).abs().max()) <= tol * float(p.grad.abs().max()), name


def _sharded_step_at_world_1(cuda, tmp_path, strategy: str, mesh_shape: tuple):
    """One fp32 step with the state placed by ``strategy``
    (``parallel/partitioning``) on a world-1 mesh of ``mesh_shape`` in an
    NCCL group on the card, against the same step without a group: the loss
    within 1e-4 relative; the parameters within 2 lr and all but 1 in 200
    within 1e-2 lr; the recurrence kernels launched on the gathered weights
    (K2a and K2b once a layer); the gathered state loads into a plain model."""
    import torch.distributed as dist

    from music_transcription_tpu_torch.parallel import partitioning as part
    from music_transcription_tpu_torch.parallel.mesh import make_mesh
    from music_transcription_tpu_torch.parallel.train_step import data_parallel

    torch.manual_seed(0)
    cfg = ModelConfig(n_mels=64, hidden_size=32, num_layers=2, dropout=0.0,
                      compute_dtype="float32", lstm_backend="pallas")
    weights = TranscriptionModel(cfg).model.state_dict()
    rng = np.random.default_rng(4)
    batch = (torch.from_numpy((rng.standard_normal((4, 1, 64, 63)) * 10).astype(np.float32)),
             torch.from_numpy((rng.random((4, 88, 63)) > 0.9).astype(np.float32)),
             torch.tensor([63, 50, 20, 63], dtype=torch.int32))
    batch = tuple(x.to(cuda) for x in batch)

    def fresh():
        m = TranscriptionModel(cfg)
        m.model.load_state_dict(weights)
        m.to(cuda)
        return TrainState(m, make_optimizer(m.parameters(), TrainConfig()))

    plain = fresh()
    ref = train_step(plain, batch, 1, max_grad_norm=1.0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = (make_mesh(1, "cuda") if len(mesh_shape) == 1
                else part.make_mesh_2d(*mesh_shape, "cuda"))
        state = part.shard_state(data_parallel(fresh(), mesh), mesh, strategy=strategy)
        fwd, bwd = LK.lstm_recurrence_fwd.launches, LK.lstm_recurrence_bwd.launches
        got = train_step(state, batch, 1, max_grad_norm=1.0)
        launches = (LK.lstm_recurrence_fwd.launches - fwd, LK.lstm_recurrence_bwd.launches - bwd)
        sd = part.full_model_state_dict(state)
    finally:
        dist.destroy_process_group()
    # one launch a layer, both directions stacked: rnn_main's 2 and rnn_local's 1
    assert launches == (3, 3)
    assert got["skipped"] == 0.0 and abs(got["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    lr, loose, total = TrainConfig().learning_rate, 0, 0
    for name, p in plain.model.model.named_parameters():
        diff = (sd[name].float().cpu() - p.detach().cpu()).abs()
        assert float(diff.max()) <= 2 * lr, name
        loose, total = loose + int((diff > 1e-2 * lr).sum()), total + diff.numel()
    assert loose <= 5e-3 * total
    TranscriptionModel(cfg).model.load_state_dict(sd, strict=True)


def test_fsdp_step_at_world_1_over_nccl_matches_the_plain_step(cuda, monkeypatch, tmp_path):
    monkeypatch.setattr(CNNRNNLarge, "CHANNEL_DROPOUT", (0.0, 0.0, 0.0))
    _sharded_step_at_world_1(cuda, tmp_path, "fsdp", (1,))


@pytest.mark.parametrize("mesh_shape", [(1,), (1, 1)], ids=["1d", "2d"])
def test_tp_step_at_world_1_over_nccl_matches_the_plain_step(cuda, monkeypatch, tmp_path,
                                                             mesh_shape):
    monkeypatch.setattr(CNNRNNLarge, "CHANNEL_DROPOUT", (0.0, 0.0, 0.0))
    _sharded_step_at_world_1(cuda, tmp_path, "tp", mesh_shape)


def test_two_replicas_on_one_card_serve_the_one_device_roll(cuda, tmp_path):
    """Transcriber(devices=["cuda:0", "cuda:0"]): 5 chunks padded to 6, 3 a
    replica, each replica through K1 (once a layer: 3 launches a forward); the
    logits within the serving check's fp32 bound of one device's, a block
    shifted by one chunk outside it, and the rolls equal except where a
    probability sits within a quarter of that bound of the threshold."""
    from music_transcription_tpu_torch.transcribe import (
        Transcriber,
        replica_forward,
        transcribe_chunks,
    )

    torch.manual_seed(0)
    cfg = ModelConfig(n_mels=64, hidden_size=32, num_layers=2, compute_dtype="float32")
    acfg = AudioConfig(n_mels=64, chunk_length=2.0)
    pth = tmp_path / "m.pth"
    torch.save(TranscriptionModel(cfg).model.state_dict(), pth)
    (tmp_path / "m.json").write_text(json.dumps({"model": config_to_dict(cfg),
                                                 "audio": config_to_dict(acfg)}))
    chunks = (0.1 * np.random.default_rng(6).standard_normal((5, acfg.chunk_samples))
              ).astype(np.float32)
    one = Transcriber(pth, device="cuda")
    two = Transcriber(pth, devices=["cuda:0", "cuda:0"])
    assert len(two.replicas) == 2 and two.replicas[0] is not two.replicas[1]
    before = LK.lstm_recurrence.launches
    got = transcribe_chunks(two.loaded, chunks, replicas=two.replicas)
    assert LK.lstm_recurrence.launches - before == 2 * 3
    want = transcribe_chunks(one.loaded, chunks)

    def forward(model, mel):
        return model(mel).float()

    logits = [torch.from_numpy(replica_forward(r, chunks, acfg, forward))
              for r in ([one.loaded.model], two.replicas)]
    # the serving check's fp32 bound (card against CPU): 1e-3 of the largest logit
    bound = 1e-3 * float(logits[0].abs().max())
    assert float((logits[1] - logits[0]).abs().max()) <= bound
    # a replica fed its block one chunk early fails that bound
    shifted = np.concatenate([chunks[:3], chunks[2:4]])
    fault = torch.from_numpy(replica_forward(two.replicas, shifted, acfg, forward))
    assert float((fault - logits[0]).abs().max()) > bound
    # sigmoid' <= 1/4: a roll frame may flip only within bound / 4 of the threshold
    near = (torch.sigmoid(logits[0]) - 0.5).abs() <= bound / 4
    differ = torch.from_numpy(got != want)
    flat_near = torch.cat(list(near), dim=1)
    assert bool((~differ | flat_near).all())


# |got - ref| <= rtol |ref| + ptol (P|V|) element by element, with P|V| the
# plain version's output for |v|. bf16: both round the output to bf16 and
# every probability to bf16 at different points (the kernel before dividing
# by the row sum, the plain version after), which bounds the difference by
# 2^-7 |ref| + 2^-8 (P|V|); the test allows twice that. fp32: only the
# summation order differs.
FLASH_TOL = {torch.bfloat16: (2.0**-6, 2.0**-7), torch.float32: (1e-5, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,t,nh,d", [(1, 37, 2, 192), (2, 130, 8, 192), (1, 100, 2, 24),
                                      (1, 70, 1, 18), (1, 150, 2, 256), (1, 257, 2, 192),
                                      (1, 257, 2, 256)])
def test_flash_kernel_matches_plain(cuda, b, t, nh, d, dtype):
    rng = np.random.default_rng(t + d)
    # q scaled up so the +-10 clamp binds on part of the logits
    q, k, v = (torch.from_numpy((m * rng.standard_normal((b, t, nh, d))).astype(np.float32))
               .to(cuda, dtype) for m in (4.0, 1.0, 1.0))
    before = AK.flash_attention_clamped.launches
    got = AK.flash_attention_clamped(q, k, v, d**-0.5, 10.0)
    ref = AK.attention_clamped_plain(q, k, v, d**-0.5, 10.0)
    torch.cuda.synchronize()
    assert AK.flash_attention_clamped.launches == before + 1
    assert got.dtype == dtype
    rtol, ptol = FLASH_TOL[dtype]
    ref_abs_v = AK.attention_clamped_plain(q, k, v.abs(), d**-0.5, 10.0).float()
    got, ref = got.float(), ref.float()
    assert bool(((got - ref).abs() <= rtol * ref.abs() + ptol * ref_abs_v).all())


def _flash_kernels_repeat_bit_identical(cuda, b, t, nh, d, dtype):
    """K3 (without and with lse), K4a and K4b, whose tiles stream through a
    ring of shared-memory stages, launched 5 times on the same inputs: the
    same bits every time (a stage read before it is refilled shows as a
    difference)."""
    rng = np.random.default_rng(t + d + 2)
    q, k, v, do = (torch.from_numpy((m * rng.standard_normal((b, t, nh, d))).astype(np.float32))
                   .to(cuda, dtype) for m in (6.0, 1.0, 1.0, 1.0))
    scale = d**-0.5
    calls = (lambda: (AK.flash_attention_clamped(q, k, v, scale),),
             lambda: AK.flash_attention_clamped_fwd(q, k, v, scale))
    for call in calls:
        first = call()
        assert all(all(torch.equal(x, y) for x, y in zip(call(), first)) for _ in range(4))
    o, lse = AK.attention_clamped_fwd_plain(q, k, v, scale)
    for call in (lambda: (AK.flash_attention_clamped_dq(q, k, v, o, do, lse, scale),),
                 lambda: AK.flash_attention_clamped_dkv(q, k, v, o, do, lse, scale)):
        first = call()
        for _ in range(4):
            again = call()
            assert all(torch.equal(x, y) for x, y in zip(again, first))


REPEAT_SHAPES = [(2, 257, 4, 192), (1, 70, 1, 18)]


@pytest.mark.parametrize("b,t,nh,d", REPEAT_SHAPES)
def test_flash_kernels_repeat_bit_identical(cuda, b, t, nh, d):
    _flash_kernels_repeat_bit_identical(cuda, b, t, nh, d, torch.bfloat16)


@pytest.mark.parametrize("b,t,nh,d", REPEAT_SHAPES)
def test_fp32_flash_kernels_repeat_bit_identical(cuda, b, t, nh, d):
    _flash_kernels_repeat_bit_identical(cuda, b, t, nh, d, torch.float32)


def _flash_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda, dtype):
    counters = (AK.flash_attention_clamped, AK.flash_attention_clamped_fwd,
                AK.flash_attention_clamped_dq, AK.flash_attention_clamped_dkv)
    before = [c.launches for c in counters]
    for shape in ((1, 4, 1, 264), (8193, 1, 8, 8)):
        x = torch.zeros(shape, device=cuda, dtype=dtype)
        lse = torch.zeros((shape[0], shape[2], shape[1]), device=cuda)
        with pytest.raises(ValueError):
            AK.flash_attention_clamped(x, x, x, 1.0)
        with pytest.raises(ValueError):
            AK.flash_attention_clamped_fwd(x, x, x, 1.0)
        with pytest.raises(ValueError):
            AK.flash_attention_clamped_dq(x, x, x, x, x, lse, 1.0)
        with pytest.raises(ValueError):
            AK.flash_attention_clamped_dkv(x, x, x, x, x, lse, 1.0)
    assert [c.launches for c in counters] == before


def test_flash_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda):
    """head_dim past 256 (the kernels' shared-memory tiles) and more than
    65535 (batch, head) pairs (the grids' second dimension): ValueError from
    K3, K3 with lse, K4a and K4b in bf16, and no launch counted."""
    _flash_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda, torch.bfloat16)


def test_fp32_flash_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda):
    """The same in fp32."""
    _flash_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda, torch.float32)


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 3, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        LK.lstm_recurrence(x, torch.zeros(2, 2, 8, device=cuda, dtype=torch.float16))
    q = torch.zeros(1, 4, 1, 8, device=cuda, dtype=torch.float16)  # fp16: bf16 or fp32 only
    with pytest.raises(ValueError):
        AK.flash_attention_clamped(q, q, q, 1.0)
    vec = torch.ones(4, device=cuda)
    w = torch.zeros(4, 2, 3, 3, device=cuda)
    with pytest.raises(ValueError):  # the weight on the CPU
        CK.fused_conv_bn_relu(torch.zeros(1, 2, 8, 8, device=cuda), w.cpu(), vec, vec, vec, vec, vec)
    with pytest.raises(ValueError):  # F odd
        CK.fused_conv_bn_relu(torch.zeros(1, 2, 7, 8, device=cuda), w, vec, vec, vec, vec, vec)
    with pytest.raises(ValueError):  # C_in of x and weight differ
        CK.fused_conv_bn_relu(torch.zeros(1, 3, 8, 8, device=cuda), w, vec, vec, vec, vec, vec)
    vec = torch.ones(256, device=cuda)
    with pytest.raises(ValueError):  # the x ring of 256 channels at kh=7 exceeds shared memory
        CK.fused_conv_bn_relu(torch.zeros(1, 256, 8, 8, device=cuda),
                              torch.zeros(256, 256, 7, 3, device=cuda), vec, vec, vec, vec, vec)


def _k5_args(cuda, seed, b, c_in, c_out, f, t, kh, kw):
    """x (bf16), weight, conv bias, BN scale, bias, mean (0.3 N), var (|N| + 0.5)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, c_in, f, t)).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((c_out, c_in, kh, kw)) / np.sqrt(c_in * kh * kw))
                         .astype(np.float32)).to(cuda)
    vecs = [torch.from_numpy((0.3 * rng.standard_normal(c_out)).astype(np.float32)).to(cuda)
            for _ in range(4)]
    var = torch.from_numpy((np.abs(rng.standard_normal(c_out)) + 0.5).astype(np.float32)).to(cuda)
    return (x, w, *vecs, var)


# C_in 1 and < 16 take the CUDA-core kernel (conv1's 3x3 at C_in 1 a thread's
# windows in registers, where the output planes are multiples of 8; F=18,
# T=130 without pool are not; the rest element by element), >= 16 the walk on
# the tensor cores (one and several 64-channel output groups, partial ones; a
# C_out that is not a multiple of 8; C_in 40 not a multiple of 16); T not a
# multiple of the strip (64); F not a multiple of 4 without pool; then the
# walk's segments on 132 SMs: F over several segments with a shorter last
# one, a strip boundary inside T, at B=1 (F=20, T=130: 8 + 8 + 4 rows, 3
# strips) and B=4 (F=44, T=200: 5 x 8 + 4 rows, 4 strips, the last 8
# columns), and a last segment of half a step (F=18: 8 + 8 + 2 rows)
@pytest.mark.parametrize("b,c_in,c_out,f,t,kh,kw,pool", [
    (2, 1, 32, 16, 70, 3, 3, True), (1, 1, 32, 18, 130, 3, 3, False),
    (2, 12, 16, 8, 20, 7, 3, False), (2, 3, 40, 12, 200, 7, 3, True),
    (2, 32, 64, 16, 70, 3, 3, True), (1, 128, 256, 20, 130, 7, 3, False),
    (1, 16, 20, 8, 65, 3, 3, True), (1, 40, 24, 8, 33, 7, 3, True),
    (1, 128, 256, 80, 938, 7, 3, True), (1, 1, 32, 320, 938, 3, 3, True),
    (1, 32, 64, 20, 130, 3, 3, True), (4, 128, 256, 44, 200, 7, 3, False),
    (1, 16, 24, 18, 70, 3, 3, False),
])
def test_k5_matches_plain(cuda, b, c_in, c_out, f, t, kh, kw, pool):
    """K5 against its plain version, element by element to ``k5_score``'s
    bound (K5_TOL: a bf16 unit before the affine and at the output, and the
    fp32 sums' order)."""
    args = _k5_args(cuda, c_in + c_out + f + t, b, c_in, c_out, f, t, kh, kw)
    before = CK.fused_conv_bn_relu.launches
    got = CK.fused_conv_bn_relu(*args, pool=pool)
    ref = CK.fused_conv_bn_relu_plain(*args, pool=pool)
    torch.cuda.synchronize()
    assert CK.fused_conv_bn_relu.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (b, c_out, f // 2 if pool else f, t)
    assert CK.k5_score(got, ref, args, pool=pool) <= 1.0


@pytest.mark.parametrize("c_in,c_out,f,kh", [(1, 32, 320, 3), (128, 256, 80, 7)],
                         ids=["conv1-89M", "freq_aware_conv-89M"])
def test_k5_repeats_bit_identical(cuda, c_in, c_out, f, kh):
    """Five launches of K5 at an 89M stage (B=4, T=938, pool) give the same
    bits: no atomics, so every output is summed in the same order."""
    args = _k5_args(cuda, c_in + f, 4, c_in, c_out, f, 938, kh, 3)
    first = CK.fused_conv_bn_relu(*args, pool=True)
    for _ in range(4):
        assert torch.equal(CK.fused_conv_bn_relu(*args, pool=True), first)


def test_k5_segment_rows_follow_the_plan(cuda):
    """The walk's segment height (its library's) is ``k5_segment_rows`` on
    this card's SM count, which the faults and ``k5_traffic`` use."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for b, f, t in ((4, 80, 938), (1, 20, 130), (4, 44, 200), (1, 18, 70), (64, 80, 938),
                    (1, 8, 65)):
        assert CK.k5_device_segment_rows(b, f, t) == CK.k5_segment_rows(b, f, t, sms)


@pytest.mark.parametrize("c_in,c_out,f,kh", [(1, 32, 16, 3), (32, 40, 16, 7)],
                         ids=["chunks", "walk"])
def test_k5_takes_raw_dtypes(cuda, c_in, c_out, f, kh):
    """The packing reads the raw tensors: fp32 x, bf16 weights, fp64 and
    fp16 vectors give what the plain version gives on the same values."""
    args = _k5_args(cuda, c_in + c_out, 2, c_in, c_out, f, 70, kh, 3)
    raw = (args[0].float(), args[1].to(torch.bfloat16), args[2].double(), args[3].half(),
           *args[4:])
    got = CK.fused_conv_bn_relu(*raw, pool=True)
    ref = CK.fused_conv_bn_relu_plain(*raw, pool=True)
    torch.cuda.synchronize()
    assert CK.k5_score(got, ref, raw, pool=True) <= 1.0


def _k6_args(cuda, seed, b, c_in, c_out, f, t):
    """x (bf16) and a seeded ResidualBlock(c_in, c_out) with BatchNorm
    statistics made non-trivial (variance |N| + 0.5, the rest 0.3 N), as
    K6's arguments."""
    torch.manual_seed(seed)
    block = ResidualBlock(c_in, c_out)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for bn in (m for m in block.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.running_var.copy_(torch.from_numpy(np.abs(rng.standard_normal(bn.num_features)) + 0.5))
            for v in (bn.running_mean, bn.weight, bn.bias):
                v.copy_(torch.from_numpy(0.3 * rng.standard_normal(bn.num_features)))
    x = torch.from_numpy(rng.standard_normal((b, c_in, f, t)).astype(np.float32))
    return (x.to(cuda, torch.bfloat16), *CK.res_block_args(block.to(cuda)))


# the 89M model's two blocks at a short T and with a partial last T tile (the
# kernel's strips are 62 columns), one strip exactly, the identity skip at
# 16 -> 16 and 64 -> 64, a C_out that fills part of a 64-channel group, and
# the 30 s route's shape; then the walk: F over several segments with a
# shorter last one (on 132 SMs: 36 + 34 rows at B=4, T=938; 6 x 8 + 4 rows
# at B=1, T=200 with the pool; 5 x 8 + 4 at B=2, T=130, identity), and a
# C_out of 64 + 16 channels (a second, partial output group)
@pytest.mark.parametrize("b,c_in,c_out,f,t,pool", [
    (1, 32, 64, 160, 70, True), (1, 64, 128, 80, 130, False), (2, 32, 64, 16, 62, True),
    (1, 16, 16, 8, 65, False), (1, 64, 64, 12, 200, False), (1, 16, 48, 8, 33, True),
    (4, 32, 64, 160, 938, True), (4, 64, 128, 80, 938, False),
    (4, 64, 128, 70, 938, False), (1, 32, 64, 52, 200, True), (2, 64, 64, 44, 130, False),
    (1, 16, 80, 12, 70, False),
])
def test_k6_matches_plain(cuda, b, c_in, c_out, f, t, pool):
    """K6 against its plain version, element by element to ``k6_score``'s
    bound (exact but where a sum's order can move a bf16 rounding)."""
    args = _k6_args(cuda, c_in + c_out + f + t, b, c_in, c_out, f, t)
    before = CK.fused_res_block.launches
    with torch.no_grad():
        got = CK.fused_res_block(*args, pool=pool)
        ref = CK.fused_res_block_plain(*args, pool=pool)
    torch.cuda.synchronize()
    assert CK.fused_res_block.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape == (b, c_out, f // 2 if pool else f, t)
    assert CK.k6_score(got, ref, args, pool=pool) <= 1.0


@pytest.mark.parametrize("c_in,c_out,f,pool", [(32, 64, 160, True), (64, 128, 80, False)],
                         ids=["res_block1-89M", "res_block2-89M"])
def test_k6_repeats_bit_identical(cuda, c_in, c_out, f, pool):
    """Five launches of K6 at an 89M block (B=4, T=938) give the same bits:
    no atomics, so every output is summed in the same order."""
    args = _k6_args(cuda, c_in + f, 4, c_in, c_out, f, 938)
    with torch.no_grad():
        first = CK.fused_res_block(*args, pool=pool)
        for _ in range(4):
            assert torch.equal(CK.fused_res_block(*args, pool=pool), first)


def test_k6_segment_rows_follow_the_plan(cuda):
    """The kernel's segment height (its library's) is ``k6_segment_rows``
    on this card's SM count, which the faults and the work counts use."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for b, f, t in ((4, 160, 938), (4, 80, 938), (1, 52, 200), (2, 44, 130), (1, 8, 65),
                    (64, 80, 938), (1, 4, 20)):
        assert CK.k6_device_segment_rows(b, f, t) == CK.k6_segment_rows(b, f, t, sms)


def test_k6_raises_on_inputs_it_does_not_take(cuda):
    args = _k6_args(cuda, 0, 1, 16, 32, 8, 20)
    with pytest.raises(ValueError):  # conv1's weight on the CPU
        CK.fused_res_block(args[0], args[1].cpu(), *args[2:])
    for f, pool in ((7, False), (10, True)):  # F odd; F % 4 with pool
        with pytest.raises(ValueError):
            CK.fused_res_block(torch.zeros(1, 16, f, 20, device=cuda), *args[1:], pool=pool)
    with pytest.raises(ValueError):  # 8 input channels: not a multiple of 16
        CK.fused_res_block(*_k6_args(cuda, 1, 1, 8, 16, 8, 20))
    with pytest.raises(ValueError):  # no skip conv, but C_in != C_out
        CK.fused_res_block(*args[:13])
    with pytest.raises(ValueError):  # the x and h1 rings of 256 channels exceed shared memory
        CK.fused_res_block(*_k6_args(cuda, 2, 1, 256, 256, 8, 20))


@pytest.mark.parametrize("dtype,attention,rel_tol", [("float32", "xla", 1e-4),
                                                     ("float32", "pallas", 1e-4),
                                                     ("bfloat16", "pallas", 5e-2)])
def test_model_on_card_matches_cpu(cuda, dtype, attention, rel_tol):
    torch.manual_seed(0)
    cfg = ModelConfig(n_mels=64, hidden_size=32, num_layers=2, compute_dtype=dtype,
                      attention_backend=attention)
    cpu_m = TranscriptionModel(cfg).eval()
    card_m = TranscriptionModel(cfg).eval()
    card_m.load_state_dict(cpu_m.state_dict())
    card_m.to(cuda)
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 1, 64, 50)).astype(np.float32))
    k1, k3 = LK.lstm_recurrence.launches, AK.flash_attention_clamped.launches
    with torch.inference_mode():
        ref = cpu_m(mel, return_all_heads=True)
        got = card_m(mel.to(cuda), return_all_heads=True)
    assert LK.lstm_recurrence.launches == k1 + 3  # 2 rnn_main layers + rnn_local
    assert AK.flash_attention_clamped.launches == k3 + (attention == "pallas")
    for head in ("frame", "onset", "offset"):
        scale = float(ref[head].abs().max())
        assert float((got[head].cpu() - ref[head]).abs().max()) <= rel_tol * scale, head


def test_transcribe_audio_on_card(cuda, tmp_path):
    torch.manual_seed(0)
    mcfg = ModelConfig(n_mels=64, hidden_size=32, num_layers=1)
    acfg = AudioConfig(n_mels=64, chunk_length=2.0)
    torch.save(TranscriptionModel(mcfg).model.state_dict(), tmp_path / "m.pth")
    (tmp_path / "m.json").write_text(json.dumps({"model": config_to_dict(mcfg),
                                                 "audio": config_to_dict(acfg)}))
    sr, n = 16000, 16000 * 5
    y = 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(n) / sr)
    with wave.open(str(tmp_path / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((y * 32767).astype("<i2").tobytes())
    before = LK.lstm_recurrence.launches
    out = transcribe_audio(tmp_path / "a.wav", tmp_path / "m.pth", tmp_path / "a.mid",
                           verbose=False)
    assert LK.lstm_recurrence.launches == before + 2  # one forward: rnn_main + rnn_local
    load_midi(out)


def test_preprocess_device_path_on_card_matches_host(cuda, tmp_path):
    """The mel of a cache built on the card (torch.stft there, batches of 3
    padded to the chunk, tails floored over their retained frames) within
    6e-2 dB of the numpy host path's, the rolls and metadata identical."""
    from chip_smoke import write_maestro_tree
    from music_transcription_tpu_torch.data import cache as C
    from music_transcription_tpu_torch.data.preprocess import preprocess_split

    root = tmp_path / "raw"
    write_maestro_tree(root, 3, [("train", 7.0), ("train", 5.0)])
    acfg = AudioConfig(n_mels=64, chunk_length=2.0)
    common = dict(root_dir=root, split="train", audio_cfg=acfg, chunk_length=2.0,
                  device_batch=3, verbose=False)
    card = preprocess_split(cache_dir=tmp_path / "card", device="cuda", **common)
    preprocess_split(cache_dir=tmp_path / "host", device="cpu", **common)
    assert card == {"total": 7, "processed": 7, "skipped": 0, "failed": 0}
    assert C.load_metadata(tmp_path / "card", "train") == C.load_metadata(tmp_path / "host", "train")
    for i in range(7):
        a, b = C.load_chunk(tmp_path / "card" / "train", i), C.load_chunk(tmp_path / "host" / "train", i)
        assert a["mel"].shape == b["mel"].shape
        assert float(np.abs(a["mel"] - b["mel"]).max()) < 6e-2
        np.testing.assert_array_equal(a["roll"], b["roll"])


def _slab_cache(root, n=21, n_mels=40, t=60):
    from music_transcription_tpu_torch.data import cache as C

    rng = np.random.default_rng(4)
    for i in range(n):
        C.save_chunk(root / "train", i, {
            "mel": (rng.standard_normal((n_mels, t - i % 3)) * 10 - 40).astype(np.float32),
            "roll": (rng.random((88, t - i % 3)) > 0.8).astype(np.uint8)})
    C.save_metadata(root, "train", {"num_chunks": n, "chunk_length": 1.0, "overlap": 0.0,
                                    "n_mels": n_mels, "sr": 16000, "hop_length": 512})
    return C.CachedMaestroDataset(root, "train", verbose=False)


def test_slab_epoch_on_card_equals_items_loaded_on_the_host(cuda, tmp_path):
    """Slabs staged from pinned memory on a side stream: every batch of 2
    epochs (2 passes a slab) equals its items collated on the host, the mel
    rounded to bf16, bit for bit."""
    from music_transcription_tpu_torch.data.pipeline import SlabRotatingLoader, collate_mel

    data = _slab_cache(tmp_path)
    # 10,756 bytes an item staged (bf16 mel, uint8 roll, lengths): 3 slabs of 6
    loader = SlabRotatingLoader(data, 3, device=cuda, pad_to=64, slab_bytes=8 * 10756,
                                passes_per_slab=2, seed=7, num_workers=2, bf16_fields=(0,),
                                u8_fields=(1,))
    assert loader.n_slabs == 3 and loader.items_per_slab == 6
    for epoch in range(2):
        expected = [slab[order[b * 3:(b + 1) * 3]] for slab, orders in loader.plan(epoch)
                    for order in orders for b in range(2)]
        batches = list(loader)
        assert len(batches) == len(expected) == 12
        for batch, idx in zip(batches, expected, strict=True):
            mel, roll, lengths = collate_mel([data[int(i)] for i in idx], pad_to=64)
            want = (torch.from_numpy(mel).to(torch.bfloat16).float(), torch.from_numpy(roll),
                    torch.from_numpy(lengths))
            for got, ref in zip(batch, want, strict=True):
                assert got.device.type == "cuda" and got.dtype == ref.dtype
                assert torch.equal(got.cpu(), ref)
    assert len(loader.stage_log) == 6 and all(s["copy_s"] > 0 for s in loader.stage_log)


def test_slab_prefetched_on_card_is_freed_on_an_early_break(cuda, tmp_path):
    """memory_allocated: after the first batch the current and the prefetched
    slab are held; after a break both are back with the allocator."""
    import threading
    import time

    from music_transcription_tpu_torch.data.pipeline import SlabRotatingLoader

    data = _slab_cache(tmp_path, n=40, n_mels=256, t=500)
    loader = SlabRotatingLoader(data, 4, device=cuda, pad_to=512, slab_bytes=4e6, seed=1,
                                num_workers=2, bf16_fields=(0,), u8_fields=(1,))
    assert (loader.n_slabs, loader.items_per_slab) == (4, 8)
    slab_bytes = loader.items_per_slab * loader.item_bytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    it = iter(loader)
    batch = next(it)
    deadline = time.monotonic() + 60
    while len(loader.stage_log) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(loader.stage_log) == 2
    assert torch.cuda.memory_allocated(cuda) - base >= 2 * slab_bytes
    del batch
    it.close()
    torch.cuda.synchronize()
    probe = torch.empty(1, device=cuda)  # the allocator settles the frees recorded on the stream
    assert torch.cuda.memory_allocated(cuda) - base <= 512
    del probe
    assert not [t for t in threading.enumerate() if t.name.startswith("slab-prefetch")]


# ---------------------------------------------------------------------------
# AST tier (no hand-written kernel): generation on the card against the CPU
# ---------------------------------------------------------------------------

AST_SMALL = dict(model_type="ast", remi_vocab_size=512, decoder_layers=2, decoder_dim=64,
                 decoder_heads=4, max_output_len=96, encoder_layers=2, encoder_dim=64,
                 encoder_heads=4, encoder_n_mels=64)
# card against CPU over the largest CPU logit: fp32 summation order (cuBLAS,
# no TF32); bf16 one bf16 ulp (2^-8) where a value rounds the other way
AST_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _ast_pair(dtype: str, cuda):
    torch.manual_seed(0)
    cpu = TranscriptionModel(ModelConfig(compute_dtype=dtype, **AST_SMALL)).eval()
    card = TranscriptionModel(ModelConfig(compute_dtype=dtype, **AST_SMALL)).eval()
    card.load_state_dict(cpu.state_dict())
    wave = torch.from_numpy((0.3 * np.random.default_rng(7).standard_normal((2, 24000)))
                            .astype(np.float32))
    return cpu, card.to(cuda), wave


def _near_tie_steps(cpu, wave, got, ref, tol):
    """Steps on which card and CPU tokens agree; each row's first departure
    must sit where the CPU's ranked logits (teacher-forced on the CPU's
    prefix, SOS masked) have a top-2 margin below ``tol``."""
    agreed = 0
    for row in range(ref.shape[0]):
        diff = (got[row] != ref[row]).nonzero()
        if len(diff) == 0:
            agreed += ref.shape[1]
            continue
        step = int(diff[0])
        seq = torch.cat([torch.zeros(1, dtype=torch.long), ref[row, :step]])[None]
        with torch.inference_mode():
            logits = cpu(wave[row:row + 1], targets=seq)[0, step].double()
            if step > 0:
                logits[0] = -1e9
            top2 = logits.sort().values[-2:]
        assert float(top2[1] - top2[0]) < tol, (row, step, float(top2[1] - top2[0]), tol)
        agreed += step
    return agreed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ast_on_card_matches_cpu(cuda, dtype):
    """Teacher-forced logits within AST_REL_TOL of the CPU's; 96 greedy tokens
    identical up to a near-tie."""
    cpu, card, wave = _ast_pair(dtype, cuda)
    tg = torch.from_numpy(np.random.default_rng(8).integers(3, 512, (2, 64)))
    tg[:, 0] = 0
    with torch.inference_mode():
        ref, got = cpu(wave, targets=tg), card(wave.to(cuda), targets=tg.to(cuda)).cpu()
        tol = AST_REL_TOL[dtype] * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol
        ref_ids = cpu(wave, generate_max_len=96)
        got_ids = card(wave.to(cuda), generate_max_len=96).cpu()
    assert _near_tie_steps(cpu, wave, got_ids, ref_ids, tol) >= 96


def test_ast_beam_on_card_matches_cpu(cuda):
    """Beam search reindexes its caches and buffers by a stable sort's
    parents: on the card as on the CPU (fp32), with and without the grammar
    mask, and the sort keeps index order among ties there too."""
    from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer
    from music_transcription_tpu_torch.models.transformer import _stable_top_k

    cpu, card, wave = _ast_pair("float32", cuda)
    mask = torch.from_numpy(REMITokenizer().transition_mask())
    for allowed in (None, mask):
        kw = dict(generate_max_len=96, beam_size=4)
        with torch.inference_mode():
            ref = cpu(wave, allowed_next=allowed, **kw)
            got = card(wave.to(cuda), allowed_next=None if allowed is None else allowed.to(cuda),
                       **kw).cpu()
        assert torch.equal(got, ref)
    ties = torch.tensor([[0.0, 1.0, 1.0, -1e9, 1.0, -1e9, -1e9] * 300])
    assert torch.equal(_stable_top_k(ties.to(cuda), 700)[1].cpu(), _stable_top_k(ties, 700)[1])


def test_ast_generation_makes_no_host_sync(cuda):
    """generate and generate_beam read nothing back to the host inside their
    loops: they run under torch.cuda.set_sync_debug_mode("error")."""
    from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer

    _, card, wave = _ast_pair("bfloat16", cuda)
    allowed = torch.from_numpy(REMITokenizer().transition_mask()).to(cuda)
    with torch.inference_mode():
        memory = card.model.memory(wave.to(cuda))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [card.model.generate(memory, max_len=32),
                    card.model.generate(memory, max_len=32, repetition_penalty=1.0,
                                        allowed_next=allowed),
                    card.model.generate(memory, max_len=32, do_sample=True, top_k=8),
                    card.model.generate_beam(memory, beam_size=4, max_len=32,
                                             allowed_next=allowed)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert all(o.shape == (2, 32) and o.device.type == "cuda" for o in outs)


# ---------------------------------------------------------------------------
# AST training (no hand-written kernel): the token step on the card
# ---------------------------------------------------------------------------

def _ast_train_inputs(cuda, batch=2, seconds=1.5, n_tok=48):
    rng = np.random.default_rng(11)
    wave = torch.from_numpy((0.3 * rng.standard_normal((batch, int(16000 * seconds))))
                            .astype(np.float32)).to(cuda)
    tokens = torch.from_numpy(rng.integers(3, 512, (batch, n_tok))).to(cuda)
    tokens[:, 0].fill_(0)
    return wave, tokens


def test_ast_token_step_makes_no_host_sync(cuda):
    """A warm token step (dropout 0.2, scheduled sampling 0.5, pitch weights,
    bf16) runs under torch.cuda.set_sync_debug_mode("error") until its loss
    is read: nothing in it copies a Python number to the card or reads one
    back."""
    from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer
    from music_transcription_tpu_torch.train import ast_step

    torch.manual_seed(0)
    model = TranscriptionModel(ModelConfig(dropout=0.2, **AST_SMALL)).to(cuda)
    opt = ast_step.make_adam(model.parameters(), 1e-4)
    wave, tokens = _ast_train_inputs(cuda)
    cw = torch.from_numpy(ast_step.pitch_class_weights(REMITokenizer(), 512, 3.0)).to(cuda)

    def step(s):
        gen, ss_gen = ast_step.step_generators(1, s, cuda)
        return ast_step.token_step(model, opt, wave, tokens, generator=gen, ss_p=0.5,
                                   ss_generator=ss_gen, class_weights=cw)

    first = float(step(0))  # builds the mel constants and the library plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [step(s) for s in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(np.isfinite(v) for v in [first] + [float(x) for x in losses])


def test_ast_frozen_encoder_is_bit_identical_after_3_steps(cuda):
    from music_transcription_tpu_torch.models.transformer import encoder_state_dict
    from music_transcription_tpu_torch.train import ast_step

    torch.manual_seed(1)
    model = TranscriptionModel(ModelConfig(freeze_encoder=True, **AST_SMALL)).to(cuda)
    before = {k: v.clone() for k, v in model.model.state_dict().items()}
    opt = ast_step.make_adam(model.parameters(), 1e-3)
    wave, tokens = _ast_train_inputs(cuda)
    for s in range(3):
        gen, _ = ast_step.step_generators(1, s, cuda)
        ast_step.token_step(model, opt, wave, tokens, generator=gen)
    after = model.model.state_dict()
    enc = encoder_state_dict(after)
    assert enc and all(torch.equal(v, before[k]) for k, v in enc.items())
    assert not torch.equal(after["output_fc.weight"], before["output_fc.weight"])


def test_ast_staged_compact_batches_equal_the_streamed_ones(cuda):
    """DeviceStagedLoader(compact_fields=(0,), limit) on the card against the
    streaming Loader: PCM16 waves come back bit for bit after the int16
    gather and dequantization, tokens equal, in the same order."""
    from music_transcription_tpu_torch.data.pipeline import (
        DeviceStagedLoader,
        Loader,
        collate_tokens,
    )

    rng = np.random.default_rng(12)
    items = [(rng.integers(-32768, 32768, 16000 + 1000 * i).astype(np.float32) / 32768,
              rng.integers(0, 512, 32)) for i in range(7)]
    kw = dict(shuffle=True, seed=2, drop_last=True, collate=collate_tokens, pad_to=18000)
    staged = DeviceStagedLoader(items, 2, device=cuda, limit=6, compact_fields=(0,), **kw)
    streamed = Loader(items[:6], 2, num_workers=0, **kw)
    assert staged.arrays[0].dtype == torch.int16 and staged.n == 6
    for _ in range(2):
        for (w, t), (sw, st) in zip(staged, streamed):
            assert w.device.type == "cuda" and w.dtype == torch.float32
            assert torch.equal(w.cpu(), torch.from_numpy(sw))
            assert torch.equal(t.cpu(), torch.from_numpy(st))


def _small_model_and_wavs(tmp_path, seconds=(5.0, 3.0)):
    """A seeded cnn_rnn_large at n_mels 64, hidden 32 (2 layers), 2 s
    chunks, as .pth + .json, and a WAV of each length in ``incoming/``."""
    torch.manual_seed(0)
    mcfg = ModelConfig(n_mels=64, hidden_size=32, num_layers=2)
    acfg = AudioConfig(n_mels=64, chunk_length=2.0)
    torch.save(TranscriptionModel(mcfg).model.state_dict(), tmp_path / "m.pth")
    (tmp_path / "m.json").write_text(json.dumps({"model": config_to_dict(mcfg),
                                                 "audio": config_to_dict(acfg)}))
    (tmp_path / "incoming").mkdir()
    sr, rng = 16000, np.random.default_rng(3)
    for i, s in enumerate(seconds):
        t = np.arange(int(s * sr)) / sr
        y = 0.3 * np.sin(2 * np.pi * 220.0 * (i + 1) * t) + 0.01 * rng.standard_normal(t.size)
        with wave.open(str(tmp_path / "incoming" / f"w{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())
    (tmp_path / "incoming" / "readme.txt").write_text("not audio")
    return tmp_path / "m.pth", sorted((tmp_path / "incoming").glob("*.wav"))


def test_serve_watch_once_on_card_gives_the_transcribers_notes(cuda, tmp_path, capsys):
    from music_transcription_tpu_torch import serve
    from music_transcription_tpu_torch.transcribe import Transcriber

    pth, wavs = _small_model_and_wavs(tmp_path)
    before = LK.lstm_recurrence.launches
    assert serve.main(["--model", str(pth), "--watch_dir", str(tmp_path / "incoming"),
                       "--out_dir", str(tmp_path / "out"), "--once"]) == 0
    assert LK.lstm_recurrence.launches == before + 3 * len(wavs)  # one forward a file
    assert capsys.readouterr().out.count(" -> ") == len(wavs)
    server = Transcriber(pth, device="cuda")
    for w in wavs:
        ref = server.transcribe_file(w, tmp_path / f"ref_{w.stem}.mid")
        got = load_midi(tmp_path / "out" / f"{w.stem}.mid").instruments[0].notes
        assert [(n.pitch, n.start, n.end) for n in got] == [
            (n.pitch, n.start, n.end) for n in load_midi(ref).instruments[0].notes]


def test_bench_attention_launches_the_flash_kernels_only_on_pallas(cuda):
    from music_transcription_tpu_torch.bench import attention

    rows = attention.run(attention.build_parser().parse_args(
        ["--t", "938", "--batch", "1", "--iters", "2", "--chain", "1"]))
    by = {r["backend"]: r for r in rows}
    assert by["xla"]["fwd_launches"] == {} and by["xla"]["fwdbwd_launches"] == {}
    assert by["pallas"]["fwd_launches"] == {"K3": 1.0}
    assert by["pallas"]["fwdbwd_launches"] == {"K3+lse": 1.0, "K4a": 1.0, "K4b": 1.0}
    assert all(r["fwd_ms"] > 0 and r["fwdbwd_ms"] > 0 for r in rows)


def test_bench_components_runs_the_lstm_tier_through_k2a_and_k2b(cuda, monkeypatch):
    from music_transcription_tpu_torch.bench import components

    monkeypatch.setattr(components, "CHUNK_LENGTH", 4.0)
    results = components.run(components.build_parser().parse_args(
        ["--batch_size", "2", "--n_mels", "64", "--iters", "1", "--chain", "2"]))
    assert results["lstm_tier"]["launches"] == {"K2a": 4.0, "K2b": 4.0}
    assert results["conv_stack"]["launches"] == {} and results["attention"]["launches"] == {}
    assert all(r["ms"] > 0 and r["tflops"] > 0 for r in results.values())
