#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. build the CUDA kernels in music_transcription_tpu_torch/csrc (one nvcc
     per source, all at once) and print ptxas's register / shared-memory /
     spill summary, and the card from nvidia-smi;
  2. hold every kernel against its plain PyTorch version on the card at the
     serving path's shapes (K1 at both routes' T; K3 in bf16 and, for
     compute_dtype="float32", fp32) and time both (CUDA events), with a
     library call as a yardstick where PyTorch has one;
  3. serve the default 89M cnn_rnn_large (seeded random weights, .pth + .json)
     on a seeded ~2 min WAV through transcribe_audio on cuda: the MIDI must
     decode and the K1 counter must rise by 4 per forward; time a warm
     request and break one down (host stages, device time by kernel); check
     the full model on the card against the same model on the CPU on a
     short input;
  4. the long-window route (-w 120) on a seeded ~8 min WAV (4 windows):
     the clamped flash kernel K3 must run and the MIDI must decode; time a
     warm request and break it down as in phase 3;
  5. hold the training kernels against their plain versions at the training
     shapes and time them: K2a and K2b (batch 24: 2B=48, T=938, H=512 and
     256) beside cuDNN's bidirectional LSTM forward and backward, and the
     LSTMRecurrence gradient against autograd through the plain recurrence;
     K3 with lse, K4a and K4b (B=24, T=938, 8 heads of 192) in bf16 and
     fp32, element by element, with the scores of a backward without the
     clamp gate and of one skipping the last partial key tile, both of
     which must fail the bound;
  6. train the default 89M cnn_rnn_large (TrainConfig defaults, batch 24)
     through the training CLI on a seeded synthetic cache written here (48
     train and 24 validation chunks of 30 s): 2 epochs of 2 steps with the
     cache staged on the card. The loss must be finite with no step skipped,
     K2a and K2b must rise by 4 per train step and K1 by 4 per validation
     batch; model_best must serve the phase-3 WAV; --resume auto must
     continue from model_epoch_2. Then time warm train steps, profile one,
     and hold one full-width fp32 step on the card against the CPU;
  7. the same through the flash attention: ModelConfig(attention_backend=
     "pallas") into train/loop.train_model on the same cache, 2 epochs of 2
     steps. Per train step K3 with lse, K4a and K4b must rise by 1 and K2a,
     K2b by 4; per validation batch K3 (no lse) by 1 and K1 by 4; model_best's
     sidecar must say "pallas". Warm steps timed beside phase 6's, one
     profiled, and one full-width fp32 flash step on the card against the CPU;
  8. evaluate on the card with python -m music_transcription_tpu_torch.evaluate
     (in this process): phase 7's model_best on the cache's validation split
     with a tuned threshold (K1 4 and K3 1 per batch of 8), and phase 6's
     model_best at --window 120 on a seeded raw MAESTRO-layout tree written
     here, where "auto" must take K3;
  9. print the kernels line (JSON: launches on the main path, error against
     the plain version, times, bound; a failed check has already exited),
     the card's name and power limit, and as the last line
     {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import wave

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
SEED = 0
# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, bf16 dense tensor cores, HBM3 bandwidth
PEAK_FP32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, peak: float, nbytes: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def write_wav(path, seconds: float, seed: int, sr: int = 16000):
    """Seeded piano-like test signal: decaying harmonic tones plus noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    y = 0.01 * rng.standard_normal(n)
    for start in np.arange(0.0, seconds - 1.0, 0.5):
        pitch = int(rng.integers(40, 90))
        f = 440.0 * 2 ** ((pitch - 69) / 12)
        s, e = int(start * sr), int(min(seconds, start + 1.0) * sr)
        env = np.exp(-3.0 * (t[s:e] - start))
        y[s:e] += 0.2 * env * sum(np.sin(2 * np.pi * f * k * t[s:e]) / k for k in (1, 2, 3))
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())


def check_k1(torch, lk, rows):
    """K1 against its plain version at the serving shapes: T=938 (30 s
    chunks; 2B=8 for a 4-chunk request, 32 for 16 chunks) and T=3751 (-w 120,
    4 windows), H=512 (rnn_main) and 256 (rnn_local). Returns the record for
    2B=8, T=938, H=512."""
    rng = np.random.default_rng(SEED)
    record = None
    for two_b, t, hidden in ((8, 938, 512), (8, 938, 256), (32, 938, 512), (32, 938, 256),
                             (8, 3751, 512), (8, 3751, 256)):
        xw = torch.from_numpy(rng.standard_normal((two_b, t, 4 * hidden)).astype(np.float32)).cuda()
        k = 1.0 / np.sqrt(hidden)
        wh = torch.from_numpy(rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(np.float32)).cuda()
        got = lk.lstm_recurrence(xw, wh)
        ref = lk.lstm_recurrence_plain(xw, wh)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # fp32, a different summation order over T sequential steps
        ok = err <= 1e-4 and bool(torch.isfinite(got).all())
        ms = cuda_ms(lambda: lk.lstm_recurrence(xw, wh), reps=10)
        plain_ms = cuda_ms(lambda: lk.lstm_recurrence_plain(xw, wh), reps=2)
        lstm = torch.nn.LSTM(2 * hidden, hidden, batch_first=True, bidirectional=True).cuda()
        x = torch.randn(two_b // 2, t, 2 * hidden, device="cuda")
        with torch.no_grad():
            library_ms = cuda_ms(lambda: lstm(x), reps=10)
        flops = 2.0 * two_b * t * hidden * 4 * hidden
        nbytes = 4.0 * (xw.numel() + wh.numel() + got.numel())
        b_ms, b_by = bound(flops, PEAK_FP32, nbytes)
        rows.append(f"K1 2B={two_b} T={t} H={hidden}: max_abs_err={err:.3e} ms={ms:.4f} "
                    f"plain_ms={plain_ms:.3f} cudnn_lstm_ms={library_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(rows[-1])
        if (two_b, t, hidden) == (8, 938, 512):
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=library_ms)
    return record


def check_k2(torch, lk, rows):
    """K2a and K2b against their plain versions at the training shapes (batch
    24: 2B=48, T=938; H=512 for rnn_main, 256 for rnn_local), and the
    LSTMRecurrence gradient against autograd through the plain recurrence at
    a small shape. Returns the records of K2a and K2b at H=512."""
    rng = np.random.default_rng(SEED + 4)
    records = {}
    for two_b, t, hidden in ((48, 938, 512), (48, 938, 256)):
        xw = torch.from_numpy(rng.standard_normal((two_b, t, 4 * hidden)).astype(np.float32)).cuda()
        k = 1.0 / np.sqrt(hidden)
        wh = torch.from_numpy(rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(np.float32)).cuda()
        dh = torch.from_numpy(rng.standard_normal((two_b, t, hidden)).astype(np.float32)).cuda()
        h, c = lk.lstm_recurrence_fwd(xw, wh)
        ref_h, ref_c = lk.lstm_recurrence_fwd_plain(xw, wh)
        dxw = lk.lstm_recurrence_bwd(xw, wh, ref_h, ref_c, dh)
        ref_dxw = lk.lstm_recurrence_bwd_plain(xw, wh, ref_h, ref_c, dh)
        dwh = lk.recurrent_weight_grad(ref_h, dxw)
        ref_dwh = lk.recurrent_weight_grad(ref_h, ref_dxw)
        torch.cuda.synchronize()
        # fp32, a different summation order over T sequential steps: h and c
        # to 1e-4 absolute as K1; the gradients, which grow with the sums
        # over T, to 1e-4 of their largest magnitude
        fwd_err = max(float((h - ref_h).abs().max()), float((c - ref_c).abs().max()))
        dxw_err = float((dxw - ref_dxw).abs().max())
        dwh_err = float((dwh - ref_dwh).abs().max())
        dxw_tol = 1e-4 * float(ref_dxw.abs().max())
        dwh_tol = 1e-4 * float(ref_dwh.abs().max())
        ok_fwd = fwd_err <= 1e-4 and bool(torch.isfinite(h).all() and torch.isfinite(c).all())
        ok_bwd = dxw_err <= dxw_tol and dwh_err <= dwh_tol and bool(torch.isfinite(dxw).all())
        fwd_ms = cuda_ms(lambda: lk.lstm_recurrence_fwd(xw, wh), reps=5)
        bwd_ms = cuda_ms(lambda: lk.lstm_recurrence_bwd(xw, wh, h, c, dh), reps=5)
        fwd_plain_ms = cuda_ms(lambda: lk.lstm_recurrence_fwd_plain(xw, wh), reps=1)
        bwd_plain_ms = cuda_ms(lambda: lk.lstm_recurrence_bwd_plain(xw, wh, h, c, dh), reps=1)
        # library yardstick: one cuDNN bidirectional layer (input 2H, with its
        # own input projection), forward in training mode, then its backward
        lstm = torch.nn.LSTM(2 * hidden, hidden, batch_first=True, bidirectional=True).cuda()
        x = torch.randn(two_b // 2, t, 2 * hidden, device="cuda", requires_grad=True)
        lib_fwd_ms = cuda_ms(lambda: lstm(x), reps=5)
        y, _ = lstm(x)
        gy = torch.randn_like(y)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, [x, *lstm.parameters()], gy,
                                                         retain_graph=True), reps=5)
        flops = 2.0 * two_b * t * hidden * 4 * hidden
        fwd_bound = bound(flops, PEAK_FP32, 4.0 * (xw.numel() + wh.numel() + 2 * h.numel()))
        # the backward: the gate product again and the dh product of the same size
        bwd_bound = bound(2 * flops, PEAK_FP32,
                          4.0 * (2 * xw.numel() + wh.numel() + 3 * h.numel()))
        for name, err, tol, ok, ms, plain_ms, lib_ms, (b_ms, b_by) in (
                ("K2a", fwd_err, 1e-4, ok_fwd, fwd_ms, fwd_plain_ms, lib_fwd_ms, fwd_bound),
                ("K2b", max(dxw_err / dxw_tol, dwh_err / dwh_tol) * 1e-4, 1e-4, ok_bwd, bwd_ms,
                 bwd_plain_ms, lib_bwd_ms, bwd_bound)):
            detail = (f"max_abs_err={err:.3e} (tol {tol:g})" if name == "K2a" else
                      f"dxw max_abs_err={dxw_err:.3e} (tol {dxw_tol:.3e}), dW_hh "
                      f"max_abs_err={dwh_err:.3e} (tol {dwh_tol:.3e})")
            rows.append(f"{name} 2B={two_b} T={t} H={hidden}: {detail} ms={ms:.4f} "
                        f"plain_ms={plain_ms:.3f} cudnn_lstm_ms={lib_ms:.4f} "
                        f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(rows[-1])
            if hidden == 512:
                records[name] = dict(max_abs_err=dxw_err if name == "K2b" else err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                     library_ms=lib_ms)
        del xw, wh, dh, h, c, ref_h, ref_c, dxw, ref_dxw, lstm, x, y, gy

    # the autograd Function against autograd through the plain recurrence
    xw = torch.from_numpy(rng.standard_normal((6, 37, 4 * 48)).astype(np.float32)).cuda()
    wh = torch.from_numpy((0.2 * rng.standard_normal((2, 48, 4 * 48))).astype(np.float32)).cuda()
    dh = torch.from_numpy(rng.standard_normal((6, 37, 48)).astype(np.float32)).cuda()
    grads = []
    for fn in (lk.LSTMRecurrence.apply, lk.lstm_recurrence_plain):
        a, w = xw.clone().requires_grad_(), wh.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(a, w), (a, w), dh))
    for name, got, ref in zip(("dxw", "dW_hh"), grads[0], grads[1]):
        err, tol = float((got - ref).abs().max()), 1e-4 * float(ref.abs().max())
        rows.append(f"LSTMRecurrence {name} 2B=6 T=37 H=48 vs autograd through the plain "
                    f"recurrence: max_abs_err={err:.3e} (tol {tol:.3e}) "
                    f"{'ok' if err <= tol else 'FAIL'}")
        if err > tol:
            raise AssertionError(rows[-1])
    return records


# K3 against its plain version, element by element:
#   |got - ref| <= rtol |ref| + ptol (P|V|),  P|V| = softmax(clip(q k^T)) @ |v|.
# bf16: both versions round the output to bf16 (half a unit in the last
# place each, 2^-8 |o|) and round every probability to bf16 (2^-9 of p each),
# at different points: the kernel before dividing by the row sum, the plain
# version after. So |got - ref| <= 2^-7 |ref| + 2^-8 (P|V|); the bounds below
# are twice that. fp32: only the summation order differs.
K3_TOL = {"bfloat16": (2.0**-6, 2.0**-7), "float32": (1e-5, 1e-5)}
K3_KEY_TILE = {"bfloat16": 64, "float32": 32}


def k3_score(got, ref, ref_abs_v, dtype: str) -> float:
    """Largest |got - ref| / (rtol |ref| + ptol (P|V|)): <= 1 passes."""
    rtol, ptol = K3_TOL[dtype]
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() / (rtol * ref.abs() + ptol * ref_abs_v.float())).max())


def check_k3(torch, ak, rows):
    """K3 against its plain version at the -w 120 shape (4 windows), bf16 (the
    serving path) and fp32 (compute_dtype="float32"). Returns the bf16 record."""
    from music_transcription_tpu_torch.ops.precision import full_fp32

    rng = np.random.default_rng(SEED + 1)
    b, t, nh, d = 4, 3751, 8, 192
    scale = d**-0.5
    # q scaled so that a share of the logits passes the +-10 clamp
    q32, k32, v32 = (torch.from_numpy(m * rng.standard_normal((b, t, nh, d)).astype(np.float32)).cuda()
                     for m in (4.0, 1.0, 1.0))
    clamped = float(((torch.einsum("bthd,bshd->bhts", q32[:1], k32[:1]) * scale).abs() > 10)
                    .float().mean())
    record = None
    for dtype, elt in (("bfloat16", 2.0), ("float32", 4.0)):
        q, k, v = (x.to(getattr(torch, dtype)) for x in (q32, k32, v32))
        with full_fp32():
            got = ak.flash_attention_clamped(q, k, v, scale, 10.0)
            ref = ak.attention_clamped_plain(q, k, v, scale, 10.0)
            ref_abs_v = ak.attention_clamped_plain(q, k, v.abs(), scale, 10.0)
            # what a kernel that skipped the last partial key tile would give
            kept = t // K3_KEY_TILE[dtype] * K3_KEY_TILE[dtype]
            skipped = ak.attention_clamped_plain(q, k[:, :kept], v[:, :kept], scale, 10.0)
            torch.cuda.synchronize()
            score = k3_score(got, ref, ref_abs_v, dtype)
            fault = k3_score(skipped, ref, ref_abs_v, dtype)
            err = float((got.float() - ref.float()).abs().max())
            rms = float(ref.float().pow(2).mean().sqrt())
            ms = cuda_ms(lambda: ak.flash_attention_clamped(q, k, v, scale, 10.0), reps=5)
            plain_ms = cuda_ms(lambda: ak.attention_clamped_plain(q, k, v, scale, 10.0), reps=2)
        flops = 4.0 * b * nh * t * t * d
        nbytes = elt * 4 * q.numel()
        b_ms, b_by = bound(flops, PEAK_BF16 if dtype == "bfloat16" else PEAK_FP32, nbytes)
        rtol, ptol = K3_TOL[dtype]
        ok = score <= 1.0 and fault > 1.0 and bool(torch.isfinite(got.float()).all())
        rows.append(f"K3 {dtype} B={b} T={t} heads={nh} D={d}: max_abs_err={err:.3e}, rms(ref) "
                    f"{rms:.3e}, rms(P|V|) {float(ref_abs_v.float().pow(2).mean().sqrt()):.3e}, "
                    f"worst |err|/({rtol:g}|ref| + {ptol:g}P|V|) {score:.3f} (a kernel "
                    f"skipping the last {t - kept} keys: {fault:.1f}), clamped share "
                    f"{clamped:.4f}; ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} "
                    f"({b_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(rows[-1])
        if dtype == "bfloat16":
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
    return record


# K3 with lse, K4a and K4b against their plain versions, element by element:
#   |got - ref| <= rtol |ref| + ptol m,
# m the same product over magnitudes: |dS| |K| for dq, |dS|^T |Q| for dk,
# P^T |dO| for dv. bf16: both versions round dS and p to bf16 before the
# products; where their fp32 values straddle a rounding boundary, a term
# comes out one bf16 unit (up to 2^-7 of it, so up to 2^-7 m) apart, and the
# bound allows two such terms of the largest size: ptol 2^-6. Both round the
# fp32 results to bf16 (a unit, 2^-8 |ref|, apart at most): rtol 2^-7. fp32:
# summation order only. The forward's o is held to K3_TOL, its lse to
# 1e-5 |lse| + 1e-5 (fp32 summation order).
K4_TOL = {"bfloat16": (2.0**-7, 2.0**-6), "float32": (1e-4, 1e-5)}
K4_KEY_TILE = {"bfloat16": 64, "float32": 32}  # K4a's key tile


def attention_grad_terms(torch, q, k, v, o, do, lse, scale, clip, *, gate=True, keys=None):
    """fp32 (dq, dk, dv) of the clamped attention from the first ``keys``
    keys (dk and dv 0 past them), with or without the clamp gate on dS, and
    their magnitudes (|dS| |K|, |dS|^T |Q|, P^T |dO|); all (B, T, H, D)."""
    q, k, v, o, do = (x.float() for x in (q, k, v, o, do))
    keys = q.shape[1] if keys is None else keys
    ks, vs = k[:, :keys], v[:, :keys]
    z = torch.einsum("bthd,bshd->bhts", q, ks) * scale
    p = torch.exp(torch.clamp(z, -clip, clip) - lse[..., None])
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (torch.einsum("bthd,bshd->bhts", do, vs) - delta) * scale
    if gate:
        ds = torch.where((z >= -clip) & (z <= clip), ds, torch.zeros_like(ds))
    del z, delta

    def pad(x):  # key rows past ``keys`` get no gradient
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, q.shape[1] - keys))

    grads = (torch.einsum("bhts,bshd->bthd", ds, ks),
             pad(torch.einsum("bhts,bthd->bshd", ds, q)),
             pad(torch.einsum("bhts,bthd->bshd", p, do)))
    ds = ds.abs_()
    mags = (torch.einsum("bhts,bshd->bthd", ds, ks.abs()),
            pad(torch.einsum("bhts,bthd->bshd", ds, q.abs())),
            pad(torch.einsum("bhts,bthd->bshd", p, do.abs())))
    return grads, mags


def k4_score(got, ref, mag, dtype: str) -> float:
    """Largest |got - ref| / (rtol |ref| + ptol m) over dq, dk, dv: <= 1 passes."""
    rtol, ptol = K4_TOL[dtype]
    return max(float(((g.float() - r.float()).abs() / (rtol * r.float().abs() + ptol * m)).max())
               for g, r, m in zip(got, ref, mag))


def check_k4(torch, ak, rows):
    """K3 with lse, K4a and K4b against their plain versions at the training
    shape (batch 24: B=24, T=938, 8 heads of 192), bf16 (the training path)
    and fp32 (compute_dtype="float32"), q scaled so that the clamp binds on
    a share of the logits. Returns the bf16 records of the three."""
    from music_transcription_tpu_torch.ops.precision import full_fp32

    rng = np.random.default_rng(SEED + 8)
    b, t, nh, d = 24, 938, 8, 192
    scale, clip = d**-0.5, 10.0
    q32, k32, v32, do32 = (torch.from_numpy(m * rng.standard_normal((b, t, nh, d))
                                            .astype(np.float32)).cuda()
                           for m in (6.0, 1.0, 1.0, 1.0))
    clamped = float(((torch.einsum("bthd,bshd->bhts", q32[:1], k32[:1]) * scale).abs() > clip)
                    .float().mean())
    records = {}
    for dtype, elt in (("bfloat16", 2.0), ("float32", 4.0)):
        q, k, v, do = (x.to(getattr(torch, dtype)) for x in (q32, k32, v32, do32))
        with full_fp32():
            o, lse = ak.flash_attention_clamped_fwd(q, k, v, scale, clip)
            ref_o, ref_lse = ak.attention_clamped_fwd_plain(q, k, v, scale, clip)
            ref_abs_v = ak.attention_clamped_plain(q, k, v.abs(), scale, clip)
            # the backward's inputs are the plain forward's, for both versions
            dq = ak.flash_attention_clamped_dq(q, k, v, ref_o, do, ref_lse, scale, clip)
            dk, dv = ak.flash_attention_clamped_dkv(q, k, v, ref_o, do, ref_lse, scale, clip)
            ref = ak.attention_clamped_bwd_plain(q, k, v, ref_o, do, ref_lse, scale, clip)
            torch.cuda.synchronize()
            fwd_score = k3_score(o, ref_o, ref_abs_v, dtype)
            lse_err = float((lse - ref_lse).abs().max())
            lse_ok = bool(((lse - ref_lse).abs() <= 1e-5 * ref_lse.abs() + 1e-5).all())
            del ref_abs_v
            _, mag = attention_grad_terms(torch, q, k, v, ref_o, do, ref_lse, scale, clip)
            got = (dq, dk, dv)
            score = k4_score(got, ref, mag, dtype)
            # what a backward without the clamp gate, or one that skipped the
            # last partial key tile, would give
            ungated, _ = attention_grad_terms(torch, q, k, v, ref_o, do, ref_lse, scale, clip,
                                              gate=False)
            fault_gate = k4_score(ungated, ref, mag, dtype)
            del ungated
            kept = t // K4_KEY_TILE[dtype] * K4_KEY_TILE[dtype]
            skipped, _ = attention_grad_terms(torch, q, k, v, ref_o, do, ref_lse, scale, clip,
                                              keys=kept)
            fault_tile = k4_score(skipped, ref, mag, dtype)
            del skipped, mag
            errs = [float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref)]
            fwd_ms = cuda_ms(lambda: ak.flash_attention_clamped_fwd(q, k, v, scale, clip), reps=5)
            dq_ms = cuda_ms(lambda: ak.flash_attention_clamped_dq(q, k, v, ref_o, do, ref_lse,
                                                                  scale, clip), reps=5)
            dkv_ms = cuda_ms(lambda: ak.flash_attention_clamped_dkv(q, k, v, ref_o, do, ref_lse,
                                                                    scale, clip), reps=5)
            fwd_plain_ms = cuda_ms(lambda: ak.attention_clamped_fwd_plain(q, k, v, scale, clip),
                                   reps=2)
            bwd_plain_ms = cuda_ms(lambda: ak.attention_clamped_bwd_plain(
                q, k, v, ref_o, do, ref_lse, scale, clip), reps=2)
        peak = PEAK_BF16 if dtype == "bfloat16" else PEAK_FP32
        prod = 2.0 * b * nh * t * t * d  # one (T x T) by D product of every head
        x_bytes, lse_bytes = elt * q.numel(), 4.0 * lse.numel()
        # K3: q k^T, P v; K4a: + dO v^T, dS k; K4b: q k^T, dO v^T, P^T dO, dS^T q.
        # Bytes: q, k, v (and o, dO, lse) read once, o / dq / dk and dv written once
        bounds = {"K3+lse": bound(2 * prod, peak, 4 * x_bytes + lse_bytes),
                  "K4a": bound(3 * prod, peak, 6 * x_bytes + lse_bytes),
                  "K4b": bound(4 * prod, peak, 7 * x_bytes + lse_bytes)}
        ok = (fwd_score <= 1.0 and lse_ok and score <= 1.0 and fault_gate > 1.0
              and fault_tile > 1.0 and all(bool(torch.isfinite(g.float()).all()) for g in got))
        rtol, ptol = K4_TOL[dtype]
        rows.append(
            f"K3+lse/K4a/K4b {dtype} B={b} T={t} heads={nh} D={d}: o worst |err|/K3_TOL "
            f"{fwd_score:.3f}, lse max_abs_err {lse_err:.3e}; dq/dk/dv max_abs_err "
            f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, worst |err|/({rtol:g}|ref| + {ptol:g}m) "
            f"{score:.3f} (a backward without the clamp gate: {fault_gate:.1f}; one skipping "
            f"the last {t - kept} keys: {fault_tile:.1f}), clamped share {clamped:.4f}; "
            f"ms K3+lse {fwd_ms:.4f} K4a {dq_ms:.4f} K4b {dkv_ms:.4f}; plain ms fwd "
            f"{fwd_plain_ms:.3f} bwd {bwd_plain_ms:.3f}; bound ms "
            + ", ".join(f"{n} {v[0]:.4f} ({v[1]})" for n, v in bounds.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(rows[-1])
        if dtype == "bfloat16":
            for name, err, ms, plain_ms in (("K3+lse", float((o.float() - ref_o.float()).abs().max()),
                                             fwd_ms, fwd_plain_ms),
                                            ("K4a", errs[0], dq_ms, bwd_plain_ms),
                                            ("K4b", max(errs[1:]), dkv_ms, bwd_plain_ms)):
                records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bounds[name][0], bound_by=bounds[name][1],
                                     library_ms=None)
        del q, k, v, do, o, lse, ref_o, ref_lse, dq, dk, dv, ref, got
    return records


def conv_stage_bounds() -> dict:
    """Bounds of K5 and K6, still to port, at the stages of the default
    cnn_rnn_large they would replace on the 30 s route (4 chunks: B=4, 320
    mel bins, T=938, bf16): conv1 + BN + ReLU + pool (K5), res_block1 + pool
    and res_block2 (K6, its two 3x3 convs and the 1x1 skip). Operations at
    the bf16 tensor-core peak; bytes: input, weights and output once."""
    b, t = 4, 938
    out = {}
    for name, f, c_in, convs, c_out, pool in (
            ("K5 conv1+pool", 320, 1, [(9, 1, 32)], 32, True),
            ("K6 res_block1+pool", 160, 32, [(9, 32, 64), (9, 64, 64), (1, 32, 64)], 64, True),
            ("K6 res_block2", 80, 64, [(9, 64, 128), (9, 128, 128), (1, 64, 128)], 128, False)):
        pixels = b * f * t
        weights = sum(k * ci * co for k, ci, co in convs)
        flops = 2.0 * pixels * weights
        nbytes = 2.0 * (pixels * c_in + weights + pixels * c_out // (2 if pool else 1))
        out[name] = (flops, nbytes, *bound(flops, PEAK_BF16, nbytes))
    return out


def device_time_by_kernel(prof, wall_s: float, top: int = 12):
    """Print a profile's device busy time, idle share and top kernels."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_us = wall_s * 1e6
    print(f"      device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
          f"(idle share {1 - busy_us / wall_us:.3f})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"      {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def profile_request(torch, server, y):
    """Where a warm request's time goes: host stages (clock around work that
    ends in a synchronize) and device time by kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from music_transcription_tpu_torch.data.midi import pianoroll_to_notes
    from music_transcription_tpu_torch.transcribe import transcribe_chunks

    acfg = server.loaded.audio_cfg
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunks = server.split(y)
        t1 = time.perf_counter()
        roll = transcribe_chunks(server.loaded, chunks, server.threshold)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        notes = pianoroll_to_notes(roll, fs=acfg.frame_rate)
        t3 = time.perf_counter()
    print(f"    profile: split {(t1 - t0) * 1e3:.2f} ms, mel+model+threshold+copy "
          f"{(t2 - t1) * 1e3:.2f} ms, decode {len(notes)} notes {(t3 - t2) * 1e3:.2f} ms")
    device_time_by_kernel(prof, t3 - t0)


# Card against CPU, one fp32 step, gradient by gradient: |card - cpu| over the
# CPU gradient's largest magnitude. "rnn" (the BiLSTMs, through K2a/K2b) and
# "rest" (attention, norm, heads) to 1e-3; "cnn" (convolutions and their
# BatchNorms) to 1e-2: under a training-mode BatchNorm, whose backward makes
# each channel's gradient zero-mean, their gradients sum 10^4-10^5 terms per
# channel that cancel, and both devices round those sums differently. The
# biases of convolutions that feed a BatchNorm have an exact gradient of 0
# (the BatchNorm removes them): "bn-fed bias" holds what both devices leave
# there to 1e-6 of the largest gradient of the model.
GRAD_TOL = {"rnn": 1e-3, "rest": 1e-3, "cnn": 1e-2, "bn-fed bias": 1e-6}


def grad_agreement(torch, cpu_model, card_model) -> dict:
    """The worst ratio of each class of GRAD_TOL, with its parameter name
    (every convolution of the model feeds a BatchNorm)."""
    cnn = {f"{m}.{p}": type(mod) for m, mod in cpu_model.named_modules()
           if isinstance(mod, (torch.nn.Conv2d, torch.nn.BatchNorm2d)) for p in ("weight", "bias")}
    card = dict(card_model.named_parameters())
    g_max = max(float(p.grad.abs().max()) for p in cpu_model.parameters())
    worst = {k: (0.0, "") for k in GRAD_TOL}
    for name, p in cpu_model.named_parameters():
        other = card[name].grad.cpu()
        if cnn.get(name) is torch.nn.Conv2d and name.endswith(".bias"):
            kind = "bn-fed bias"
            ratio = max(float(p.grad.abs().max()), float(other.abs().max())) / g_max
        else:
            kind = "cnn" if name in cnn else "rnn" if ".rnn_" in name else "rest"
            ratio = float((other - p.grad).abs().max()) / float(p.grad.abs().max())
        if ratio > worst[kind][0]:
            worst[kind] = (ratio, name.removeprefix("model."))
    return worst


def write_train_cache(path, acfg, seed: int, n_train: int = 48, n_val: int = 24) -> None:
    """A seeded cache in the native format (data/cache.py): 30 s chunks of
    log-mel-like noise (dB) and piano rolls of random sustained notes."""
    from music_transcription_tpu_torch.data import cache

    rng = np.random.default_rng(seed)
    t = acfg.mel_frames_per_chunk
    for split, n in (("train", n_train), ("validation", n_val)):
        for i in range(n):
            roll = np.zeros((88, t), np.uint8)
            for _ in range(40):
                key, start = int(rng.integers(0, 88)), int(rng.integers(0, t))
                roll[key, start:start + int(rng.integers(10, 120))] = 1
            mel = (rng.standard_normal((acfg.n_mels, t)) * 10.0 - 40.0).astype(np.float32)
            cache.save_chunk(os.path.join(path, split), i, {"mel": mel, "roll": roll})
        cache.save_metadata(path, split, {
            "num_chunks": n, "chunk_length": acfg.chunk_length, "overlap": 0.0,
            "n_mels": acfg.n_mels, "sr": acfg.sample_rate, "hop_length": acfg.hop_length})


def write_maestro_tree(root, seed: int, seconds: float = 121.0, pieces: int = 2) -> None:
    """A seeded raw MAESTRO-v3 layout (CSV + WAV + MIDI): ``pieces`` recordings
    of the test split, each a ``write_wav`` signal with a MIDI file of random
    notes."""
    import csv

    from music_transcription_tpu_torch.data import midi as midi_io

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(pieces):
        rel_wav, rel_mid = f"2018/piece{i}.wav", f"2018/piece{i}.midi"
        os.makedirs(os.path.join(root, "2018"), exist_ok=True)
        write_wav(os.path.join(root, rel_wav), seconds, seed + i)
        starts = np.sort(rng.random(200) * (seconds - 1.0))
        notes = [midi_io.Note(pitch=int(p), start=float(s), end=float(s + d), velocity=80)
                 for p, s, d in zip(rng.integers(30, 100, 200), starts, 0.1 + rng.random(200))]
        midi_io.save_midi(midi_io.notes_to_midi(notes), os.path.join(root, rel_mid))
        rows.append({"canonical_composer": "Seeded", "canonical_title": f"Piece {i}",
                     "split": "test", "year": 2018, "midi_filename": rel_mid,
                     "audio_filename": rel_wav, "duration": seconds})
    with open(os.path.join(root, "maestro-v3.0.0.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def run_evaluate(argv) -> dict:
    """``python -m music_transcription_tpu_torch.evaluate`` in this process
    (so that its launches are counted): its EVAL_* lines, or raises."""
    import io

    from music_transcription_tpu_torch import evaluate

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = evaluate.main(argv)
    if rc != 0:
        raise AssertionError(f"evaluate {argv} exited {rc}:\n{out.getvalue()[-3000:]}")
    return {line.split("=")[0]: float(line.split("=")[1]) for line in out.getvalue().splitlines()
            if line.startswith("EVAL_")}


@contextlib.contextmanager
def recorded_steps():
    """train/loop's train steps, recorded with their host time (each ends in
    a host read of its loss): yields the list they are appended to."""
    from music_transcription_tpu_torch.train import loop as train_loop

    steps, real_step = [], train_loop.train_step

    def recorded_step(*args, **kwargs):
        t_start = time.perf_counter()
        metrics = real_step(*args, **kwargs)
        steps.append(dict(metrics, ms=(time.perf_counter() - t_start) * 1e3))
        return metrics

    train_loop.train_step = recorded_step
    try:
        yield steps
    finally:
        train_loop.train_step = real_step


def train_phase(torch, lk, ak, wav30, rows):
    """Phase 6. Returns the main path's launch counts, the median warm step
    (ms) and the path of model_best."""
    from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, TrainConfig
    from music_transcription_tpu_torch.data.midi import load_midi
    from music_transcription_tpu_torch.train import __main__ as train_cli
    from music_transcription_tpu_torch.transcribe import transcribe_audio

    acfg, mcfg, tcfg = AudioConfig(), ModelConfig(), TrainConfig()
    cache_dir, run_dir = os.path.join(WORK, "train_cache"), os.path.join(WORK, "train_run")
    shutil.rmtree(run_dir, ignore_errors=True)  # a fresh run: its log and checkpoints
    t0 = time.perf_counter()
    write_train_cache(cache_dir, acfg, SEED + 6)
    print(f"[6] training: cache of 48 train + 24 validation chunks written in "
          f"{time.perf_counter() - t0:.1f} s")

    argv = ["--cache_dir", cache_dir, "--root_dir", os.path.join(WORK, "no_raw_audio"),
            "--run_dir", run_dir, "--save_every", "1", "--device_data", "on",
            "--num_workers", "4", "--seed", str(SEED)]
    with recorded_steps() as steps:
        for counter in (lk.lstm_recurrence, lk.lstm_recurrence_fwd, lk.lstm_recurrence_bwd,
                        ak.flash_attention_clamped):
            counter.launches = 0
        t0 = time.perf_counter()
        rc = train_cli.main(argv + ["--epochs", "2"])
        wall = time.perf_counter() - t0
        launches = {"lstm_recurrence": lk.lstm_recurrence.launches,
                    "lstm_recurrence_fwd": lk.lstm_recurrence_fwd.launches,
                    "lstm_recurrence_bwd": lk.lstm_recurrence_bwd.launches,
                    "flash_attention_clamped": ak.flash_attention_clamped.launches}
    with open(os.path.join(run_dir, "training_log.txt")) as f:
        log = [line.split() for line in f if line.strip()]
    losses = [float(r[k].split("=")[1]) for r in log for k in (2, 3)]
    n_val_batches = 1  # 24 validation chunks, batch 24
    print(f"    CLI: 2 epochs x {len(steps) // 2} steps, rc {rc}, wall {wall:.1f} s (kernels "
          f"loaded, data staged); step losses {[round(m['loss'], 5) for m in steps]}, skipped "
          f"{sum(m['skipped'] for m in steps)}, step ms {[round(m['ms'], 1) for m in steps]}, "
          f"epoch train/val losses {losses}; launches {launches}")
    if (rc != 0 or len(steps) != 4 or any(m["skipped"] for m in steps)
            or not all(np.isfinite(m["loss"]) for m in steps + [{"loss": v} for v in losses])):
        raise AssertionError("training run failed")
    if (launches["lstm_recurrence_fwd"] != 4 * len(steps)
            or launches["lstm_recurrence_bwd"] != 4 * len(steps)
            or launches["lstm_recurrence"] != 4 * n_val_batches * 2):
        raise AssertionError(f"training missed a kernel: {launches}")

    # model_best serves
    best = os.path.join(run_dir, "checkpoints", "model_best.pth")
    mid = os.path.join(WORK, "request_trained.mid")
    k1 = lk.lstm_recurrence.launches
    transcribe_audio(wav30, best, mid, verbose=False, device="cuda")
    n_notes = len(load_midi(mid).instruments[0].notes)
    print(f"    model_best.pth served the 118 s WAV on the card: {n_notes} notes, "
          f"K1 launches {lk.lstm_recurrence.launches - k1}")
    if lk.lstm_recurrence.launches - k1 != 4:
        raise AssertionError("model_best did not serve through K1")

    # --resume auto continues from model_epoch_2
    rc = train_cli.main(argv + ["--epochs", "3", "--resume", "auto"])
    with open(os.path.join(run_dir, "training_log.txt")) as f:
        epochs = [int(line.split()[1]) for line in f if line.strip()]
    final_step = torch.load(os.path.join(run_dir, "checkpoints", "model_final.pt"))["step"]
    with open(os.path.join(run_dir, "parameters.json")) as f:
        start_epoch = json.load(f)["start_epoch"]
    print(f"    --resume auto: rc {rc}, epochs logged {epochs}, start_epoch {start_epoch}, "
          f"final step {final_step}")
    if rc != 0 or epochs != [1, 2, 3] or start_epoch != 3 or final_step != 6:
        raise AssertionError("--resume auto did not continue from model_epoch_2")

    ms, _ = time_train_steps(torch, mcfg, tcfg, acfg, cache_dir)
    check_fp32_step(torch, mcfg, tcfg, rows)
    return launches, ms, best


def time_train_steps(torch, mcfg, tcfg, acfg, cache_dir):
    """Warm train steps of ``mcfg`` (the recurrence on K2a/K2b) on the staged
    train split, timed (median of 6), peak memory, and one step profiled.
    Returns (median ms, peak bytes)."""
    from torch.profiler import ProfilerActivity, profile

    from music_transcription_tpu_torch.data.cache import HybridMaestroDataset
    from music_transcription_tpu_torch.data.pipeline import DeviceStagedLoader
    from music_transcription_tpu_torch.parallel.train_step import init_train_state, train_step

    train_set = HybridMaestroDataset(cache_dir, cache_dir, "train", chunk_length=30.0,
                                     verbose=False)
    loader = DeviceStagedLoader(train_set, tcfg.batch_size, device="cuda", shuffle=True,
                                seed=SEED, drop_last=True, pad_to=acfg.mel_frames_per_chunk,
                                bf16_fields=(0,), u8_fields=(1,))
    state = init_train_state(dataclasses.replace(mcfg, lstm_backend="pallas"), tcfg, "cuda")
    batches = [b for _ in range(4) for b in loader]  # 8 batches, staged on the card
    train_step(state, batches[0], SEED + 1, max_grad_norm=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for batch in batches[1:7]:
        t_start = time.perf_counter()
        metrics = train_step(state, batch, SEED + 1, max_grad_norm=1.0)
        times.append((time.perf_counter() - t_start) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    audio_s = tcfg.batch_size * acfg.chunk_length
    print(f"    warm train step, attention {mcfg.attention_backend!r} (batch {tcfg.batch_size}, "
          f"T={acfg.mel_frames_per_chunk}): median {ms:.1f} ms of {[round(t, 1) for t in times]}; "
          f"{tcfg.batch_size / ms * 1e3:.2f} samples/s, {audio_s / ms * 1e3:.1f} audio-s/s; "
          f"peak memory {peak / 2**30:.2f} GiB; loss {metrics['loss']:.5f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        train_step(state, batches[7], SEED + 1, max_grad_norm=1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    print("    one train step under torch.profiler:")
    device_time_by_kernel(prof, wall, top=15)
    del state, loader, batches
    return ms, peak


def check_fp32_step(torch, mcfg, tcfg, rows) -> None:
    """One full-width fp32 step of ``mcfg``, dropout 0, on the card against
    the CPU, held to the GRAD_TOL classes."""
    from music_transcription_tpu_torch.models.cnn_rnn import CNNRNNLarge
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.parallel.train_step import TrainState, train_step
    from music_transcription_tpu_torch.train.optim import make_optimizer

    saved_rates = CNNRNNLarge.CHANNEL_DROPOUT
    CNNRNNLarge.CHANNEL_DROPOUT = (0.0, 0.0, 0.0)
    try:
        cfg = dataclasses.replace(mcfg, compute_dtype="float32", dropout=0.0,
                                  lstm_backend="pallas")
        torch.manual_seed(SEED + 7)
        models = [TranscriptionModel(cfg), TranscriptionModel(cfg)]
        models[1].load_state_dict(models[0].state_dict())
        models[1].cuda()
        rng = np.random.default_rng(SEED + 7)
        # centred mel: a dB offset only adds cancellation (below) to the check
        batch = (torch.from_numpy((rng.standard_normal((2, 1, mcfg.n_mels, 63)) * 10)
                                  .astype(np.float32)),
                 torch.from_numpy((rng.random((2, 88, 63)) > 0.9).astype(np.float32)),
                 torch.tensor([63, 40], dtype=torch.int32))
        results = []
        for m in models:
            dev = next(m.parameters()).device
            st = TrainState(m, make_optimizer(m.parameters(), tcfg))
            results.append(train_step(st, tuple(x.to(dev) for x in batch), SEED + 1,
                                      max_grad_norm=1.0))
    finally:
        CNNRNNLarge.CHANNEL_DROPOUT = saved_rates
    ref, got = results
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    worst = grad_agreement(torch, models[0], models[1])
    ok = loss_err <= 1e-4 and all(w[0] <= GRAD_TOL[k] for k, w in worst.items())
    rows.append(f"train step fp32 full width, attention {mcfg.attention_backend!r}, T=63, card "
                f"vs CPU: loss rel err {loss_err:.3e} (tol 1e-4); gradients, worst of each class "
                f"(tol): " + ", ".join(f"{k} {w[0]:.3e} at {w[1]} ({GRAD_TOL[k]:g})"
                                       for k, w in worst.items())
                + f" {'ok' if ok else 'FAIL'}")
    print("    " + rows[-1])
    if not ok:
        raise AssertionError(rows[-1])


def flash_train_phase(torch, lk, ak, rows, xla_ms):
    """Phase 7: the default model with attention_backend="pallas" through
    train/loop.train_model on the phase-6 cache staged on the card, 2 epochs
    of 2 steps. Returns the main path's launch counts and the path of
    model_best."""
    from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, TrainConfig
    from music_transcription_tpu_torch.data.cache import HybridMaestroDataset
    from music_transcription_tpu_torch.data.pipeline import DeviceStagedLoader
    from music_transcription_tpu_torch.train import loop as train_loop

    acfg = AudioConfig()
    tcfg = TrainConfig(epochs=2, save_every=1, seed=SEED)
    mcfg = ModelConfig(attention_backend="pallas", lstm_backend="pallas")
    cache_dir, run_dir = os.path.join(WORK, "train_cache"), os.path.join(WORK, "flash_run")
    shutil.rmtree(run_dir, ignore_errors=True)

    def staged(split, **kw):
        data = HybridMaestroDataset(cache_dir, cache_dir, split, chunk_length=30.0, verbose=False)
        return DeviceStagedLoader(data, tcfg.batch_size, device="cuda", seed=SEED,
                                  pad_to=acfg.mel_frames_per_chunk, bf16_fields=(0,),
                                  u8_fields=(1,), **kw)

    train_loader = staged("train", shuffle=True, drop_last=True)
    val_loader = staged("validation", pad_last_batch=True)
    counters = {c.__name__: c for c in (
        lk.lstm_recurrence, lk.lstm_recurrence_fwd, lk.lstm_recurrence_bwd,
        ak.flash_attention_clamped, ak.flash_attention_clamped_fwd,
        ak.flash_attention_clamped_dq, ak.flash_attention_clamped_dkv)}
    with recorded_steps() as steps:
        for counter in counters.values():
            counter.launches = 0
        t0 = time.perf_counter()
        _, history = train_loop.train_model(
            model_cfg=mcfg, train_cfg=tcfg, audio_cfg=acfg, train_loader=train_loader,
            val_loader=val_loader, run_dir=run_dir, device="cuda", verbose=False)
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
    losses = history["train_loss"] + history["val_loss"]
    print(f"[7] training through the flash attention (attention_backend='pallas'), "
          f"train_model: 2 epochs x {len(steps) // 2} steps, wall {wall:.1f} s; step losses "
          f"{[round(m['loss'], 5) for m in steps]}, skipped {sum(m['skipped'] for m in steps)}, "
          f"step ms {[round(m['ms'], 1) for m in steps]}, epoch train/val losses "
          f"{[round(v, 6) for v in losses]}; launches {launches}")
    if (len(steps) != 4 or any(m["skipped"] for m in steps)
            or not all(np.isfinite(v) for v in [m["loss"] for m in steps] + losses)):
        raise AssertionError("flash training run failed")
    n, n_val = len(steps), 2  # one validation batch per epoch
    expected = {"lstm_recurrence": 4 * n_val, "lstm_recurrence_fwd": 4 * n,
                "lstm_recurrence_bwd": 4 * n, "flash_attention_clamped": n_val,
                "flash_attention_clamped_fwd": n, "flash_attention_clamped_dq": n,
                "flash_attention_clamped_dkv": n}
    if launches != expected:
        raise AssertionError(f"flash training missed a kernel: {launches}, expected {expected}")
    best = os.path.join(run_dir, "checkpoints", "model_best.pth")
    with open(os.path.splitext(best)[0] + ".json") as f:
        route = json.load(f)["model"]["attention_backend"]
    print(f"    model_best sidecar: attention_backend {route!r}")
    if route != "pallas":
        raise AssertionError("model_best's sidecar lost the flash route")

    ms, _ = time_train_steps(torch, mcfg, tcfg, acfg, cache_dir)
    print(f"    flash step {ms:.1f} ms against the materialized-scores step {xla_ms:.1f} ms "
          f"(phase 6): {ms / xla_ms:.3f}x")
    check_fp32_step(torch, mcfg, tcfg, rows)
    return launches, best


def eval_phase(torch, lk, ak, flash_best, xla_best):
    """Phase 8: the evaluation CLI on the card. Returns the launch counts of
    the --window 120 run."""
    cache_dir, root = os.path.join(WORK, "train_cache"), os.path.join(WORK, "maestro_raw")
    counters = (lk.lstm_recurrence, ak.flash_attention_clamped)

    # the flash-trained model_best on the cache's validation split: 3 batches of 8
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    scores = run_evaluate(["--model", flash_best, "--cache_dir", cache_dir, "--split",
                           "validation", "--headless", "--tune_threshold", "--tune_split",
                           "validation", "--batch_size", "8", "-d", "cuda"])
    launches = [c.launches for c in counters]
    print(f"[8] evaluate the flash-trained model_best, validation split (24 chunks, batch 8): "
          f"{scores}, wall {time.perf_counter() - t0:.1f} s; launches K1 {launches[0]}, "
          f"K3 {launches[1]}")
    if (not 0.0 <= scores.get("EVAL_MEAN_F1", -1.0) <= 1.0
            or not 0.0 < scores.get("EVAL_BEST_THRESHOLD", -1.0) < 1.0 or launches != [12, 3]):
        raise AssertionError("evaluation of the flash-trained model failed")

    # the phase-6 model_best at --window 120 on a raw MAESTRO-layout tree: one
    # batch of 2 windows padded to 8 rows, 4*8*8*3751^2 bytes of scores, so
    # "auto" takes K3
    write_maestro_tree(root, SEED + 9)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    scores = run_evaluate(["--model", xla_best, "--root_dir", root, "--data_source", "full",
                           "--split", "test", "--window", "120", "--batch_size", "8",
                           "--headless", "-d", "cuda"])
    launches = {c.__name__: c.launches for c in counters}
    print(f"    evaluate the phase-6 model_best --window 120 on 2 raw 121 s pieces: {scores}, "
          f"wall {time.perf_counter() - t0:.1f} s; launches {launches}")
    if (not 0.0 <= scores.get("EVAL_MEAN_F1", -1.0) <= 1.0
            or launches != {"lstm_recurrence": 4, "flash_attention_clamped": 1}):
        raise AssertionError("--window 120 evaluation missed K3")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, config_to_dict
    from music_transcription_tpu_torch.data.audio import load_audio
    from music_transcription_tpu_torch.data.midi import load_midi
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.ops import _build
    from music_transcription_tpu_torch.ops import attention_kernel as ak
    from music_transcription_tpu_torch.ops import lstm_kernel as lk
    from music_transcription_tpu_torch.transcribe import Transcriber, transcribe_audio

    card = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    # 1. build
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"[1] built {', '.join(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                print(f"    {name}: {line.strip()}")

    # 2. kernels against their plain versions at the serving shapes
    rows = []
    k1 = check_k1(torch, lk, rows)
    k3 = check_k3(torch, ak, rows)
    print("[2] kernels vs plain versions on " + card)
    for r in rows:
        print("    " + r)

    # 3. serving at full width: default cnn_rnn_large, seeded weights
    os.makedirs(WORK, exist_ok=True)
    torch.manual_seed(SEED)
    mcfg, acfg = ModelConfig(), AudioConfig()
    model = TranscriptionModel(mcfg)
    n_params = sum(p.numel() for p in model.parameters())
    pth = os.path.join(WORK, "model.pth")
    torch.save(model.model.state_dict(), pth)
    with open(os.path.join(WORK, "model.json"), "w") as f:
        json.dump({"model": config_to_dict(mcfg), "audio": config_to_dict(acfg)}, f)
    wav30, mid30 = os.path.join(WORK, "request.wav"), os.path.join(WORK, "request.mid")
    write_wav(wav30, 118.0, SEED)

    lk.lstm_recurrence.launches = 0
    ak.flash_attention_clamped.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    transcribe_audio(wav30, pth, mid30, verbose=False, device="cuda")
    torch.cuda.synchronize()
    wall30 = time.perf_counter() - t0
    launches30 = {"lstm_recurrence": lk.lstm_recurrence.launches,
                  "flash_attention_clamped": ak.flash_attention_clamped.launches}
    mem30 = torch.cuda.max_memory_allocated()
    notes30 = load_midi(mid30).instruments[0].notes
    print(f"[3] 30 s route: {n_params / 1e6:.1f}M params, 4 chunks, {len(notes30)} notes, "
          f"wall {wall30 * 1e3:.1f} ms (first request, kernels built), peak memory "
          f"{mem30 / 2**30:.2f} GiB, launches {launches30}")
    if launches30["lstm_recurrence"] != 4:
        raise AssertionError(f"K1 should run 4 times per forward, ran {launches30}")

    # a second request on the warm server measures steady serving
    server = Transcriber(pth, device="cuda")
    y, _ = load_audio(wav30, sr=acfg.sample_rate)
    server.transcribe_array(y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.transcribe_array(y)
    torch.cuda.synchronize()
    warm30 = time.perf_counter() - t0
    print(f"    warm request (load_audio excluded): {warm30 * 1e3:.1f} ms")
    profile_request(torch, server, y)

    # the model on the card against the same weights on the CPU, short input
    mel = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (1, 1, mcfg.n_mels, 63)).astype(np.float32) * 10.0 - 40.0)
    for dtype, rel_tol in (("float32", 1e-3), ("bfloat16", 1e-1)):
        cfg = ModelConfig(compute_dtype=dtype)
        cpu_m = TranscriptionModel(cfg)
        cpu_m.load_state_dict(model.state_dict())
        cpu_m.eval()
        gpu_m = TranscriptionModel(cfg)
        gpu_m.load_state_dict(model.state_dict())
        gpu_m.eval().cuda()
        with torch.inference_mode():
            ref = cpu_m(mel, return_all_heads=True)
            got = gpu_m(mel.cuda(), return_all_heads=True)
        for head in ("frame", "onset", "offset"):
            scale = float(ref[head].abs().max())
            err = float((got[head].cpu() - ref[head]).abs().max())
            ok = got[head].shape == (1, 88, 63) and bool(torch.isfinite(got[head]).all()) \
                and err <= rel_tol * scale
            print(f"    {dtype} {head}: card vs CPU max_abs_err {err:.3e} "
                  f"(tol {rel_tol} x {scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{dtype} {head} disagrees with the CPU")

    # 4. long-window route: 4 windows of 120 s -> flash attention
    wav120, mid120 = os.path.join(WORK, "long.wav"), os.path.join(WORK, "long.mid")
    write_wav(wav120, 470.0, SEED + 3)
    lk.lstm_recurrence.launches = 0
    ak.flash_attention_clamped.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    transcribe_audio(wav120, pth, mid120, verbose=False, window=120.0, device="cuda")
    torch.cuda.synchronize()
    wall120 = time.perf_counter() - t0
    launches120 = {"lstm_recurrence": lk.lstm_recurrence.launches,
                   "flash_attention_clamped": ak.flash_attention_clamped.launches}
    mem120 = torch.cuda.max_memory_allocated()
    notes120 = load_midi(mid120).instruments[0].notes
    print(f"[4] -w 120 route: 4 windows (T=3751), {len(notes120)} notes, wall "
          f"{wall120 * 1e3:.1f} ms, peak memory {mem120 / 2**30:.2f} GiB, launches {launches120}")
    if launches120["flash_attention_clamped"] < 1 or launches120["lstm_recurrence"] != 4:
        raise AssertionError(f"-w 120 route missed a kernel: {launches120}")
    server120 = Transcriber(pth, window=120.0, device="cuda")
    y120, _ = load_audio(wav120, sr=acfg.sample_rate)
    server120.transcribe_array(y120)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server120.transcribe_array(y120)
    torch.cuda.synchronize()
    print(f"    warm request (load_audio excluded): {(time.perf_counter() - t0) * 1e3:.1f} ms")
    profile_request(torch, server120, y120)

    # 5. the training kernels against their plain versions
    rows = []
    k2 = check_k2(torch, lk, rows)
    k4 = check_k4(torch, ak, rows)
    print("[5] training kernels vs plain versions on " + card)
    for r in rows:
        print("    " + r)

    # 6. training at full width through the CLI (attention on the plain route)
    train_launches, xla_ms, xla_best = train_phase(torch, lk, ak, wav30, rows)

    # 7. training at full width through the flash attention
    flash_launches, flash_best = flash_train_phase(torch, lk, ak, rows, xla_ms)

    # 8. evaluation on the card
    eval_phase(torch, lk, ak, flash_best, xla_best)

    # 9. report
    kernels = [
        dict(name="lstm_recurrence", route="cuda",
             source="music_transcription_tpu_torch/csrc/lstm_recurrence.cu",
             replaces="music_transcription_tpu/ops/lstm_pallas.py:71",
             launches=launches30["lstm_recurrence"], ok=True, **k1),
        dict(name="flash_attention_clamped", route="cuda",
             source="music_transcription_tpu_torch/csrc/flash_attention_clamped.cu",
             replaces="music_transcription_tpu/ops/attention_pallas.py:38",
             launches=launches120["flash_attention_clamped"], ok=True, **k3),
        dict(name="lstm_recurrence_fwd", route="cuda",
             source="music_transcription_tpu_torch/csrc/lstm_recurrence.cu",
             replaces="music_transcription_tpu/ops/lstm_pallas.py:128",
             launches=train_launches["lstm_recurrence_fwd"], ok=True, **k2["K2a"]),
        dict(name="lstm_recurrence_bwd", route="cuda",
             source="music_transcription_tpu_torch/csrc/lstm_recurrence.cu",
             replaces="music_transcription_tpu/ops/lstm_pallas.py:147",
             launches=train_launches["lstm_recurrence_bwd"], ok=True, **k2["K2b"]),
        dict(name="flash_attention_clamped_fwd", route="cuda",
             source="music_transcription_tpu_torch/csrc/flash_attention_clamped.cu",
             replaces="music_transcription_tpu/ops/attention_pallas.py:38",
             launches=flash_launches["flash_attention_clamped_fwd"], ok=True, **k4["K3+lse"]),
        dict(name="flash_attention_clamped_dq", route="cuda",
             source="music_transcription_tpu_torch/csrc/flash_attention_clamped.cu",
             replaces="music_transcription_tpu/ops/attention_pallas.py:152",
             launches=flash_launches["flash_attention_clamped_dq"], ok=True, **k4["K4a"]),
        dict(name="flash_attention_clamped_dkv", route="cuda",
             source="music_transcription_tpu_torch/csrc/flash_attention_clamped.cu",
             replaces="music_transcription_tpu/ops/attention_pallas.py:173",
             launches=flash_launches["flash_attention_clamped_dkv"], ok=True, **k4["K4b"]),
    ]
    for name, (flops, nbytes, b_ms, b_by) in conv_stage_bounds().items():
        print(f"    still to port, {name} at the 30 s route's shape: {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB, bound_ms={b_ms:.4f} ({b_by})")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
