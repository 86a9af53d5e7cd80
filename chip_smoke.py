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
     library call as a yardstick where PyTorch has one. K1 and K3 are
     launched 5 times on the same inputs, which must give the same bits; K1
     is timed beside its sequential floor (lstm_recurrence_floor: its grid
     doing the T per-direction barriers and nothing else); the plain version
     reading h_{t-2} at one step must fail K1's tolerance, and K3's plain
     version skipping the last partial key tile or reading one key tile's v
     from the tile before (a stale stage of its ring), at each dtype's key
     tile, must fail K3's;
  3. serve the default 89M cnn_rnn_large (seeded random weights, .pth + .json)
     on a seeded ~2 min WAV through transcribe_audio on cuda: the MIDI must
     decode and the K1 counter must rise by 4 per forward; time a warm
     request and break one down (host stages, device time by kernel); check
     the full model on the card against the same model on the CPU on a
     short input;
  4. the long-window route (-w 120) on a seeded ~8 min WAV (4 windows):
     the clamped flash kernel K3 must run and the MIDI must decode; time a
     warm request and break it down as in phase 3; then the same model with
     compute_dtype="float32": warm requests through "auto" (K3 in fp32, 1
     launch a request) timed beside requests through "xla" (0 launches), in
     turns, and the forward alone the same way; their frame probabilities
     within FP32_ROUTE_TOL;
  4b. hold K5 (fused ConvBNRelu + pool) against its plain version at the
     default model's two ConvBNRelu stages (B=4, T=938: conv1 3x3 1->32 at
     F=320, freq_aware_conv 7x3 128->256 at F=80; seeded weights, BatchNorm
     statistics made non-trivial), element by element, launched 5 times with
     bit-identical outputs, with the scores of faulty outputs built from the
     plain version (the bottom halo read without zero fill, the shifted row
     pairs pooled, one tap of 16 input channels left out; at freq_aware_conv
     also the walk's: a stale weight stage, the x-row ring one step off, a
     segment border's halo rows read as zeros), each of which must fail the
     bound, and the weight bytes it reads from L2 and the x bytes it gathers
     beside its rates and bound; the same for K6
     (a whole residual block) at res_block1 + pool (32->64, F=160) and
     res_block2 (64->128, F=80), and at a seeded ResidualBlock(64, 64) (the
     identity skip), each launched 5 times with bit-identical outputs, with
     seven faulty outputs (h1 not zeroed outside the tensor, the skip read
     one column off, shifted pool pairs, one tap of conv2 left out, a stale
     weight stage, the walk's h1 row ring one step off, a segment border's
     h1 rows not computed again); time each kernel, its plain version and
     the model's own eager stage or block (cuDNN) with CUDA events, print
     their device time under torch.profiler beside them, and K6's executed
     over its useful work and its rates beside the bound; then run the
     model's inference CNN front end (CNNRNNLarge.cnn_features) with both
     ConvBNRelu stages through K5 and both residual blocks through K6
     against the model's own: exactly 2 K5 and 2 K6 launches. The device
     memory held before and after the phase is printed;
  5. hold the training kernels against their plain versions at the training
     shapes and time them: K2a and K2b (batch 24: 2B=48, T=938, H=512 and
     256) beside cuDNN's bidirectional LSTM forward and backward and the
     sequential floor at T=938 and 3751, each launched 5 times with
     bit-identical outputs, with the scores of the plain versions with a
     barrier that races (h_{t-2} read at one step; the dh carry one step
     stale at one step), which must fail the tolerances, and the
     LSTMRecurrence gradient against autograd through the plain recurrence;
     K3 with lse, K4a and K4b (B=24, T=938, 8 heads of 192) in bf16 and
     fp32, element by element, K3 with lse, K4a and K4b launched 5 times
     with bit-identical outputs, with the scores of a backward without the
     clamp gate, of one skipping the last partial key tile, of K4a's plain
     dq skipping the last partial key tile, reading a stale k / v stage or
     dropping one warp pair's partial dq (the fp32 kernel's pair sum),
     and of K4b's plain version skipping the last partial query tile or
     reading a stale q / dO stage (each at the dtype's tiles), all of which
     must fail the bound;
  6. train the default 89M cnn_rnn_large (TrainConfig defaults, batch 24)
     through the training CLI on a seeded synthetic cache written here (48
     train and 24 validation chunks of 30 s): 2 epochs of 2 steps with the
     cache staged on the card. The loss must be finite with no step skipped,
     K2a and K2b must rise by 4 per train step and K1 by 4 per validation
     batch; model_best must serve the phase-3 WAV; --resume auto must
     continue from model_epoch_2. Then time warm train steps, profile one,
     and hold one full-width fp32 step on the card against the CPU;
  6b. write a seeded raw MAESTRO-layout tree (4 train pieces of 380 s: 52
     chunks, 4 of them 20 s tails; 1 validation piece of 121 s: 4 chunks)
     and preprocess it at n_mels 320 with the preprocessing CLI on the card
     (-d cuda, 2 decoder threads), on the host (-d cpu, a pool of 2 workers)
     and on the host in this process, each with --verify: the host kit must
     have built, the card's rolls and metadata must equal the host's and its
     mel lie within 6e-2 dB of it; then train the default model from the
     card-built cache through the training CLI with --device_data slab
     --slab_gb 0.02 (2 slabs of 24 items, 1 step each, 2 epochs): 4 finite
     steps, none skipped, K2a and K2b up by 4 a step and K1 by 4 a validation
     batch, and every batch bit-identical to its items loaded on the host.
     Prints each path's chunks/s, each slab's staging time and GB/s, each
     step's time and the loader's wait before it, and the peak device memory;
  7. the same through the flash attention: ModelConfig(attention_backend=
     "pallas") into train/loop.train_model on the same cache, 2 epochs of 2
     steps. Per train step K3 with lse, K4a and K4b must rise by 1 and K2a,
     K2b by 4; per validation batch K3 (no lse) by 1 and K1 by 4; model_best's
     sidecar must say "pallas". Warm steps timed beside phase 6's, one
     profiled, and one full-width fp32 flash step on the card against the CPU
     (K3 with lse, K4a and K4b in fp32, once each); then warm full-width fp32
     steps on a seeded batch of 12 chunks of 30 s, attention "pallas" (K3
     with lse, K4a and K4b once a step) and "xla" (none) in turns, their
     medians, launches and peak memory, and the flash kernels' share of a
     profiled "pallas" step;
  8. evaluate on the card with python -m music_transcription_tpu_torch.evaluate
     (in this process): phase 7's model_best on the cache's validation split
     with a tuned threshold (K1 4 and K3 1 per batch of 8), and phase 6's
     model_best at --window 120 on a seeded raw MAESTRO-layout tree written
     here, where "auto" must take K3;
  8b. the AST tier's inference path at full width (ModelConfig(model_type=
     "ast"), 19,269,632 parameters, seeded weights, .pth + .json) on the
     phase-3 WAV (4 chunks, 1024 tokens each): transcribe_audio greedy, then
     Transcriber greedy, beam 4 and constrained, each a (88, 4 x 937) roll and
     a MIDI written and read back; warm greedy and beam-4 requests timed, ms
     per decode step, greedy repeated with identical tokens, the peak device
     memory, one greedy request profiled (device activity only); one 30 s
     chunk on the card against the CPU in fp32 and bf16 (memory and 256
     teacher-forced logits within AST_REL_TOL, 256 greedy tokens identical up
     to a near-tie); python -m music_transcription_tpu_torch.evaluate_ast
     on phase 8's raw tree (--constrained --beam 2 --frame_f1, and
     --teacher_forced): finite EVAL_AST_* lines. No hand-written kernel
     (K1-K6) may launch in the phase;
  8c. AST training at full width through python -m
     music_transcription_tpu_torch.train_ast on a seeded raw tree (2 train
     pieces of 120 s: 24 chunks of 10 s, 6 steps of 4; 1 validation piece of
     60 s): pretraining at the default encoder geometry for 2 epochs with
     --device_data on --compact_data, then the token model for 2 epochs from
     its model_best with --freeze_encoder, scheduled sampling 0.5 ramped over
     2 epochs, pitch weight 3, note-F1 selection with --save_best_every 1 and
     --device_data off. Every logged loss finite; model_final's encoder bit
     for bit the pretrained one and its other tensors moved; model_best
     through transcribe.load_model and evaluate_ast on the card (4 chunks,
     256 tokens). One fp32 token step (B=2, 256 tokens, pitch weight 3) on
     the card against the CPU within AST_STEP_TOL, and at scheduled sampling
     p = 1 when the first pass's 2 x 255 argmax tokens agree; the median warm
     pretrain, token and scheduled-sampling steps (the token steps under
     set_sync_debug_mode("error") until their loss read), the peak device
     memory, one token step profiled. No hand-written kernel may launch;
  9. data-parallel training at world 2 on the one card (the ranks share it
     over gloo, time-sliced), each rank a process of torchrun's (this script
     with a private argument, so that it reads its own kernel counters):
     9a. the default model through the training CLI (2 epochs of 2 steps of
     24 rows, 12 a rank, streamed from phase 6's cache): both ranks exit 0
     with the same finite losses, none skipped, K2a and K2b up by 4 a step
     and K1 by 4 a validation batch in each rank, rank 0 alone writes the
     run; its model_best serves phase 3's WAV here; --resume auto at world
     2 continues from model_epoch_2;
     9b. one fp32 step at dropout 0 from seeded weights on a global batch of
     24 at T=188 (rank 1's rows shorter), attention "xla" and "pallas",
     against the same step in this one process: the loss within 1e-4
     relative, the parameters within the CPU tests' bounds (2 lr; all but 1
     in 200 within 1e-2 lr), the running statistics within 1e-4;
     9c. K2a and K2b at a rank's 2B = 24 and K3 with lse, K4a and K4b at its
     B x heads = 96 against their plain versions (phase 5's tolerances, 5
     launches bit-identical);
     9d. zero1 at world 2, 2 steps, against dp; its consolidated checkpoint
     resumes here with the Adam moments the ranks' shards held, bit for bit;
     9e. fsdp at world 1 over NCCL in this process (parallel/partitioning;
     the loop refuses one rank): one step against the plain one, its
     sharded bytes, its full state loaded into a one-device model;
     then warm world-2 bf16 steps of the default model (12 rows a rank,
     T=938) timed beside phase 6's step, with the gradient all-reduce timed
     apart and one step profiled in rank 0;
 10. the rest of parallelism: 10a the default model served by
     Transcriber(devices=["cuda:0", "cuda:0"]), two replicas on the one card,
     on the 118 s WAV (4 chunks, 2 a replica), the -w 120 470 s WAV (4
     windows, 2 a replica: "auto" keeps the plain attention at that batch)
     and a -w 120 950 s WAV (8 windows, 4 a replica: K3 in each), against
     one device: logits within the serving check's bf16 bound, rolls equal
     but at frames whose probability lies within the paths' largest
     difference of the threshold (counted), K1 4 a replica and K3 as the
     replica's batch decides, warm requests beside one device's and phase
     3's; 10b the evaluation CLI at world 2 (torchrun, gloo: the ranks share
     the card) on phase 6's cache (validation split tuned on the train
     split) against one process: EVAL_MEAN_F1 within 1e-6, the threshold
     within 1e-9, no EVAL_ line from rank 1, K1 counted in each rank, both
     wall times; 10c one fp32 step with tp's placement at world 1 over NCCL
     on a 1-D and a (1, 1) mesh against the plain step, K2a and K2b on the
     gathered weights, the gathered state loaded into a one-device model;
     10d python -m music_transcription_tpu_torch.parallel.dryrun 4 on this
     machine's CPU (the FSDP2 API of its torch);
 11. the remaining surfaces at full width (phase 3's model and WAV): 11a the
     resident server (serve.main) in watch mode with --once over the 118 s
     WAV, a seeded 60 s WAV and a text file, in this process (K1 4 a
     request, notes equal to phase 3's Transcriber's, a warm file timed),
     then in stdin mode as a subprocess; 11b visualize.transcribe_rolls on
     the card (its roll equal to transcribe_chunks) and the CLI (a PNG, or
     exit 1 naming matplotlib); 11c bench.attention at its defaults and at
     --batch 4 --t 938 (K3 in the "pallas" forward, K3 with lse, K4a and
     K4b in its forward + backward, none under "xla"); 11d bench.components
     at --batch_size 16 (K2a and K2b 4 a LSTM-tier call); 11e bench.train at
     its defaults; 11f bench.loader on phase 6b's card-built cache, with the
     card feed and with --no_device; 11g example.sh eval on phase 6's run
     and cache, EVAL_MEAN_F1 within 1e-6 of the evaluation CLI's; the
     phase's wall time;
 12. print the kernels line (JSON: launches on the main path, error against
     the plain version, times, bound, and for K1, K2a and K2b the sequential
     floor; the fp32 variants of K3, K3 with lse, K4a and K4b as rows of
     their own, "_f32", with phase 4's and phase 7's fp32 launches; a failed
     check has already exited),
     the card's name and power limit, and as the last line
     {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import re
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


def device_ms(torch, fn, reps: int, tries: int = 3):
    """Device time of one call of ``fn`` (ms): the sum of its device events'
    times on the card under torch.profiler, without the host's gaps between
    them (a call that launches several small kernels is host-bound under
    CUDA events). A reading beside ``cuda_ms``, which gives the records'
    times. The profiler's trace can come back without a device event; it is
    taken again, up to ``tries`` times, and None ("not measured") is returned
    if every trace was empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA)
        if ns > 0:
            return ns / reps / 1e6
    return None


def fmt_ms(ms, spec: str = ".4f") -> str:
    """A time from ``device_ms``: "not measured" where it gave None."""
    return "not measured" if ms is None else format(ms, spec)


def fmt_rate(work: float, ms) -> str:
    """``work`` over ``ms`` in units of 10^12 per second (TFLOP/s from
    flops), "not measured" where the time is None."""
    return "not measured" if ms is None else f"{work / ms / 1e9:.1f}"


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


REPEATS = 5  # launches of a recurrence kernel on the same inputs that must agree bit for bit


def repeats_identical(torch, fn, first) -> bool:
    """``fn()`` REPEATS - 1 more times on the same inputs: every output bit
    for bit equal to ``first`` (a barrier that races shows as a difference)."""
    firsts = first if isinstance(first, tuple) else (first,)
    for _ in range(REPEATS - 1):
        again = fn()
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, b) for a, b in zip(again, firsts)):
            return False
    return True


def floor_ms(lk, two_b: int, t: int, hidden: int) -> float:
    """The recurrence kernels' sequential floor at (2B, T, H): their grid
    doing its T per-direction barriers and nothing else (CUDA events)."""
    return cuda_ms(lambda: lk.lstm_recurrence_floor(two_b, t, hidden), reps=5)


def check_k1(torch, lk, rows):
    """K1 against its plain version at the serving shapes: T=938 (30 s
    chunks; 2B=8 for a 4-chunk request, 32 for 16 chunks) and T=3751 (-w 120,
    4 windows), H=512 (rnn_main) and 256 (rnn_local), each launched REPEATS
    times with bit-identical outputs, beside its sequential floor; at 2B=8,
    T=938, H=512 also the score of the plain version reading h_{t-2} at one
    step, which must fail the tolerance. Returns the record for 2B=8, T=938,
    H=512."""
    rng = np.random.default_rng(SEED)
    record = None
    floors = {}
    for two_b, t, hidden in ((8, 938, 512), (8, 938, 256), (32, 938, 512), (32, 938, 256),
                             (8, 3751, 512), (8, 3751, 256)):
        xw = torch.from_numpy(rng.standard_normal((two_b, t, 4 * hidden)).astype(np.float32)).cuda()
        k = 1.0 / np.sqrt(hidden)
        wh = torch.from_numpy(rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(np.float32)).cuda()
        got = lk.lstm_recurrence(xw, wh)
        ref = lk.lstm_recurrence_plain(xw, wh)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same = repeats_identical(torch, lambda: lk.lstm_recurrence(xw, wh), got)
        # fp32, a different summation order over T sequential steps
        ok = err <= 1e-4 and bool(torch.isfinite(got).all()) and same
        ms = cuda_ms(lambda: lk.lstm_recurrence(xw, wh), reps=10)
        if (t, hidden) not in floors:
            floors[t, hidden] = floor_ms(lk, two_b, t, hidden)
        plain_ms = cuda_ms(lambda: lk.lstm_recurrence_plain(xw, wh), reps=2)
        lstm = torch.nn.LSTM(2 * hidden, hidden, batch_first=True, bidirectional=True).cuda()
        x = torch.randn(two_b // 2, t, 2 * hidden, device="cuda")
        with torch.no_grad():
            library_ms = cuda_ms(lambda: lstm(x), reps=10)
        flops = 2.0 * two_b * t * hidden * 4 * hidden
        nbytes = 4.0 * (xw.numel() + wh.numel() + got.numel())
        b_ms, b_by = bound(flops, PEAK_FP32, nbytes)
        fault = ""
        if (two_b, t, hidden) == (8, 938, 512):
            score = float((lk.faulty_fwd_plain(xw, wh)[0] - ref).abs().max()) / 1e-4
            fault = f" h_{{t-2}} fault score={score:.1f} (must exceed 1)"
            ok = ok and score > 1
        rows.append(f"K1 2B={two_b} T={t} H={hidden}: max_abs_err={err:.3e} ms={ms:.4f} "
                    f"floor_ms={floors[t, hidden]:.4f} plain_ms={plain_ms:.3f} "
                    f"cudnn_lstm_ms={library_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                    f"{REPEATS} launches bit-identical={same}{fault} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(rows[-1])
        if (two_b, t, hidden) == (8, 938, 512):
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=library_ms, floor_ms=floors[t, hidden])
    return record


def check_k2(torch, lk, rows):
    """K2a and K2b against their plain versions at the training shapes (batch
    24: 2B=48, T=938; H=512 for rnn_main, 256 for rnn_local), each launched
    REPEATS times with bit-identical outputs, beside the sequential floor at
    T=938 and T=3751; at H=512 also the scores of the plain versions with a
    barrier that races (the forward reading h_{t-2}, the backward a dh carry
    one step stale, at one step), which must fail the tolerances; and the
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
        same_fwd = repeats_identical(torch, lambda: lk.lstm_recurrence_fwd(xw, wh), (h, c))
        same_bwd = repeats_identical(
            torch, lambda: lk.lstm_recurrence_bwd(xw, wh, ref_h, ref_c, dh), dxw)
        ok_fwd = fwd_err <= 1e-4 and bool(torch.isfinite(h).all() and torch.isfinite(c).all()) \
            and same_fwd
        ok_bwd = dxw_err <= dxw_tol and dwh_err <= dwh_tol and bool(torch.isfinite(dxw).all()) \
            and same_bwd
        floor = {n: floor_ms(lk, two_b, n, hidden) for n in (938, 3751)}
        faults = {"K2a": "", "K2b": ""}
        if hidden == 512:
            fh, fc = lk.faulty_fwd_plain(xw, wh)
            f_score = max(float((fh - ref_h).abs().max()), float((fc - ref_c).abs().max())) / 1e-4
            b_score = float((lk.faulty_bwd_plain(xw, wh, ref_h, ref_c, dh) - ref_dxw).abs().max()) \
                / dxw_tol
            faults = {"K2a": f" h_{{t-2}} fault score={f_score:.1f} (must exceed 1)",
                      "K2b": f" stale dh carry fault score={b_score:.1f} (must exceed 1)"}
            ok_fwd, ok_bwd = ok_fwd and f_score > 1, ok_bwd and b_score > 1
            del fh, fc
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
        for name, err, tol, ok, same, ms, plain_ms, lib_ms, (b_ms, b_by) in (
                ("K2a", fwd_err, 1e-4, ok_fwd, same_fwd, fwd_ms, fwd_plain_ms, lib_fwd_ms,
                 fwd_bound),
                ("K2b", max(dxw_err / dxw_tol, dwh_err / dwh_tol) * 1e-4, 1e-4, ok_bwd, same_bwd,
                 bwd_ms, bwd_plain_ms, lib_bwd_ms, bwd_bound)):
            detail = (f"max_abs_err={err:.3e} (tol {tol:g})" if name == "K2a" else
                      f"dxw max_abs_err={dxw_err:.3e} (tol {dxw_tol:.3e}), dW_hh "
                      f"max_abs_err={dwh_err:.3e} (tol {dwh_tol:.3e})")
            rows.append(f"{name} 2B={two_b} T={t} H={hidden}: {detail} ms={ms:.4f} "
                        f"floor_ms={floor[938]:.4f} (T=3751: {floor[3751]:.4f}) "
                        f"plain_ms={plain_ms:.3f} cudnn_lstm_ms={lib_ms:.4f} "
                        f"bound_ms={b_ms:.4f} ({b_by}) {REPEATS} launches bit-identical={same}"
                        f"{faults[name]} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(rows[-1])
            if hidden == 512:
                records[name] = dict(max_abs_err=dxw_err if name == "K2b" else err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                     library_ms=lib_ms, floor_ms=floor[938])
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


def k3_score(got, ref, ref_abs_v, dtype: str) -> float:
    """Largest |got - ref| / (rtol |ref| + ptol (P|V|)): <= 1 passes."""
    rtol, ptol = K3_TOL[dtype]
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() / (rtol * ref.abs() + ptol * ref_abs_v.float())).max())


def check_k3(torch, ak, rows):
    """K3 against its plain version at the -w 120 shape (4 windows), bf16 (the
    serving path) and fp32 (compute_dtype="float32"), launched REPEATS times
    with bit-identical outputs, with the scores of a kernel skipping the last
    partial key tile and of one reading a stale stage of its ring (one key
    tile's v from the tile before: ``ak.faulty_fwd_plain`` at the dtype's
    tile), which must fail the bound; beside it, for scale only, PyTorch's
    scaled_dot_product_attention at the same shape, which does not clamp and
    so computes another function. Returns the record of each dtype."""
    from music_transcription_tpu_torch.ops.precision import full_fp32

    rng = np.random.default_rng(SEED + 1)
    b, t, nh, d = 4, 3751, 8, 192
    scale = d**-0.5
    # q scaled so that a share of the logits passes the +-10 clamp
    q32, k32, v32 = (torch.from_numpy(m * rng.standard_normal((b, t, nh, d)).astype(np.float32)).cuda()
                     for m in (4.0, 1.0, 1.0))
    clamped = float(((torch.einsum("bthd,bshd->bhts", q32[:1], k32[:1]) * scale).abs() > 10)
                    .float().mean())
    records = {}
    for dtype, elt in (("bfloat16", 2.0), ("float32", 4.0)):
        q, k, v = (x.to(getattr(torch, dtype)) for x in (q32, k32, v32))
        tile = ak.K3_KEY_TILE if dtype == "bfloat16" else ak.K3_KEY_TILE_F32
        with full_fp32():
            got = ak.flash_attention_clamped(q, k, v, scale, 10.0)
            ref = ak.attention_clamped_plain(q, k, v, scale, 10.0)
            ref_abs_v = ak.attention_clamped_plain(q, k, v.abs(), scale, 10.0)
            # what a kernel that skipped the last partial key tile would give
            kept = t // tile * tile
            skipped = ak.attention_clamped_plain(q, k[:, :kept], v[:, :kept], scale, 10.0)
            torch.cuda.synchronize()
            score = k3_score(got, ref, ref_abs_v, dtype)
            fault = k3_score(skipped, ref, ref_abs_v, dtype)
            faults = {"skip_last_key_tile": fault,
                      "stale_stage": k3_score(ak.faulty_fwd_plain(q, k, v, scale, 10.0, tile=tile),
                                              ref, ref_abs_v, dtype)}
            same = repeats_identical(torch, lambda: ak.flash_attention_clamped(q, k, v, scale, 10.0),
                                     got)
            err = float((got.float() - ref.float()).abs().max())
            rms = float(ref.float().pow(2).mean().sqrt())
            ms = cuda_ms(lambda: ak.flash_attention_clamped(q, k, v, scale, 10.0), reps=5)
            plain_ms = cuda_ms(lambda: ak.attention_clamped_plain(q, k, v, scale, 10.0), reps=2)
            sdpa = ""
            if dtype == "bfloat16":
                qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
                sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, scale=scale), reps=5)
                sdpa = f" (scaled_dot_product_attention, no clamp: {sdpa_ms:.4f} ms)"
        flops = 4.0 * b * nh * t * t * d
        nbytes = elt * 4 * q.numel()
        b_ms, b_by = bound(flops, PEAK_BF16 if dtype == "bfloat16" else PEAK_FP32, nbytes)
        rtol, ptol = K3_TOL[dtype]
        ok = (score <= 1.0 and min(faults.values()) > 1.0 and same
              and bool(torch.isfinite(got.float()).all()))
        rows.append(f"K3 {dtype} B={b} T={t} heads={nh} D={d}: max_abs_err={err:.3e}, rms(ref) "
                    f"{rms:.3e}, rms(P|V|) {float(ref_abs_v.float().pow(2).mean().sqrt()):.3e}, "
                    f"worst |err|/({rtol:g}|ref| + {ptol:g}P|V|) {score:.3f} (a kernel "
                    f"skipping the last {t - kept} keys: {fault:.1f}; one reading key tile "
                    f"{-(-t // tile) // 2}'s v from the tile before, {tile} keys a tile: "
                    f"{faults['stale_stage']:.1f}), clamped share "
                    f"{clamped:.4f}; {REPEATS} launches bit-identical={same}; ms={ms:.4f} "
                    f"plain_ms={plain_ms:.3f}{sdpa} bound_ms={b_ms:.4f} ({b_by}) "
                    f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(rows[-1])
        records[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None, repeats_identical=same,
                              fault_scores=faults)
    return records


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
    a share of the logits. K3 with lse, K4a and K4b are launched REPEATS
    times with bit-identical outputs; the scores of a backward without the
    clamp gate, of one skipping the last partial key tile, (K4a's ring:
    ``ak.faulty_dq_plain``, dq alone) of one skipping the last partial key
    tile, of one reading a stale k / v stage and (fp32 alone) of the fp32
    kernel's sum of its two warp pairs' partial dq with one dropped, and
    (K4b's ring: ``ak.faulty_dkv_plain``) of one skipping the last partial
    query tile and of one reading a stale q / dO stage, each at the dtype's
    tiles, must fail the bound. Returns the records of the three, by dtype."""
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
        bf16 = dtype == "bfloat16"
        dq_tile = ak.K4A_KEY_TILE if bf16 else ak.K4A_KEY_TILE_F32
        dkv_tile = ak.K4B_QUERY_TILE if bf16 else ak.K4B_QUERY_TILE_F32
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
            kept = t // dq_tile * dq_tile
            skipped, _ = attention_grad_terms(torch, q, k, v, ref_o, do, ref_lse, scale, clip,
                                              keys=kept)
            fault_tile = k4_score(skipped, ref, mag, dtype)
            del skipped
            dq_faults = {name: k4_score([ak.faulty_dq_plain(
                q, k, v, ref_o, do, ref_lse, scale, clip, fault=name, tile=dq_tile)], ref[:1],
                mag[:1], dtype) for name in ak.DQ_FAULTS
                if not (bf16 and name == "dropped_pair_partial")}  # no pair sum in bf16
            dkv_faults = {name: k4_score(ak.faulty_dkv_plain(
                q, k, v, ref_o, do, ref_lse, scale, clip, fault=name, tile=dkv_tile), ref[1:],
                mag[1:], dtype) for name in ak.DKV_FAULTS}
            del mag
            same_fwd = repeats_identical(
                torch, lambda: ak.flash_attention_clamped_fwd(q, k, v, scale, clip), (o, lse))
            same_dq = repeats_identical(torch, lambda: ak.flash_attention_clamped_dq(
                q, k, v, ref_o, do, ref_lse, scale, clip), dq)
            same_dkv = repeats_identical(torch, lambda: ak.flash_attention_clamped_dkv(
                q, k, v, ref_o, do, ref_lse, scale, clip), (dk, dv))
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
              and fault_tile > 1.0
              and all(v > 1.0 for v in (*dq_faults.values(), *dkv_faults.values()))
              and same_fwd and same_dq and same_dkv
              and all(bool(torch.isfinite(g.float()).all()) for g in got))
        rtol, ptol = K4_TOL[dtype]
        ring = "".join(f"; {kernel} {n.replace('_', ' ')} ({tile} a tile): {v:.1f}"
                       for kernel, faults, tile in (("K4a", dq_faults, dq_tile),
                                                    ("K4b", dkv_faults, dkv_tile))
                       for n, v in faults.items())
        rows.append(
            f"K3+lse/K4a/K4b {dtype} B={b} T={t} heads={nh} D={d}: o worst |err|/K3_TOL "
            f"{fwd_score:.3f}, lse max_abs_err {lse_err:.3e}; dq/dk/dv max_abs_err "
            f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, worst |err|/({rtol:g}|ref| + {ptol:g}m) "
            f"{score:.3f} (a backward without the clamp gate: {fault_gate:.1f}; one skipping "
            f"the last {t - kept} keys: {fault_tile:.1f}{ring}), clamped share {clamped:.4f}; "
            f"{REPEATS} launches bit-identical: K3+lse {same_fwd}, K4a {same_dq}, K4b {same_dkv}; "
            f"ms K3+lse {fwd_ms:.4f} K4a {dq_ms:.4f} K4b {dkv_ms:.4f}; plain ms fwd "
            f"{fwd_plain_ms:.3f} bwd {bwd_plain_ms:.3f}; bound ms "
            + ", ".join(f"{n} {v[0]:.4f} ({v[1]})" for n, v in bounds.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(rows[-1])
        rec = {}
        for name, err, ms, plain_ms in (("K3+lse", float((o.float() - ref_o.float()).abs().max()),
                                         fwd_ms, fwd_plain_ms),
                                        ("K4a", errs[0], dq_ms, bwd_plain_ms),
                                        ("K4b", max(errs[1:]), dkv_ms, bwd_plain_ms)):
            rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bounds[name][0],
                             bound_by=bounds[name][1], library_ms=None)
        rec["K3+lse"]["repeats_identical"] = same_fwd
        rec["K4a"].update(repeats_identical=same_dq, fault_scores=dq_faults)
        rec["K4b"].update(repeats_identical=same_dkv, fault_scores=dkv_faults)
        records[dtype] = rec
        del q, k, v, do, o, lse, ref_o, ref_lse, dq, dk, dv, ref, got
    return records


def conv_stage_bounds() -> dict:
    """Bounds of K5 and K6 at the stages of the default cnn_rnn_large they
    replace on the 30 s route (4 chunks: B=4, 320 mel bins, T=938, bf16):
    conv1 + BN + ReLU + pool and freq_aware_conv (7x3) + BN + ReLU + pool
    (K5), res_block1 + pool and res_block2 (K6, its two 3x3 convs and the 1x1
    skip). Operations at the bf16 tensor-core peak; bytes:
    input, weights and output once."""
    b, t = 4, 938
    out = {}
    for name, f, c_in, convs, c_out, pool in (
            ("K5 conv1+pool", 320, 1, [(9, 1, 32)], 32, True),
            ("K5 freq_aware_conv+pool", 80, 128, [(21, 128, 256)], 256, True),
            ("K6 res_block1+pool", 160, 32, [(9, 32, 64), (9, 64, 64), (1, 32, 64)], 64, True),
            ("K6 res_block2", 80, 64, [(9, 64, 128), (9, 128, 128), (1, 64, 128)], 128, False)):
        pixels = b * f * t
        weights = sum(k * ci * co for k, ci, co in convs)
        flops = 2.0 * pixels * weights
        nbytes = 2.0 * (pixels * c_in + weights + pixels * c_out // (2 if pool else 1))
        out[name] = (flops, nbytes, *bound(flops, PEAK_BF16, nbytes))
    return out


K5_STAGES = (("conv1", 1, 320), ("freq_aware_conv", 128, 80))  # (module, C_in, F), B=4, T=938


def randomize_bn(model, seed: int) -> None:
    """Non-trivial BatchNorm statistics and affine on every BatchNorm of
    ``model``: variance |N| + 0.5, the rest 0.3 N (tests/test_conv_pallas.py)."""
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.running_var.copy_(torch.from_numpy(np.abs(rng.standard_normal(c)) + 0.5))
                for v in (mod.running_mean, mod.weight, mod.bias):
                    v.copy_(torch.from_numpy(0.3 * rng.standard_normal(c)))


def time_kernel_plain_model(torch, kernel, plain, model_stage):
    """A kernel, its plain version and the model's own eager stage, timed
    with CUDA events around repeated calls (20, 3, 20: the record's times),
    and their device time per call under torch.profiler."""
    fns, reps = (kernel, plain, model_stage), (20, 3, 20)
    return (tuple(cuda_ms(fn, n) for fn, n in zip(fns, reps)),
            tuple(device_ms(torch, fn, n) for fn, n in zip(fns, reps)))


def check_k5(torch, ck, model, rows):
    """K5 against its plain version at the default model's two ConvBNRelu
    stages (B=4, T=938, pool) on ``model``'s weights, to ``ck.k5_score``'s
    bound, launched REPEATS times with bit-identical outputs, with the scores
    of the faulty outputs ``ck.faulty_plain`` builds (the walk's on the
    segments K5 takes on this card, at freq_aware_conv: conv1 runs the
    CUDA-core kernel, which has no weight stages, x-row ring or segments),
    each of which must fail it; K5, its plain version and the model's own
    eager stage (cuDNN bf16 conv + elementwise passes) timed with CUDA events
    around repeated calls (the record's times), and their device time per
    call under torch.profiler beside them; the weight bytes K5 reads from L2
    and the x bytes it gathers (``ck.k5_traffic``), and its rates beside the
    bound. Returns the record of the two stages together, as the front end
    launches them."""
    from music_transcription_tpu_torch.models import cnn_rnn

    rng = np.random.default_rng(SEED + 10)
    bounds = conv_stage_bounds()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0)
    fault_scores, repeats = {}, True
    for name, c_in, f in K5_STAGES:
        conv, bn = getattr(model, name)
        c_out, kh, kw = conv.out_channels, *conv.kernel_size
        x = torch.from_numpy(rng.standard_normal((4, c_in, f, 938)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        args = (x, conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        faults = [k for k in ck.FAULTS if c_in >= 16 or k not in ck.K5_WALK_FAULTS]
        with torch.no_grad():
            got = ck.fused_conv_bn_relu(*args, pool=True)
            ref = ck.fused_conv_bn_relu_plain(*args, pool=True)
            torch.cuda.synchronize()
            same_bits = repeats_identical(torch, lambda: ck.fused_conv_bn_relu(*args, pool=True),
                                          got)
            score = ck.k5_score(got, ref, args, pool=True)
            scores = {k: ck.k5_score(ck.faulty_plain(args, k, pool=True, sms=sms), ref, args,
                                     pool=True)
                      for k in faults}
            err = float((got.float() - ref.float()).abs().max())
            same = float((got == ref).float().mean())
            (ms, plain_ms, lib_ms), (dev_ms, dev_plain_ms, dev_lib_ms) = time_kernel_plain_model(
                torch, lambda: ck.fused_conv_bn_relu(*args, pool=True),
                lambda: ck.fused_conv_bn_relu_plain(*args, pool=True),
                lambda: cnn_rnn._pooled_conv_bn_relu(x, conv, bn, torch.bfloat16))
        flops, nbytes, b_ms, b_by = bounds[f"K5 {name}+pool"]
        traffic = ck.k5_traffic(4, c_in, c_out, f, 938, kh, kw, True, sms)
        seg = ck.k5_device_segment_rows(4, f, 938)
        fault_scores[name] = scores
        repeats = repeats and same_bits
        ok = (score <= 1.0 and all(v > 1.0 for v in scores.values()) and same_bits
              and seg == ck.k5_segment_rows(4, f, 938, sms)
              and got.shape == (4, c_out, f // 2, 938)
              and bool(torch.isfinite(got.float()).all()))
        walk = (f"the walk, segments of {seg} rows" if ck._k5_tensor_cores(c_in, c_out, kh, kw)
                else "the CUDA-core chunks")
        rows.append(f"K5 {name}+pool B=4 C {c_in}->{c_out} F={f} T=938 {kh}x{kw} ({walk}): "
                    f"max_abs_err={err:.3e}, bit-identical {same:.5f}, {REPEATS} launches "
                    f"bit-identical={same_bits}, worst |err|/({ck.K5_TOL:g}|ref| + "
                    f"|s|({ck.K5_TOL:g}|h| + 2n2^-23 m)) {score:.3f} (faults: "
                    + ", ".join(f"{k} {v:.1f}" for k, v in scores.items())
                    + f"); ms={ms:.4f} plain_ms={plain_ms:.3f} model_stage_ms={lib_ms:.4f} "
                    f"(device time under torch.profiler: {fmt_ms(dev_ms)} / "
                    f"{fmt_ms(dev_plain_ms, '.3f')} / {fmt_ms(dev_lib_ms)}) "
                    f"bound_ms={b_ms:.4f} ({b_by}); weights from L2 "
                    f"{traffic['weights_l2'] / 1e9:.4f} GB, x gathered "
                    f"{traffic['x_gathered'] / 1e6:.2f} MB ({traffic['x_gathered'] / traffic['x_bytes']:.3f}x "
                    f"the input); TFLOP/s {flops / ms / 1e9:.1f} (device time "
                    f"{fmt_rate(flops, dev_ms)}), at the bound {flops / b_ms / 1e9:.1f} "
                    f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(rows[-1])
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("flops", flops), ("nbytes", nbytes)):
            total[key] += v
        total["max_abs_err"] = max(total["max_abs_err"], err)
        del x, args, got, ref
    # the two launches of one front end: the least time for their work together
    b_ms, b_by = bound(total.pop("flops"), PEAK_BF16, total.pop("nbytes"))
    return dict(total, bound_ms=b_ms, bound_by=b_by, repeats_identical=repeats,
                fault_scores=fault_scores)


K6_BLOCKS = (("res_block1", 32, 160, True), ("res_block2", 64, 80, False))  # (module, C_in, F, pool)


def hold_k6(torch, ck, x, block, pool: bool, name: str):
    """K6 on ``block`` (a port ResidualBlock on the card) and ``x`` against its
    plain version, to ``ck.k6_score``'s bound, launched REPEATS times with
    bit-identical outputs, with the scores of the faulty outputs
    ``ck.faulty_plain_k6`` builds (the walk's on the segments K6 takes on this
    card), each of which must fail it. Returns (args, max |err|, fault
    scores, bits repeat, text); raises on a failure."""
    args = (x, *ck.res_block_args(block))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b, c_in, f, t = x.shape
    with torch.no_grad():
        got = ck.fused_res_block(*args, pool=pool)
        ref = ck.fused_res_block_plain(*args, pool=pool)
        torch.cuda.synchronize()
        same_bits = repeats_identical(torch, lambda: ck.fused_res_block(*args, pool=pool), got)
        score = ck.k6_score(got, ref, args, pool=pool)
        faults = {k: ck.k6_score(ck.faulty_plain_k6(args, k, pool=pool, sms=sms), ref, args,
                                 pool=pool)
                  for k in ck.FAULTS_K6}
    c_out = block.conv2.out_channels
    err = float((got.float() - ref.float()).abs().max())
    same = float((got == ref).float().mean())
    seg = ck.k6_device_segment_rows(b, f, t)
    ok = (score <= 1.0 and all(v > 1.0 for v in faults.values()) and same_bits
          and seg == ck.k6_segment_rows(b, f, t, sms)
          and got.shape == (b, c_out, f // 2 if pool else f, t)
          and bool(torch.isfinite(got.float()).all()))
    text = (f"K6 {name}{'+pool' if pool else ''} B={b} C {c_in}->{c_out} F={f} T={t} "
            f"({'1x1 skip' if block.skip is not None else 'identity skip'}, segments of {seg} "
            f"rows): max_abs_err={err:.3e}, bit-identical to the plain version {same:.6f}, "
            f"{REPEATS} launches bit-identical={same_bits}, worst |err|/bound {score:.3f} (faults: "
            + ", ".join(f"{k} {v:.1f}" for k, v in faults.items()) + ")")
    if not ok:
        raise AssertionError(text + " FAIL")
    return args, err, faults, same_bits, text


def check_k6(torch, ck, model, rows):
    """K6 against its plain version at the default model's two residual
    blocks (B=4, T=938; res_block1 with the pool that follows it) on
    ``model``'s weights, and at a seeded ResidualBlock(64, 64), the identity
    skip, at B=4, F=80; K6, its plain version and the model's own eager block
    (cuDNN bf16 convs + elementwise passes, + pool) timed as K5's stages,
    with the work K6 executes (``ck.k6_work``) over the work the block needs
    and the rates of both. Returns the record of the two blocks together, as
    the front end launches them."""
    from music_transcription_tpu_torch.models import cnn_rnn

    rng = np.random.default_rng(SEED + 12)
    bounds = conv_stage_bounds()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0)
    fault_scores, repeats = {}, True
    for name, c_in, f, pool in K6_BLOCKS:
        block = getattr(model, name)
        x = torch.from_numpy(rng.standard_normal((4, c_in, f, 938)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        args, err, faults, same_bits, text = hold_k6(torch, ck, x, block, pool, name)
        label = f"{name}{'+pool' if pool else ''}"
        fault_scores[label], repeats = faults, repeats and same_bits
        with torch.no_grad():
            (ms, plain_ms, lib_ms), (dev_ms, dev_plain_ms, dev_lib_ms) = time_kernel_plain_model(
                torch, lambda: ck.fused_res_block(*args, pool=pool),
                lambda: ck.fused_res_block_plain(*args, pool=pool),
                lambda: cnn_rnn._res_block(x, block, torch.bfloat16, pool))
        flops, nbytes, b_ms, b_by = bounds[f"K6 {label}"]
        work = ck.k6_work(4, c_in, block.conv1.out_channels, block.conv2.out_channels, f, 938,
                          block.skip is not None, sms)
        rows.append(text + f"; ms={ms:.4f} plain_ms={plain_ms:.3f} model_block_ms={lib_ms:.4f} "
                    f"(device time under torch.profiler: {fmt_ms(dev_ms)} / "
                    f"{fmt_ms(dev_plain_ms, '.3f')} / {fmt_ms(dev_lib_ms)}) "
                    f"bound_ms={b_ms:.4f} ({b_by}); executed / useful work: "
                    f"conv1 {work['conv1_executed'] / work['conv1_useful']:.4f}, block "
                    f"{work['executed'] / work['useful']:.4f}; TFLOP/s useful "
                    f"{flops / ms / 1e9:.1f}"
                    f" (device time {fmt_rate(flops, dev_ms)}), executed "
                    f"{fmt_rate(work['executed'], dev_ms)} (device time), at the bound "
                    f"{flops / b_ms / 1e9:.1f} ok")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("flops", flops), ("nbytes", nbytes)):
            total[key] += v
        total["max_abs_err"] = max(total["max_abs_err"], err)
        del x, args
    torch.manual_seed(SEED + 12)
    identity = cnn_rnn.ResidualBlock(64, 64)
    randomize_bn(identity, SEED + 12)
    identity.cuda().eval()
    x = torch.from_numpy(rng.standard_normal((4, 64, 80, 938)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    _, _, faults, same_bits, text = hold_k6(torch, ck, x, identity, False, "ResidualBlock(64, 64)")
    fault_scores["ResidualBlock(64, 64)"], repeats = faults, repeats and same_bits
    rows.append(text + " ok")
    b_ms, b_by = bound(total.pop("flops"), PEAK_BF16, total.pop("nbytes"))
    return dict(total, bound_ms=b_ms, bound_by=b_by, repeats_identical=repeats,
                fault_scores=fault_scores)


def conv_phase(torch, ck, model, card):
    """Phase 4b on a copy of ``model`` (the port's CNNRNNLarge) with
    non-trivial BatchNorm statistics. Returns K5's and K6's records and
    their launches in the front end."""
    held = torch.cuda.memory_allocated()
    conv_model = copy.deepcopy(model)
    randomize_bn(conv_model, SEED + 10)
    conv_model.cuda().eval()
    rows = []
    t0 = time.perf_counter()
    k5 = check_k5(torch, ck, conv_model, rows)
    k6 = check_k6(torch, ck, conv_model, rows)
    launches = conv_front_end(torch, ck, conv_model, rows)
    del conv_model
    # torch.profiler (device_ms) leaves the frames of the stack it ran in,
    # and their tensors, in a reference cycle once they return: collect it
    # here, or it counts in a later phase's memory
    gc.collect()
    print(f"[4b] K5 and K6 vs their plain versions and the model's front end on {card} "
          f"({time.perf_counter() - t0:.1f} s); device memory allocated before / after "
          f"{held} / {torch.cuda.memory_allocated()} bytes")
    for r in rows:
        print("    " + r)
    return k5, k6, launches


def conv_front_end(torch, ck, model, rows) -> dict:
    """The model's inference CNN front end on the card (B=4, 320 mel bins,
    T=938) with both ConvBNRelu stages through K5 and both residual blocks
    through K6, against the model's own front end: exactly 2 K5 and 2 K6
    launches. Returns the launch counts."""
    def k5_stage(h, conv, bn, dt):
        return ck.conv_bn_relu_stage(h, conv, bn, pool=True)

    def k6_block(h, block, dt, pool):
        return ck.res_block_stage(h, block, pool=pool)

    def front_end(kernels: bool):
        with torch.no_grad():
            return model.cnn_features(x, **({"stage": k5_stage, "block": k6_block}
                                             if kernels else {}))

    x = torch.from_numpy((np.random.default_rng(SEED + 11).standard_normal((4, 1, 320, 938))
                          * 10.0 - 40.0).astype(np.float32)).cuda()
    ref = front_end(kernels=False)
    ck.fused_conv_bn_relu.launches = 0
    ck.fused_res_block.launches = 0
    got = front_end(kernels=True)
    torch.cuda.synchronize()
    launches = {"fused_conv_bn_relu": ck.fused_conv_bn_relu.launches,
                "fused_res_block": ck.fused_res_block.launches}
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    max_ratio = float(err.max()) / float(ref.abs().max())
    rms_ratio = float(err.pow(2).mean().sqrt()) / float(ref.pow(2).mean().sqrt())
    k_ms, model_ms = (cuda_ms(lambda: front_end(k), reps=5) for k in (True, False))
    k_dev, model_dev = (device_ms(torch, lambda: front_end(k), reps=5) for k in (True, False))
    tol = ck.FRONT_END_TOL
    ok = (launches == {"fused_conv_bn_relu": 2, "fused_res_block": 2}
          and got.shape == (4, 256, 40, 938) and bool(torch.isfinite(got).all())
          and max_ratio <= tol["max"] and rms_ratio <= tol["rms"])
    rows.append(f"front end (B=4, 320 x 938 -> {tuple(got.shape)}) with both ConvBNRelu stages "
                f"through K5 and both residual blocks through K6 vs the model's own: "
                f"max|err|/max|ref| {max_ratio:.3e} (tol {tol['max']:g}), rms ratio "
                f"{rms_ratio:.3e} (tol {tol['rms']:g}), launches {launches}; ms {k_ms:.3f} "
                f"through K5 + K6, {model_ms:.3f} the model's own (device time under "
                f"torch.profiler {fmt_ms(k_dev, '.3f')} / {fmt_ms(model_dev, '.3f')}) "
                f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(rows[-1])
    return launches


def device_busy_union_ms(prof) -> float:
    """The device's busy time in a profile (ms): the union of its device
    events' intervals, so that a range annotated on the device (the
    optimizer's ``Optimizer.step#...``) counts the kernels under it once."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6


def device_time_by_kernel(prof, wall_s: float, top: int = 12):
    """Print a profile's device busy time, idle share and top kernels, summed
    from the trace's raw device events (kernels, copies, fills): the
    profiler's own tables build a Python object an event, some 100 s for the
    10^5-10^6 launches of an AST request."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns, count = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), count + 1)
    busy_us = sum(ns for ns, _ in by_name.values()) / 1e3
    wall_us = wall_s * 1e6
    print(f"      device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
          f"(idle share {1 - busy_us / wall_us:.3f}), "
          f"{sum(c for _, c in by_name.values())} device events")
    for name, (ns, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"      {ns / 1e6:9.3f} ms  x{count:<4d} {name[:90]}")


def timed_request_ms(torch, server, y) -> float:
    """One request on a server already warm, host clock around work that
    ends in a synchronize. A collection first, so that the reading holds no
    full collection of garbage earlier work left."""
    torch.cuda.synchronize()
    gc.collect()
    t0 = time.perf_counter()
    server.transcribe_array(y)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def warm_request_ms(torch, server, y) -> float:
    """One request after one untimed (``timed_request_ms``)."""
    server.transcribe_array(y)
    return timed_request_ms(torch, server, y)


# Phase 4's fp32 -w 120 request through "auto" (K3-fp32) and "xla" (the
# plain attention): the two attentions agree element by element within
# K3_TOL["float32"] (summation order alone, 1e-5 of |o| and of P|V|), and the
# fp32 layers after them carry a relative difference of that order on to
# the frame logits; a probability moves by at most a quarter of its logit's
# change. 1e-4 on the probabilities leaves that 1e-5 ten times over.
FP32_ROUTE_TOL = 1e-4


FP32_WINDOW_REPS = 5  # timed requests a route, the routes in turns


def fp32_window_phase(torch, ak, pth, wav120) -> dict:
    """The default model with compute_dtype="float32" (``pth``'s seeded
    weights) on the -w 120 WAV (4 windows, T=3751), through "auto", which
    takes K3-fp32 (1 launch a request), and through "xla" (0 launches): after
    one untimed request a route, FP32_WINDOW_REPS warm requests a route in
    turns, each after a collection (``timed_request_ms``), and as many
    forwards alone (mel + model + sigmoid, host clock to the copy back: no
    note decode); medians. The two routes' frame probabilities within
    FP32_ROUTE_TOL. Returns the readings."""
    from music_transcription_tpu_torch.config import ModelConfig
    from music_transcription_tpu_torch.data.audio import load_audio
    from music_transcription_tpu_torch.transcribe import Transcriber, replica_forward

    server = Transcriber(pth, model_cfg=ModelConfig(compute_dtype="float32"), window=120.0,
                         device="cuda")
    acfg = server.loaded.audio_cfg
    y, _ = load_audio(wav120, sr=acfg.sample_rate)
    chunks = server.split(y)
    routes = ("auto", "xla")
    request_ms, forward_ms, launches, probs = ({r: [] for r in routes} for _ in range(4))
    for route in routes:
        server.loaded.model.set_attention_backend(route)
        server.transcribe_array(y)
    for _ in range(FP32_WINDOW_REPS):
        for route in routes:
            server.loaded.model.set_attention_backend(route)
            ak.flash_attention_clamped.launches = 0
            request_ms[route].append(timed_request_ms(torch, server, y))
            launches[route].append(ak.flash_attention_clamped.launches)
            gc.collect()
            t0 = time.perf_counter()
            probs[route] = replica_forward(server.replicas, chunks, acfg,
                                           lambda m, mel: torch.sigmoid(m(mel)))
            forward_ms[route].append((time.perf_counter() - t0) * 1e3)
    out = {f"{r}_{k}": float(np.median(v[r])) for r in routes
           for k, v in (("ms", request_ms), ("forward_ms", forward_ms))}
    out.update({f"{r}_launches": launches[r][0] for r in routes})
    out["prob_err"] = float(np.abs(probs["auto"] - probs["xla"]).max())
    ok = (set(launches["auto"]) == {1} and set(launches["xla"]) == {0}
          and out["prob_err"] <= FP32_ROUTE_TOL and bool(np.isfinite(probs["auto"]).all())
          and probs["auto"].shape == (len(chunks), 88, acfg.mel_frames_per_chunk))
    print(f"    fp32 (compute_dtype='float32'), {len(chunks)} windows, medians of "
          f"{FP32_WINDOW_REPS} in turns: warm request through 'auto' {out['auto_ms']:.1f} ms "
          f"(K3 launches {out['auto_launches']} a request), through 'xla' {out['xla_ms']:.1f} ms "
          f"({out['xla_launches']}); the forward alone {out['auto_forward_ms']:.1f} against "
          f"{out['xla_forward_ms']:.1f} ms (requests {[round(v, 1) for v in request_ms['auto']]} / "
          f"{[round(v, 1) for v in request_ms['xla']]}); frame probabilities max |auto - xla| "
          f"{out['prob_err']:.3e} (tol {FP32_ROUTE_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fp32 -w 120 routes: {out}, launches {launches}")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_request(torch, server, y, cpu_ops: bool = True):
    """Where a warm request's time goes: host stages (clock around work that
    ends in a synchronize) and device time by kernel (torch.profiler; without
    ``cpu_ops`` the device's activity alone, for a request of some 10^5
    launches)."""
    from torch.profiler import ProfilerActivity, profile

    from music_transcription_tpu_torch.data.midi import pianoroll_to_notes
    from music_transcription_tpu_torch.transcribe import transcribe_chunks

    acfg = server.loaded.audio_cfg
    gc.collect()  # as warm_request_ms
    activities = [ProfilerActivity.CPU] * cpu_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        chunks = server.split(y)
        t1 = time.perf_counter()
        roll = transcribe_chunks(server.loaded, chunks, server.threshold,
                                 constrained=server.constrained, beam=server.beam)
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


def write_maestro_tree(root, seed: int, pieces) -> None:
    """A seeded raw MAESTRO-v3 layout (CSV + WAV + MIDI): one recording per
    (split, seconds) of ``pieces``, each a ``write_wav`` signal with a MIDI
    file of 200 random notes."""
    import csv

    from music_transcription_tpu_torch.data import midi as midi_io

    rng = np.random.default_rng(seed)
    rows = []
    for i, (split, seconds) in enumerate(pieces):
        rel_wav, rel_mid = f"2018/piece{i}.wav", f"2018/piece{i}.midi"
        os.makedirs(os.path.join(root, "2018"), exist_ok=True)
        write_wav(os.path.join(root, rel_wav), seconds, seed + i)
        starts = np.sort(rng.random(200) * (seconds - 1.0))
        notes = [midi_io.Note(pitch=int(p), start=float(s), end=float(s + d), velocity=80)
                 for p, s, d in zip(rng.integers(30, 100, 200), starts, 0.1 + rng.random(200))]
        midi_io.save_midi(midi_io.notes_to_midi(notes), os.path.join(root, rel_mid))
        rows.append({"canonical_composer": "Seeded", "canonical_title": f"Piece {i}",
                     "split": split, "year": 2018, "midi_filename": rel_mid,
                     "audio_filename": rel_wav, "duration": seconds})
    with open(os.path.join(root, "maestro-v3.0.0.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def run_evaluate(argv, cli: str = "evaluate") -> dict:
    """``python -m music_transcription_tpu_torch.evaluate`` (or ``cli``, e.g.
    ``evaluate_ast``) in this process (so that its launches are counted): its
    EVAL_* lines, or raises."""
    import importlib

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = importlib.import_module(f"music_transcription_tpu_torch.{cli}").main(argv)
    if rc != 0:
        raise AssertionError(f"evaluate {argv} exited {rc}:\n{out.getvalue()[-3000:]}")
    return {line.split("=")[0]: float(line.split("=")[1]) for line in out.getvalue().splitlines()
            if line.startswith("EVAL_")}


@contextlib.contextmanager
def recorded_steps(keep_batches: bool = False):
    """train/loop's train steps, recorded with their host time (each ends in
    a host read of its loss) and the host clock at their start and end:
    yields the list they are appended to. ``keep_batches`` also keeps a
    copy of each step's batch on the host, made before the step's end is
    read."""
    from music_transcription_tpu_torch.train import loop as train_loop

    steps, real_step = [], train_loop.train_step

    def recorded_step(state, batch, *args, **kwargs):
        t_start = time.perf_counter()
        metrics = real_step(state, batch, *args, **kwargs)
        ms = (time.perf_counter() - t_start) * 1e3
        kept = tuple(a.cpu() for a in batch) if keep_batches else None
        steps.append(dict(metrics, ms=ms, start=t_start, end=time.perf_counter(), batch=kept))
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
    The peak is the caching allocator's: the blocks it handed out, which may
    exceed the bytes the tensors asked for (a block is not split when less
    than 1 MiB would remain), so it also depends on the blocks earlier work
    left cached; the peak of the bytes asked for is printed beside it.
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
    gc.collect()  # a peak counts no garbage of earlier phases
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times = []
    for batch in batches[1:7]:
        t_start = time.perf_counter()
        metrics = train_step(state, batch, SEED + 1, max_grad_norm=1.0)
        times.append((time.perf_counter() - t_start) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    requested = torch.cuda.memory_stats().get("requested_bytes.all.peak", float("nan"))
    ms = float(np.median(times))
    audio_s = tcfg.batch_size * acfg.chunk_length
    print(f"    warm train step, attention {mcfg.attention_backend!r} (batch {tcfg.batch_size}, "
          f"T={acfg.mel_frames_per_chunk}): median {ms:.1f} ms of {[round(t, 1) for t in times]}; "
          f"{tcfg.batch_size / ms * 1e3:.2f} samples/s, {audio_s / ms * 1e3:.1f} audio-s/s; "
          f"peak memory {peak / 2**30:.2f} GiB (requested {requested / 2**30:.2f} GiB; "
          f"{held / 2**30:.2f} GiB held before the steps); loss {metrics['loss']:.5f}")
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


FP32_STEP_ROWS = 12  # chunks of the timed fp32 flash step: a world-2 rank's share of 24
FP32_STEP_REPS = 4  # warm steps a route, the routes in turns


def time_fp32_flash_steps(torch, ak) -> dict:
    """Warm full-width fp32 train steps: the default model with
    compute_dtype="float32" and TrainConfig() on a seeded batch of
    FP32_STEP_ROWS 30 s chunks staged on the card, through attention
    "pallas" (K3 with lse, K4a and K4b once a step) and "xla" (none) in
    turns: one untimed step a route, then FP32_STEP_REPS a route, host clock
    to the step's host read; medians, each route's launches and peak device
    memory. Then one "pallas" step under torch.profiler: the three flash
    kernels' device time (K4b's delta pre-pass included) and its share of
    the step. Returns the readings."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, TrainConfig
    from music_transcription_tpu_torch.parallel.train_step import init_train_state, train_step

    acfg, tcfg = AudioConfig(), TrainConfig()
    mcfg = ModelConfig(compute_dtype="float32", lstm_backend="pallas")
    n, t = FP32_STEP_ROWS, acfg.mel_frames_per_chunk
    state = init_train_state(mcfg, tcfg, "cuda")
    rng = np.random.default_rng(SEED + 9)
    batch = tuple(torch.from_numpy(a).cuda() for a in (
        rng.standard_normal((n, 1, mcfg.n_mels, t)).astype(np.float32),
        (rng.random((n, 88, t)) > 0.95).astype(np.float32),
        np.full((n,), t, np.int32)))
    flash = (ak.flash_attention_clamped_fwd, ak.flash_attention_clamped_dq,
             ak.flash_attention_clamped_dkv)
    routes = ("pallas", "xla")
    times, launches, peaks, losses = ({r: [] for r in routes} for _ in range(4))

    def step(route):
        state.model.set_attention_backend(route)
        for counter in flash:
            counter.launches = 0
        t_start = time.perf_counter()
        metrics = train_step(state, batch, SEED + 1, max_grad_norm=tcfg.max_grad_norm)
        ms = (time.perf_counter() - t_start) * 1e3
        launches[route].append(tuple(c.launches for c in flash))
        losses[route].append(metrics["loss"] if not metrics["skipped"] else float("nan"))
        return ms

    for route in routes:
        step(route)
    for _ in range(FP32_STEP_REPS):
        for route in routes:
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            times[route].append(step(route))
            peaks[route].append(torch.cuda.max_memory_allocated())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        step("pallas")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_start) * 1e3
    flash_ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and "flash_" in e.name())
    out = {f"{r}_ms": float(np.median(times[r])) for r in routes}
    out.update({f"{r}_peak_gib": max(peaks[r]) / 2**30 for r in routes})
    out.update(profiled_ms=wall_ms, busy_ms=device_busy_union_ms(prof), flash_ms=flash_ns / 1e6)
    ok = (set(launches["pallas"]) == {(1, 1, 1)} and set(launches["xla"]) == {(0, 0, 0)}
          and all(np.isfinite(v) for r in routes for v in losses[r]))
    print(f"    fp32 train step, full width, {n} x 30 s chunks (T={t}), medians of "
          f"{FP32_STEP_REPS} in turns: attention 'pallas' {out['pallas_ms']:.1f} ms "
          f"(K3+lse/K4a/K4b launches a step {launches['pallas'][-1]}, peak "
          f"{out['pallas_peak_gib']:.2f} GiB) against 'xla' {out['xla_ms']:.1f} ms "
          f"({launches['xla'][-1]}, peak {out['xla_peak_gib']:.2f} GiB); steps "
          f"{[round(v, 1) for v in times['pallas']]} / {[round(v, 1) for v in times['xla']]}; "
          f"one 'pallas' step under torch.profiler: {wall_ms:.1f} ms, device busy "
          f"{out['busy_ms']:.1f} ms, the flash kernels {out['flash_ms']:.2f} ms "
          f"({out['flash_ms'] / wall_ms:.3f} of the step) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fp32 flash steps: launches {launches}, losses {losses}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


MEL_DEVICE_TOL = 6e-2  # dB: the device mel against the host's, the JAX package's own bound


def preprocess_slab_phase(torch, lk, ak, card):
    """Phase 6b: preprocess a seeded raw MAESTRO-layout tree with the
    preprocessing CLI on the card and on the host, then train the default
    model from the card-built cache through slab rotation."""
    from music_transcription_tpu_torch import native
    from music_transcription_tpu_torch import preprocess as preprocess_cli
    from music_transcription_tpu_torch.config import AudioConfig
    from music_transcription_tpu_torch.data import cache, pipeline
    from music_transcription_tpu_torch.train import __main__ as train_cli

    acfg = AudioConfig()
    root = os.path.join(WORK, "maestro_slab")
    dev_cache, host_cache = os.path.join(WORK, "cache_card"), os.path.join(WORK, "cache_host")
    host1_cache, run_dir = os.path.join(WORK, "cache_host_1"), os.path.join(WORK, "slab_run")
    for d in (root, dev_cache, host_cache, host1_cache, run_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    # 4 train pieces of 380 s: 12 chunks of 30 s and a 20 s tail each (a tail
    # of at least half a chunk is kept); 1 validation piece of 121 s: 4 chunks
    write_maestro_tree(root, SEED + 11, [("train", 380.0)] * 4 + [("validation", 121.0)])
    print(f"[6b] raw tree of 4 x 380 s train and 1 x 121 s validation pieces written in "
          f"{time.perf_counter() - t0:.1f} s; host kit built: {native.available()} "
          f"({native.library_path().name})")
    if not native.available():
        raise AssertionError("the host kit did not build")

    argv = ["--root_dir", root, "--splits", "train,validation", "--n_mels", str(acfg.n_mels),
            "--verify"]
    rates = {}
    # the card path with 2 decoder threads, the host path with a pool of 2
    # spawned workers, and the host path in this process (no pool to start)
    for name, out, device, workers in (("card", dev_cache, "cuda", 2),
                                       ("host", host_cache, "cpu", 2),
                                       ("host in this process", host1_cache, "cpu", 1)):
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = preprocess_cli.main(argv + ["--cache_dir", out, "-d", device,
                                             "--num_workers", str(workers)])
        wall = time.perf_counter() - t0
        n = sum(cache.load_metadata(out, split)["num_chunks"] for split in ("train", "validation"))
        verified = [cache.verify_cache(out, split) for split in ("train", "validation")]
        rates[name] = n / wall
        print(f"    preprocess -d {device} --num_workers {workers}: rc {rc}, {n} chunks in "
              f"{wall:.2f} s ({n / wall:.1f} chunks/s), verify {verified}")
        if rc != 0 or log.getvalue().count("verify: OK") != 2 or not all(ok for ok, _ in verified):
            raise AssertionError(f"preprocessing on {device} failed:\n{log.getvalue()[-3000:]}")
    print(f"    card path {rates['card']:.1f} chunks/s against the host path's "
          f"{rates['host']:.1f} ({rates['card'] / rates['host']:.2f}x) and "
          f"{rates['host in this process']:.1f} in this process "
          f"({rates['card'] / rates['host in this process']:.2f}x), on {card}")
    worst, tails = 0.0, 0
    for split in ("train", "validation"):
        meta = cache.load_metadata(dev_cache, split)
        if meta != cache.load_metadata(host_cache, split):
            raise AssertionError(f"the {split} metadata differs between the card and the host")
        for i in range(meta["num_chunks"]):
            a = cache.load_chunk(os.path.join(dev_cache, split), i)
            b = cache.load_chunk(os.path.join(host_cache, split), i)
            if a["mel"].shape != b["mel"].shape or not np.array_equal(a["roll"], b["roll"]):
                raise AssertionError(f"{split} chunk {i}: shape or roll differs")
            worst = max(worst, float(np.abs(a["mel"] - b["mel"]).max()))
            tails += a["mel"].shape[1] < acfg.mel_frames_per_chunk - 1
    n_train = cache.load_metadata(dev_cache, "train")["num_chunks"]
    n_val = cache.load_metadata(dev_cache, "validation")["num_chunks"]
    print(f"    card cache against host cache: {n_train} + {n_val} chunks ({tails} tails), rolls "
          f"identical, mel max_abs_err {worst:.3e} dB (tol {MEL_DEVICE_TOL})")
    if (n_train, n_val, tails) != (52, 4, 4) or worst > MEL_DEVICE_TOL:
        raise AssertionError("the card-built cache disagrees with the host-built one")

    made = []

    class Recorded(pipeline.SlabRotatingLoader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    counters = (lk.lstm_recurrence, lk.lstm_recurrence_fwd, lk.lstm_recurrence_bwd)
    real_loader = pipeline.SlabRotatingLoader
    pipeline.SlabRotatingLoader = Recorded
    try:
        with recorded_steps(keep_batches=True) as steps:
            for counter in counters:
                counter.launches = 0
            gc.collect()  # a peak counts no garbage of earlier phases
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                rc = train_cli.main(["--cache_dir", dev_cache, "--root_dir", root,
                                     "--run_dir", run_dir, "--device_data", "slab",
                                     "--slab_gb", "0.02", "--batch_size", "24", "--epochs", "2",
                                     "--num_workers", "4", "--seed", str(SEED)])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = {c.__name__: c.launches for c in counters}
    finally:
        pipeline.SlabRotatingLoader = real_loader
    (loader,) = made
    print(f"    train CLI --device_data slab --slab_gb 0.02: rc {rc}, wall {wall:.1f} s; "
          f"{loader.n_slabs} slabs x {loader.items_per_slab} items of {loader.item_bytes} bytes, "
          f"{len(loader)} steps an epoch; step losses {[round(m['loss'], 5) for m in steps]}, "
          f"skipped {sum(m['skipped'] for m in steps)}; launches {launches}")
    if rc != 0:
        raise AssertionError(f"slab training failed:\n{log.getvalue()[-3000:]}")
    if (loader.n_slabs, loader.items_per_slab, loader.item_bytes) != (2, 24, 682868) \
            or len(steps) != 4 or any(m["skipped"] for m in steps) \
            or not all(np.isfinite(m["loss"]) for m in steps):
        raise AssertionError("slab training did not take 4 finite steps over 2 slabs")
    if launches != {"lstm_recurrence": 4 * 2, "lstm_recurrence_fwd": 4 * 4,
                    "lstm_recurrence_bwd": 4 * 4}:
        raise AssertionError(f"slab training missed a kernel: {launches}")

    # every batch equals the same items loaded on the host: load_chunk,
    # collate_mel, the mel rounded to bf16 and widened, the roll widened
    data = cache.CachedMaestroDataset(dev_cache, "train", verbose=False)
    expected = [slab[order[b * 24:(b + 1) * 24]] for epoch in range(2)
                for slab, orders in loader.plan(epoch) for order in orders
                for b in range(loader.items_per_slab // 24)]
    for k, (idx, m) in enumerate(zip(expected, steps, strict=True)):
        mel, roll, lengths = pipeline.collate_mel([data[int(i)] for i in idx],
                                                  pad_to=acfg.mel_frames_per_chunk)
        want = (torch.from_numpy(mel).to(torch.bfloat16).float(), torch.from_numpy(roll),
                torch.from_numpy(lengths))
        for got, ref in zip(m["batch"], want, strict=True):
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                raise AssertionError(f"step {k + 1}'s batch differs from its items on the host")
    print(f"    all {len(steps)} batches bit-identical to their items loaded on the host "
          f"(load_chunk, collate_mel, bf16 round, widened)")

    for j, st in enumerate(loader.stage_log):
        print(f"    slab {j + 1} (epoch {j // 2 + 1}): {st['items']} items, "
              f"{st['bytes'] / 1e6:.2f} MB, host {st['host_s'] * 1e3:.1f} ms, copy "
              f"{st['copy_s'] * 1e3:.2f} ms ({st['bytes'] / max(st['copy_s'], 1e-9) / 1e9:.2f} "
              f"GB/s)")
    for k, m in enumerate(steps):
        wait = (m["start"] - steps[k - 1]["end"]) * 1e3 if k else float("nan")
        kind = "first of a slab staged behind the last" if k % 2 else "first of an epoch"
        print(f"    step {k + 1} ({kind}): {m['ms']:.1f} ms, loader wait before it "
              f"{wait:.1f} ms")
    print(f"    peak device memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before), "
          f"on {card}")


def flash_train_phase(torch, lk, ak, rows, xla_ms):
    """Phase 7: the default model with attention_backend="pallas" through
    train/loop.train_model on the phase-6 cache staged on the card, 2 epochs
    of 2 steps. Returns the main path's launch counts, the path of
    model_best and the fp32 flash step's launches (K3 with lse, K4a, K4b)."""
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
    flash = (ak.flash_attention_clamped_fwd, ak.flash_attention_clamped_dq,
             ak.flash_attention_clamped_dkv)
    for counter in flash:
        counter.launches = 0
    check_fp32_step(torch, mcfg, tcfg, rows)
    fp32_launches = {c.__name__: c.launches for c in flash}
    if set(fp32_launches.values()) != {1}:
        raise AssertionError(f"the fp32 flash step should launch each kernel once: {fp32_launches}")
    time_fp32_flash_steps(torch, ak)
    return launches, best, fp32_launches


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
    write_maestro_tree(root, SEED + 9, [("test", 121.0)] * 2)
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


# Card against CPU for the AST tier at full width, over the CPU's largest
# value (encoder memory, teacher-forced logits): the serving check's bounds
# (phase 3). Greedy tokens agree up to the first step where the CPU logits'
# top-2 margin falls below the logit tolerance.
AST_REL_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
AST_CHECK_STEPS = 256


def ast_card_vs_cpu(torch, model, wave):
    """One 30 s chunk at B=1 on the card and on the CPU, fp32 and bf16:
    memory, teacher-forced logits over AST_CHECK_STEPS targets, and as many
    greedy tokens."""
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel

    rng = np.random.default_rng(SEED + 21)
    tg = torch.from_numpy(rng.integers(3, model.config.remi_vocab_size, (1, AST_CHECK_STEPS)))
    tg[:, 0] = 0
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(model.config, compute_dtype=dtype)
        cpu_m, card_m = TranscriptionModel(cfg).eval(), TranscriptionModel(cfg).eval()
        cpu_m.load_state_dict(model.state_dict())
        card_m.load_state_dict(model.state_dict())
        card_m.cuda()
        tol = AST_REL_TOL[dtype]
        with torch.inference_mode():
            errs = {}
            for name, fn in (("memory", lambda m, w: m.model.memory(w).float()),
                             ("teacher-forced logits", lambda m, w: m(w, targets=tg.to(w.device)))):
                ref, got = fn(cpu_m, wave), fn(card_m, wave.cuda()).cpu()
                scale = float(ref.abs().max())
                errs[name] = (float((got - ref).abs().max()), scale)
                if not (got.shape == ref.shape and bool(torch.isfinite(got).all())
                        and errs[name][0] <= tol * scale):
                    raise AssertionError(f"AST {dtype} {name} disagrees with the CPU: {errs[name]}")
            logit_tol = tol * errs["teacher-forced logits"][1]
            ref_ids = cpu_m(wave, generate_max_len=AST_CHECK_STEPS)[0]
            got_ids = card_m(wave.cuda(), generate_max_len=AST_CHECK_STEPS)[0].cpu()
            diff = (got_ids != ref_ids).nonzero()
            agreed = AST_CHECK_STEPS if len(diff) == 0 else int(diff[0])
            margin = None
            if agreed < AST_CHECK_STEPS:
                seq = torch.cat([torch.zeros(1, dtype=torch.long), ref_ids[:agreed]])[None]
                logits = cpu_m(wave, targets=seq)[0, agreed].double()
                if agreed > 0:
                    logits[0] = -1e9  # the SOS mask
                top2 = logits.sort().values[-2:]
                margin = float(top2[1] - top2[0])
                if margin >= logit_tol:
                    raise AssertionError(f"AST {dtype} greedy departs from the CPU at step "
                                         f"{agreed} with a top-2 margin {margin} >= {logit_tol}")
        print(f"    {dtype}: card vs CPU memory max_abs_err {errs['memory'][0]:.3e} "
              f"(tol {tol} x {errs['memory'][1]:.3e}), teacher-forced logits "
              f"{errs['teacher-forced logits'][0]:.3e} (tol {tol} x "
              f"{errs['teacher-forced logits'][1]:.3e}); greedy: {agreed} of "
              f"{AST_CHECK_STEPS} steps agree"
              + ("" if margin is None else f", then a near-tie (top-2 margin {margin:.3e})"))


def ast_phase(torch, counters, wav30, card):
    """Phase 8b: the AST tier's inference path at full width on the card,
    through no hand-written kernel."""
    from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, config_to_dict
    from music_transcription_tpu_torch.data.audio import load_audio
    from music_transcription_tpu_torch.data.midi import load_midi, notes_to_midi, save_midi
    from music_transcription_tpu_torch.data.midi import pianoroll_to_notes
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.transcribe import (
        Transcriber,
        transcribe_audio,
        transcribe_chunks,
    )

    torch.manual_seed(SEED + 20)
    mcfg, acfg = ModelConfig(model_type="ast"), AudioConfig()
    model = TranscriptionModel(mcfg).eval()
    n_params = sum(p.numel() for p in model.parameters())
    pth, mid = os.path.join(WORK, "ast.pth"), os.path.join(WORK, "ast.mid")
    torch.save(model.model.state_dict(), pth)
    with open(os.path.join(WORK, "ast.json"), "w") as f:
        json.dump({"model": config_to_dict(mcfg), "audio": config_to_dict(acfg)}, f)
    y, _ = load_audio(wav30, sr=acfg.sample_rate)
    frames = 4 * acfg.roll_frames_per_chunk

    def launches():
        return {c.__name__: c.launches for c in counters}

    def midi_notes(path) -> int:
        # a MIDI file of no notes reads back with no instrument
        return sum(len(inst.notes) for inst in load_midi(path).instruments)

    for c in counters:
        c.launches = 0
    gc.collect()  # a peak counts no garbage of earlier phases
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t_phase = t0 = time.perf_counter()
    transcribe_audio(wav30, pth, mid, verbose=False, device="cuda")
    torch.cuda.synchronize()
    print(f"[8b] AST route: {n_params:,} params, 4 chunks of 30 s, {mcfg.max_output_len} "
          f"tokens a chunk; transcribe_audio (greedy, first request) wall "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, "
          f"{midi_notes(mid)} notes")
    servers, request_ms = {}, {}
    for name, kw in (("greedy", {}), ("beam 4", {"beam": 4}), ("constrained", {"constrained": True})):
        servers[name] = server = Transcriber(pth, device="cuda", **kw)
        roll = transcribe_chunks(server.loaded, server.split(y), constrained=server.constrained,
                                 beam=server.beam)
        notes = pianoroll_to_notes(roll, fs=acfg.frame_rate)
        save_midi(notes_to_midi(notes), mid)
        n_notes = midi_notes(mid)
        if (roll.shape != (88, frames) or not np.isin(roll, (0.0, 1.0)).all()
                or n_notes != len(notes)):
            raise AssertionError(f"AST {name}: roll of shape {roll.shape}, not (88, {frames})")
        if name != "constrained":
            request_ms[name] = timed_request_ms(torch, server, y)
        print(f"    {name}: roll {roll.shape}, {n_notes} notes written and read back"
              + (f"; warm request {request_ms[name]:.1f} ms" if name in request_ms else ""))
    peak = torch.cuda.max_memory_allocated()
    # ms per decode step: the generation loop alone, from the 4 chunks' memory
    gen = servers["greedy"].loaded.model.model
    with torch.inference_mode():
        chunks = torch.from_numpy(servers["greedy"].split(y)).cuda()
        memory = gen.memory(chunks)
        first = gen.generate(memory, max_len=mcfg.max_output_len)
        step_ms = {}
        for name, fn in (("greedy, 4 rows", lambda: gen.generate(memory, max_len=mcfg.max_output_len)),
                         ("beam 4, 16 rows", lambda: gen.generate_beam(
                             memory, beam_size=4, max_len=mcfg.max_output_len))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = fn()
            torch.cuda.synchronize()
            step_ms[name] = (time.perf_counter() - t0) * 1e3 / mcfg.max_output_len
            if name.startswith("greedy") and not torch.equal(ids, first):
                raise AssertionError("greedy generation repeated on the same input differs")
    print(f"    greedy repeated on the same input: identical tokens; ms per decode step "
          + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items())
          + f"; peak device memory {peak / 2**30:.2f} GiB over the requests "
          f"({held / 2**30:.2f} GiB held before them)")
    t0 = time.perf_counter()
    profile_request(torch, servers["greedy"], y, cpu_ops=False)
    print(f"    (profiled greedy request, trace processed in {time.perf_counter() - t0:.1f} s)")
    ast_card_vs_cpu(torch, model, torch.from_numpy(servers["greedy"].split(y)[:1]))

    # evaluate_ast on the card on phase 8's raw tree (2 test pieces of 121 s)
    root = os.path.join(WORK, "maestro_raw")
    base = ["--model", pth, "--root_dir", root, "--split", "test", "--headless", "-d", "cuda",
            "--max_len", str(mcfg.max_output_len)]
    t0 = time.perf_counter()
    gen_scores = run_evaluate(base + ["--subset", "4", "--constrained", "--beam", "2",
                                      "--frame_f1"], cli="evaluate_ast")
    t1 = time.perf_counter()
    tf_scores = run_evaluate(base + ["--teacher_forced"], cli="evaluate_ast")
    print(f"    evaluate_ast --constrained --beam 2 --frame_f1 on 4 chunks: {gen_scores}, wall "
          f"{(t1 - t0):.1f} s; --teacher_forced on 8 chunks: {tf_scores}, wall "
          f"{time.perf_counter() - t1:.1f} s")
    if (set(gen_scores) != {"EVAL_AST_NOTE_F1", "EVAL_AST_FRAME_F1"}
            or set(tf_scores) != {"EVAL_AST_TF_ACC", "EVAL_AST_TF_PITCH_ACC"}
            or not all(np.isfinite(v) for v in {**gen_scores, **tf_scores}.values())):
        raise AssertionError("evaluate_ast printed no finite EVAL_AST_* lines")
    if any(launches().values()):
        raise AssertionError(f"the AST route launched a hand-written kernel: {launches()}")
    print(f"    hand-written kernel launches in the phase: {launches()} on {card}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")


# Card against CPU for one fp32 AST token step at full width (B=2, 10 s, 256
# tokens, dropout 0, pitch_loss_weight 3): the loss relative to the CPU's, and
# each class of gradients over its class's largest CPU gradient. fp32
# summation order only (cuBLAS without TF32 and cuFFT against the CPU's):
# phase 6's 1e-4 for the loss, the serving check's 1e-3 for the gradients.
# tests/test_torch_train_ast_step.py shows every bound rejecting each faulty
# step: the targets unshifted, the causal mask dropped, the class weights
# divided by the count of positions in place of their sum.
AST_STEP_TOL = {"loss": 1e-4, "dense kernels": 1e-3, "biases": 1e-3, "LayerNorm": 1e-3,
                "embeddings": 1e-3}


def ast_grad_classes(torch, module) -> dict:
    """{parameter name: its AST_STEP_TOL class}."""
    out = {}
    for mn, mod in module.named_modules():
        for pn, _ in mod.named_parameters(recurse=False):
            name = f"{mn}.{pn}" if mn else pn
            if isinstance(mod, torch.nn.LayerNorm):
                out[name] = "LayerNorm"
            elif isinstance(mod, torch.nn.Embedding):
                out[name] = "embeddings"
            else:
                out[name] = "biases" if pn == "bias" else "dense kernels"
    return out


def ast_step_errors(classes: dict, ref_loss: float, got_loss: float, ref_grads: dict,
                    got_grads: dict) -> dict:
    """{"loss": (relative error, ""), class: (worst |got - ref| over the
    class's largest |ref|, its parameter)} for AST_STEP_TOL. Gradients are
    CPU tensors by parameter name."""
    scale = {}
    for name, g in ref_grads.items():
        scale[classes[name]] = max(scale.get(classes[name], 0.0), float(g.abs().max()))
    out = {"loss": (abs(got_loss - ref_loss) / abs(ref_loss), "")}
    for name, g in ref_grads.items():
        err = float((got_grads[name] - g).abs().max()) / scale[classes[name]]
        if err >= out.get(classes[name], (-1.0, ""))[0]:
            out[classes[name]] = (err, name)
    return out


def step_grads(torch, module) -> dict:
    return {k: (p.grad.detach().cpu() if p.grad is not None else torch.zeros_like(p).cpu())
            for k, p in module.named_parameters()}


def run_train_ast(argv) -> str:
    """``python -m music_transcription_tpu_torch.train_ast`` in this process
    (so that its launches are counted): its output, or raises. The CLI's
    SIGTERM handler is taken back afterwards."""
    import signal

    from music_transcription_tpu_torch import train_ast

    saved = signal.getsignal(signal.SIGTERM)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = train_ast.main(argv)
    finally:
        signal.signal(signal.SIGTERM, saved)
    if rc != 0:
        raise AssertionError(f"train_ast {argv} exited {rc}:\n{out.getvalue()[-3000:]}")
    return out.getvalue()


def log_values(path) -> list[float]:
    with open(path) as f:
        return [float(v) for v in re.findall(r"=(-?[\d.]+|nan|inf)", f.read())]


def ast_step_card_vs_cpu(torch, wave):
    """One fp32 token step of the full-width AST model on the card and on
    the CPU from the same weights (plain, then scheduled sampling at p = 1
    when the first pass's argmax agrees on every position), held to
    AST_STEP_TOL."""
    from music_transcription_tpu_torch.config import ModelConfig
    from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.train import ast_step

    cfg = ModelConfig(model_type="ast", compute_dtype="float32", dropout=0.0)
    torch.manual_seed(SEED + 31)
    base = TranscriptionModel(cfg)
    for blk in base.model.enc_blocks:
        blk.dropout = 0.0  # the encoder's fixed 0.1 would draw other bits on each device
    rng = np.random.default_rng(SEED + 32)
    tokens = torch.from_numpy(rng.integers(3, cfg.remi_vocab_size, (2, 256)))
    tokens[:, 0] = 0
    cw = torch.from_numpy(ast_step.pitch_class_weights(REMITokenizer(), 512, 3.0))
    classes = ast_grad_classes(torch, base.model)
    card = copy.deepcopy(base).cuda()
    inp = tokens[:, :-1]
    with torch.no_grad():
        argmax = [m.eval()(w, targets=inp.to(w.device)).argmax(-1).cpu()
                  for m, w in ((base, wave), (card, wave.cuda()))]
    agree = int((argmax[0] == argmax[1]).sum())
    print(f"    scheduled sampling's first pass, fp32, card vs CPU: {agree} of "
          f"{argmax[0].numel()} argmax tokens agree")
    del card
    for label, ss_p in (("plain", None), ("scheduled sampling p=1", 1.0)):
        if ss_p is not None and agree < argmax[0].numel():
            print(f"    {label}: not held (a near-tie flipped an argmax)")
            continue
        runs = []
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(base).to(dev)
            opt = ast_step.make_adam(m.parameters(), 1e-4)
            loss = float(ast_step.token_step(m, opt, wave.to(dev), tokens.to(dev), ss_p=ss_p,
                                             class_weights=cw.to(dev)))
            runs.append((loss, step_grads(torch, m.model)))
            del m, opt
        errs = ast_step_errors(classes, runs[0][0], runs[1][0], runs[0][1], runs[1][1])
        ok = all(errs[k][0] <= tol for k, tol in AST_STEP_TOL.items())
        print(f"    fp32 token step ({label}, B=2, 10 s, 256 tokens, pitch weight 3), card vs "
              f"CPU: loss {runs[1][0]:.6f} vs {runs[0][0]:.6f}; worst error by class (tol): "
              + ", ".join(f"{k} {errs[k][0]:.3e}{' at ' + errs[k][1] if errs[k][1] else ''} "
                          f"({tol:g})" for k, tol in AST_STEP_TOL.items())
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"AST token step ({label}) disagrees with the CPU: {errs}")


def time_ast_steps(torch, wave, roll, lengths, tokens, card):
    """Median warm step (ms, host clock to the loss read) of the pretrain
    step, the token step and the token step with scheduled sampling at full
    width (batch 4, 10 s, 256 tokens, the CLI's defaults: dropout 0.2, bf16
    token model, fp32 pretrainer); the token steps under
    set_sync_debug_mode("error") until their loss is read. Then the peak
    device memory and one token step profiled."""
    from torch.profiler import ProfilerActivity, profile

    from music_transcription_tpu_torch.config import ModelConfig
    from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.models.transformer import ASTEncoderPretrainer
    from music_transcription_tpu_torch.train import ast_step

    dev = torch.device("cuda")
    wave, roll, lengths, tokens = (x.to(dev) for x in (wave, roll, lengths, tokens))
    torch.manual_seed(SEED + 33)
    pre = ASTEncoderPretrainer(dropout=0.2).to(dev)
    tok = TranscriptionModel(ModelConfig(model_type="ast")).to(dev)
    pre_opt, tok_opt = ast_step.make_adam(pre.parameters(), 1e-4), ast_step.make_adam(
        tok.parameters(), 1e-4)
    cw = torch.from_numpy(ast_step.pitch_class_weights(REMITokenizer(), 512, 3.0)).to(dev)

    def pretrain(s):
        gen, _ = ast_step.step_generators(SEED + 1, s, dev)
        return ast_step.pretrain_step(pre, pre_opt, wave, roll, lengths, generator=gen)

    def token(s, ss_p=None):
        gen, ss_gen = ast_step.step_generators(SEED + 1, s, dev)
        return ast_step.token_step(tok, tok_opt, wave, tokens, generator=gen, ss_p=ss_p,
                                   ss_generator=ss_gen, class_weights=cw)

    gc.collect()  # a peak counts no garbage of earlier phases
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms = {}
    for name, fn, no_sync in (("pretrain step (fp32)", pretrain, False),
                              ("token step", token, True),
                              ("token step, scheduled sampling p=0.5",
                               lambda s: token(s, 0.5), True)):
        for s in range(2):
            float(fn(s))
        times = []
        for s in range(2, 9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if no_sync:
                torch.cuda.set_sync_debug_mode("error")
            try:
                loss = fn(s)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            value = float(loss)
            times.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(value):
                raise AssertionError(f"{name}: loss {value}")
        ms[name] = float(np.median(times))
        print(f"    warm {name} (batch 4, 10 s{', 256 tokens' if 'token' in name else ''}): "
              f"median {ms[name]:.2f} ms of {[round(t, 2) for t in times]}"
              + ("; no host sync before the loss read" if no_sync else ""))
    peak = torch.cuda.max_memory_allocated()
    print(f"    peak device memory over the three: {peak / 2**30:.3f} GiB ({held / 2**30:.3f} "
          f"GiB held before them, the two models and their Adam states among it)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(token(9))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"    one token step under torch.profiler ({wall * 1e3:.2f} ms wall) on {card}:")
    device_time_by_kernel(prof, wall, top=10)
    busy = device_busy_union_ms(prof)
    print(f"      the union of the device intervals (Adam's annotated range over its kernels "
          f"counted once): busy {busy:.2f} ms, idle share {1 - busy / (wall * 1e3):.3f}")
    del pre, tok, pre_opt, tok_opt
    return ms, peak


def ast_train_phase(torch, counters, card):
    """Phase 8c: AST training at full width on the card through the CLI
    (pretraining, the frozen transplant, token training with scheduled
    sampling, pitch weights and note-F1 selection), evaluate_ast on its
    model_best, a step on the card against the CPU and the steps' times,
    through no hand-written kernel."""
    from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, config_from_dict
    from music_transcription_tpu_torch.data.maestro import MaestroDataset
    from music_transcription_tpu_torch.data.pipeline import collate_tokens, collate_wave_roll
    from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.models.transformer import encoder_state_dict
    from music_transcription_tpu_torch.transcribe import load_model

    root = os.path.join(WORK, "maestro_ast")
    pre_dir, tok_dir = os.path.join(WORK, "ast_pretrain"), os.path.join(WORK, "ast_tokens")
    for d in (root, pre_dir, tok_dir):
        shutil.rmtree(d, ignore_errors=True)
    # 2 train pieces of 120 s (24 chunks of 10 s: 6 steps of 4) and 1 validation piece of 60 s
    write_maestro_tree(root, SEED + 30, [("train", 120.0), ("train", 120.0),
                                         ("validation", 60.0)])

    def launches():
        return {c.__name__: c.launches for c in counters}

    for c in counters:
        c.launches = 0
    t_phase = t0 = time.perf_counter()
    run_train_ast(["--root_dir", root, "--pretrain_frames", "--epochs", "2", "--val_split",
                   "validation", "--device_data", "on", "--compact_data", "--run_dir", pre_dir])
    t1 = time.perf_counter()
    out = run_train_ast(["--root_dir", root, "--epochs", "2", "--encoder_init",
                         os.path.join(pre_dir, "model_best.pth"), "--freeze_encoder",
                         "--scheduled_sampling", "0.5", "--ss_ramp_epochs", "2",
                         "--pitch_loss_weight", "3", "--val_split", "validation",
                         "--val_note_f1_every", "1", "--val_note_f1_batches", "1",
                         "--best_metric", "note_f1", "--save_best_every", "1",
                         "--device_data", "off", "--run_dir", tok_dir])
    t2 = time.perf_counter()
    logs = {}
    for name, d in (("pretraining", pre_dir), ("token model", tok_dir)):
        with open(os.path.join(d, "training_log.txt")) as f:
            logs[name] = f.read().splitlines()
        values = log_values(os.path.join(d, "training_log.txt"))
        if len(logs[name]) != 2 or not values or not all(np.isfinite(values)):
            raise AssertionError(f"AST {name}: log {logs[name]}")
    print(f"[8c] AST training at full width through the CLI on {card}: pretraining "
          f"(--device_data on --compact_data, 2 epochs of 6 steps) wall {t1 - t0:.1f} s; "
          f"the token model (--freeze_encoder, scheduled sampling, pitch weight 3, note-F1 "
          f"selection, --device_data off) wall {t2 - t1:.1f} s")
    for name, lines in logs.items():
        for line in lines:
            print(f"    {name}: {line}")
    if "Initialized encoder from" not in out or "Best val_note_f1" not in out:
        raise AssertionError(f"AST token run: {out[-2000:]}")

    pre = torch.load(os.path.join(pre_dir, "model_best.pth"))
    final = torch.load(os.path.join(tok_dir, "model_final.pth"))
    with open(os.path.join(tok_dir, "model_final.json")) as f:
        mcfg = config_from_dict(ModelConfig, json.load(f)["model"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the CLI's --seed: the token model's initial weights
        init = TranscriptionModel(mcfg).model.state_dict()
    enc = encoder_state_dict(final)
    dec = [k for k in final if k not in enc and not k.endswith("k.bias")]
    moved = sum(not torch.equal(final[k], init[k]) for k in dec)
    if not (enc and all(torch.equal(v, pre[k]) for k, v in enc.items()) and moved == len(dec)):
        raise AssertionError(f"AST frozen transplant: {moved} of {len(dec)} decoder tensors moved")
    print(f"    model_final: {len(enc)} encoder tensors bit-identical to the pretrained "
          f"model_best; {moved} of {len(dec)} other tensors moved from the seeded init (the "
          f"attention key biases, whose exact gradient is 0, left out)")
    best = os.path.join(tok_dir, "model_best.pth")
    loaded = load_model(best, device="cuda")
    if not loaded.model.config.is_ast or next(loaded.model.parameters()).device.type != "cuda":
        raise AssertionError("model_best did not load as an AST model on the card")
    t0 = time.perf_counter()
    scores = run_evaluate(["--model", best, "--root_dir", root, "--split", "validation",
                           "--subset", "4", "--max_len", "256", "--headless", "-d", "cuda"],
                          cli="evaluate_ast")
    print(f"    model_best through transcribe.load_model; evaluate_ast on the card, 4 chunks, "
          f"256 tokens: {scores}, wall {time.perf_counter() - t0:.1f} s")
    if set(scores) != {"EVAL_AST_NOTE_F1"} or not 0.0 <= scores["EVAL_AST_NOTE_F1"] <= 1.0:
        raise AssertionError("evaluate_ast printed no EVAL_AST_NOTE_F1 line")

    acfg = AudioConfig(chunk_length=10.0)
    ds = MaestroDataset(root, split="train", chunk_length=10.0, return_waveform=True,
                        audio_cfg=acfg)
    items = [ds[i] for i in range(4)]
    tk = REMITokenizer()
    wave, tokens = collate_tokens([(w, tk.encode_from_pianoroll(r, max_len=256))
                                   for w, r in items], pad_to=acfg.chunk_samples)
    _, roll, lengths = collate_wave_roll(items, pad_to=acfg.chunk_samples,
                                         roll_pad_to=acfg.roll_frames_per_chunk)
    ast_step_card_vs_cpu(torch, torch.from_numpy(wave[:2]))
    time_ast_steps(torch, *(torch.from_numpy(a) for a in (wave, roll, lengths, tokens)), card)
    if any(launches().values()):
        raise AssertionError(f"AST training launched a hand-written kernel: {launches()}")
    print(f"    hand-written kernel launches in the phase: {launches()}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")


# Phase 9: data-parallel training. The ranks are processes of their own,
# started by torchrun with a private argument (RANK_MODES): each runs its
# part in-process, so that it reads its own kernel counters, and writes its
# result to <spec>_rank<r>.json beside its spec for the parent to read.
RANK_MODES = ("--rank-cli", "--rank-steps", "--rank-eval")
DP_WORLD = 2
DP_T = 188  # frames of the card-vs-one-process steps (6 s): their fp32 memory stays small


def counters_of(lk, ak) -> dict:
    return {"lstm_recurrence": lk.lstm_recurrence, "lstm_recurrence_fwd": lk.lstm_recurrence_fwd,
            "lstm_recurrence_bwd": lk.lstm_recurrence_bwd,
            "flash_attention_clamped": ak.flash_attention_clamped,
            "flash_attention_clamped_fwd": ak.flash_attention_clamped_fwd,
            "flash_attention_clamped_dq": ak.flash_attention_clamped_dq,
            "flash_attention_clamped_dkv": ak.flash_attention_clamped_dkv}


def reset_counts(counters: dict) -> None:
    for c in counters.values():
        c.launches = 0


def read_counts(counters: dict) -> dict:
    return {name: c.launches for name, c in counters.items()}


def torchrun(mode: str, spec: dict, name: str, timeout: float = 300) -> list[dict]:
    """``torchrun --standalone --nproc_per_node DP_WORLD chip_smoke.py mode``
    on ``spec``: each rank's result, by rank. The whole output goes to
    WORK/<name>.log; a failure raises with its end. The launch is a process
    group of its own, killed whole if it outlives ``timeout``."""
    import signal

    spec_path = os.path.join(WORK, f"{name}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    for rank in range(DP_WORLD):  # each rank writes its result here
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(WORK, f"{name}_rank{rank}.json"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(DP_WORLD), os.path.abspath(__file__), mode, spec_path]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    with open(os.path.join(WORK, f"{name}.log"), "w") as f:
        f.write(out)
    results = []
    for rank in range(DP_WORLD):
        path = os.path.join(WORK, f"{name}_rank{rank}.json")
        if os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
    if proc.returncode != 0 or len(results) != DP_WORLD:
        raise AssertionError(f"torchrun {mode} exited {proc.returncode} with {len(results)} "
                             f"rank results:\n{out[-6000:]}")
    return results


def rank_cli(torch, spec: dict, rank: int) -> dict:
    """9a in a rank: the training CLI's main in this process, its train
    steps recorded, the kernel counters read here."""
    from music_transcription_tpu_torch.ops import attention_kernel as ak
    from music_transcription_tpu_torch.ops import lstm_kernel as lk
    from music_transcription_tpu_torch.train import __main__ as train_cli

    counters = counters_of(lk, ak)
    with recorded_steps() as steps:
        reset_counts(counters)
        t0 = time.perf_counter()
        rc = train_cli.main(spec["argv"][str(rank)])
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
    return dict(rank=rank, rc=rc, wall_s=wall, launches=launches,
                losses=[m["loss"] for m in steps], skipped=[m["skipped"] for m in steps],
                ms=[m["ms"] for m in steps])


def _fresh_state(torch, cfg, weights, device):
    from music_transcription_tpu_torch.config import TrainConfig
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.parallel.train_step import TrainState
    from music_transcription_tpu_torch.train.optim import make_optimizer

    model = TranscriptionModel(cfg)
    model.model.load_state_dict(torch.load(weights), strict=True)
    model.to(device)
    return TrainState(model, make_optimizer(model.parameters(), TrainConfig()))


def rank_steps(torch, spec: dict, rank: int) -> dict:
    """9b-9d in a rank, at world 2 on the card: fp32 steps at dropout 0 from
    ``spec``'s weights on its global batch (this rank's rows) under dp (2
    steps, attention "xla"), zero1 (2 steps) and dp with attention "pallas"
    (1 step); rank 0 writes the states after the first step and the
    checkpoints after the last. Then warm bf16 steps of the default model at
    T=938 (12 rows a rank), timed, the gradient all-reduce timed apart, and
    one step profiled in rank 0."""
    from torch.profiler import ProfilerActivity, profile

    from music_transcription_tpu_torch import checkpoints as ckpt_lib
    from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
    from music_transcription_tpu_torch.models.cnn_rnn import CNNRNNLarge
    from music_transcription_tpu_torch.ops import attention_kernel as ak
    from music_transcription_tpu_torch.ops import lstm_kernel as lk
    from music_transcription_tpu_torch.parallel import partitioning as part
    from music_transcription_tpu_torch.parallel import train_step as ts
    from music_transcription_tpu_torch.parallel.distributed import (
        backend,
        maybe_initialize_distributed,
        rank_device,
        shutdown,
    )
    from music_transcription_tpu_torch.parallel.mesh import make_mesh, shard_batch

    maybe_initialize_distributed("cuda")
    device = rank_device("cuda")
    mesh = make_mesh(DP_WORLD, "cuda")
    counters = counters_of(lk, ak)
    out = dict(rank=rank, rc=0, backend=backend(), device=str(device), runs={})
    batch = tuple(a.to(device) for a in shard_batch(torch.load(spec["batch"]), mesh))
    saved_rates = CNNRNNLarge.CHANNEL_DROPOUT
    CNNRNNLarge.CHANNEL_DROPOUT = (0.0, 0.0, 0.0)
    try:
        for name, attention, how, steps in (("dp", "xla", "dp", 2), ("zero1", "xla", "zero1", 2),
                                            ("pallas", "pallas", "dp", 1)):
            cfg = ModelConfig(compute_dtype="float32", dropout=0.0, lstm_backend="pallas",
                              attention_backend=attention)
            state = ts.data_parallel(_fresh_state(torch, cfg, spec["weights"], device), mesh)
            if how != "dp":
                state = part.shard_state(state, mesh, strategy=how)
            reset_counts(counters)
            metrics = []
            for i in range(steps):
                metrics.append(ts.train_step(state, batch, 1, max_grad_norm=1.0))
                if i == 0:
                    first = part.full_model_state_dict(state)
                    if rank == 0:
                        torch.save({k: v.cpu() for k, v in first.items()},
                                   os.path.join(spec["out"], f"{name}_step1.pt"))
            launches = read_counts(counters)
            if how == "zero1":  # the Adam moments this rank holds, by parameter index
                index = {id(p): i for i, p in enumerate(state.model.parameters())}
                torch.save({index[id(p)]: {k: v.detach().cpu() for k, v in s.items()}
                            for p, s in state.optimizer.optim.state.items()},
                           os.path.join(spec["out"], f"zero1_shard_rank{rank}.pt"))
            model_sd = part.full_model_state_dict(state)
            optim_sd = part.full_optimizer_state_dict(state)
            if rank == 0:
                ckpt_lib.save_training_checkpoint(os.path.join(spec["out"], f"{name}.pt"),
                                                  model_sd, optim_sd, state.step, 1, {})
            out["runs"][name] = dict(metrics=metrics, launches=launches,
                                     bytes=part.sharded_param_bytes(state))
            del state, model_sd, optim_sd, first
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        CNNRNNLarge.CHANNEL_DROPOUT = saved_rates

    # warm bf16 steps of the default model, 12 rows a rank at T=938
    big = tuple(a.to(device) for a in shard_batch(torch.load(spec["time_batch"]), mesh))
    state = ts.data_parallel(ts.init_train_state(ModelConfig(lstm_backend="pallas"), TrainConfig(),
                                                 device), mesh)
    reduce_ms, real_sum = [], ts._sum_gradients

    def timed_sum(params, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_sum(params, group)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    ts._sum_gradients = timed_sum
    try:
        ts.train_step(state, big, SEED + 1, max_grad_norm=1.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, reduce_ms[:] = [], []
        for _ in range(4):
            t0 = time.perf_counter()
            ts.train_step(state, big, SEED + 1, max_grad_norm=1.0)
            times.append((time.perf_counter() - t0) * 1e3)
        out.update(step_ms=times, reduce_ms=list(reduce_ms),
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
        if rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ts.train_step(state, big, SEED + 1, max_grad_norm=1.0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(f"    [rank 0] one world-{DP_WORLD} train step under torch.profiler "
                  f"({wall * 1e3:.1f} ms):")
            device_time_by_kernel(prof, wall, top=10)
            comm = sorted(((e.key, e.cpu_time_total / 1e3) for e in prof.key_averages()
                           if "allreduce" in e.key.replace("_", "").lower()
                           or "all_reduce" in e.key), key=lambda kv: -kv[1])
            print("    [rank 0] collective ops (host ms): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in comm[:4]))
        else:
            ts.train_step(state, big, SEED + 1, max_grad_norm=1.0)
    finally:
        ts._sum_gradients = real_sum
    del state, big
    shutdown()
    return out


def rank_eval(torch, spec: dict, rank: int) -> dict:
    """10b in a rank: the evaluation CLI's main in this process, its output
    kept, the kernel counters read here."""
    from music_transcription_tpu_torch import evaluate
    from music_transcription_tpu_torch.ops import attention_kernel as ak
    from music_transcription_tpu_torch.ops import lstm_kernel as lk

    counters = counters_of(lk, ak)
    reset_counts(counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = evaluate.main(spec["argv"])
    wall = time.perf_counter() - t0
    return dict(rank=rank, rc=rc, wall_s=wall, launches=read_counts(counters),
                stdout=out.getvalue()[-20000:])


def rank_main(argv) -> int:
    """A rank of phase 9 or 10 (started by torchrun): ``argv`` = mode, spec
    path."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    mode, spec_path = argv
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    run = {"--rank-cli": rank_cli, "--rank-steps": rank_steps, "--rank-eval": rank_eval}[mode]
    result = run(torch, spec, rank)
    with open(spec_path.removesuffix(".json") + f"_rank{rank}.json", "w") as f:
        json.dump(result, f)
    return result["rc"]


def _state_errors(torch, got: dict, ref: dict, lr: float) -> dict:
    """The CPU tests' bounds, read off: the largest parameter difference in
    units of lr, the share of parameter elements more than 1e-2 lr apart,
    and the largest running-statistics difference over its tensor's largest
    magnitude."""
    worst = stats = 0.0
    loose = total = 0
    for key, want in ref.items():
        if key.endswith("num_batches_tracked") or "bias_hh" in key:
            continue
        diff = (got[key].float().cpu() - want.float().cpu()).abs()
        if "running" in key:
            stats = max(stats, float(diff.max()) / float(want.abs().max()))
            continue
        worst = max(worst, float(diff.max()) / lr)
        loose += int((diff > 1e-2 * lr).sum())
        total += diff.numel()
    return dict(max_lr=worst, loose_share=loose / total, stats_rel=stats)


def _within(errs: dict) -> bool:
    return errs["max_lr"] <= 2.0 and errs["loose_share"] <= 5e-3 and errs["stats_rel"] <= 1e-4


def _fmt(errs: dict) -> str:
    return (f"params max {errs['max_lr']:.3f} lr (tol 2), share beyond 1e-2 lr "
            f"{errs['loose_share']:.2e} (tol 5e-3), running stats {errs['stats_rel']:.2e} "
            f"(tol 1e-4)")


def check_rank_kernels(torch, lk, ak, rows):
    """9c: K2a and K2b at a rank's 2B = 24 (12 rows), T=938, H=512 and 256,
    and K3 with lse, K4a and K4b at its B x heads = 96, bf16 and fp32,
    against their plain versions with phase 5's tolerances, each launched
    REPEATS times with bit-identical outputs."""
    from music_transcription_tpu_torch.ops.precision import full_fp32

    rng = np.random.default_rng(SEED + 9)
    for two_b, t, hidden in ((24, 938, 512), (24, 938, 256)):
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
        fwd_err = max(float((h - ref_h).abs().max()), float((c - ref_c).abs().max()))
        dxw_err, dwh_err = float((dxw - ref_dxw).abs().max()), float((dwh - ref_dwh).abs().max())
        dxw_tol, dwh_tol = 1e-4 * float(ref_dxw.abs().max()), 1e-4 * float(ref_dwh.abs().max())
        same_fwd = repeats_identical(torch, lambda: lk.lstm_recurrence_fwd(xw, wh), (h, c))
        same_bwd = repeats_identical(
            torch, lambda: lk.lstm_recurrence_bwd(xw, wh, ref_h, ref_c, dh), dxw)
        fwd_ms = cuda_ms(lambda: lk.lstm_recurrence_fwd(xw, wh), reps=5)
        bwd_ms = cuda_ms(lambda: lk.lstm_recurrence_bwd(xw, wh, h, c, dh), reps=5)
        ok = (fwd_err <= 1e-4 and dxw_err <= dxw_tol and dwh_err <= dwh_tol and same_fwd
              and same_bwd and bool(torch.isfinite(h).all() and torch.isfinite(dxw).all()))
        rows.append(f"K2a/K2b 2B={two_b} T={t} H={hidden}: h/c max_abs_err {fwd_err:.3e} (tol "
                    f"1e-4), dxw {dxw_err:.3e} (tol {dxw_tol:.3e}), dW_hh {dwh_err:.3e} (tol "
                    f"{dwh_tol:.3e}); {REPEATS} launches bit-identical: {same_fwd} / {same_bwd}; "
                    f"ms K2a {fwd_ms:.4f} K2b {bwd_ms:.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(rows[-1])
        del xw, wh, dh, h, c, ref_h, ref_c, dxw, ref_dxw
    b, t, nh, d = 12, 938, 8, 192
    scale, clip = d**-0.5, 10.0
    q32, k32, v32, do32 = (torch.from_numpy(m * rng.standard_normal((b, t, nh, d))
                                            .astype(np.float32)).cuda()
                           for m in (6.0, 1.0, 1.0, 1.0))
    for dtype in ("bfloat16", "float32"):
        q, k, v, do = (x.to(getattr(torch, dtype)) for x in (q32, k32, v32, do32))
        with full_fp32():
            o, lse = ak.flash_attention_clamped_fwd(q, k, v, scale, clip)
            ref_o, ref_lse = ak.attention_clamped_fwd_plain(q, k, v, scale, clip)
            ref_abs_v = ak.attention_clamped_plain(q, k, v.abs(), scale, clip)
            dq = ak.flash_attention_clamped_dq(q, k, v, ref_o, do, ref_lse, scale, clip)
            dk, dv = ak.flash_attention_clamped_dkv(q, k, v, ref_o, do, ref_lse, scale, clip)
            ref = ak.attention_clamped_bwd_plain(q, k, v, ref_o, do, ref_lse, scale, clip)
            torch.cuda.synchronize()
            fwd_score = k3_score(o, ref_o, ref_abs_v, dtype)
            lse_ok = bool(((lse - ref_lse).abs() <= 1e-5 * ref_lse.abs() + 1e-5).all())
            _, mag = attention_grad_terms(torch, q, k, v, ref_o, do, ref_lse, scale, clip)
            score = k4_score((dq, dk, dv), ref, mag, dtype)
            same = (repeats_identical(
                        torch, lambda: ak.flash_attention_clamped_fwd(q, k, v, scale, clip),
                        (o, lse))
                    and repeats_identical(torch, lambda: ak.flash_attention_clamped_dq(
                        q, k, v, ref_o, do, ref_lse, scale, clip), dq)
                    and repeats_identical(torch, lambda: ak.flash_attention_clamped_dkv(
                        q, k, v, ref_o, do, ref_lse, scale, clip), (dk, dv)))
            fwd_ms = cuda_ms(lambda: ak.flash_attention_clamped_fwd(q, k, v, scale, clip), reps=5)
            dq_ms = cuda_ms(lambda: ak.flash_attention_clamped_dq(q, k, v, ref_o, do, ref_lse,
                                                                  scale, clip), reps=5)
            dkv_ms = cuda_ms(lambda: ak.flash_attention_clamped_dkv(q, k, v, ref_o, do, ref_lse,
                                                                    scale, clip), reps=5)
        ok = fwd_score <= 1.0 and lse_ok and score <= 1.0 and same
        rows.append(f"K3+lse/K4a/K4b {dtype} B x heads={b * nh} T={t} D={d}: o worst "
                    f"|err|/K3_TOL {fwd_score:.3f}, lse within 1e-5: {lse_ok}; dq/dk/dv worst "
                    f"|err|/K4_TOL {score:.3f}; {REPEATS} launches bit-identical: {same}; ms "
                    f"K3+lse {fwd_ms:.4f} K4a {dq_ms:.4f} K4b {dkv_ms:.4f} "
                    f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(rows[-1])
        del q, k, v, do, o, lse, ref_o, ref_lse, ref_abs_v, dq, dk, dv, ref, mag


def dp_phase(torch, lk, ak, wav30, card, phase6_ms):
    """Phase 9: data-parallel training at world 2 on the one card."""
    import torch.distributed as dist

    from music_transcription_tpu_torch import checkpoints as ckpt_lib
    from music_transcription_tpu_torch.config import AudioConfig, ModelConfig
    from music_transcription_tpu_torch.data.cache import HybridMaestroDataset
    from music_transcription_tpu_torch.data.midi import load_midi
    from music_transcription_tpu_torch.data.pipeline import collate_mel
    from music_transcription_tpu_torch.models.cnn_rnn import CNNRNNLarge
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.parallel import partitioning as part
    from music_transcription_tpu_torch.parallel import train_step as ts
    from music_transcription_tpu_torch.parallel.mesh import make_mesh
    from music_transcription_tpu_torch.transcribe import transcribe_audio

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    acfg = AudioConfig()
    cache_dir = os.path.join(WORK, "train_cache")  # phase 6's
    run_dir, rank1_dir = os.path.join(WORK, "dp_run"), os.path.join(WORK, "dp_run_rank1")
    for d in (run_dir, rank1_dir):
        shutil.rmtree(d, ignore_errors=True)

    # 9a: dp through the CLI at world 2; rank 1 is given a run directory of
    # its own, where it must write nothing
    def argv(run, *extra):
        return ["--cache_dir", cache_dir, "--root_dir", os.path.join(WORK, "no_raw_audio"),
                "--run_dir", run, "--save_every", "1", "--num_workers", "4",
                "--seed", str(SEED), *extra]

    results = torchrun("--rank-cli", {"argv": {"0": argv(run_dir, "--epochs", "2"),
                                                "1": argv(rank1_dir, "--epochs", "2")}},
                       "dp_cli", timeout=400)
    with open(os.path.join(WORK, "dp_cli.log")) as f:
        backend_line = next((ln.strip() for ln in f if ln.startswith("distributed: rank 0")), "")
    print(f"[9] data-parallel training at world {DP_WORLD} on {card}: {backend_line}")
    for r in results:
        print(f"    9a rank {r['rank']}: CLI rc {r['rc']}, wall {r['wall_s']:.1f} s, step losses "
              f"{[round(v, 5) for v in r['losses']]}, skipped {sum(r['skipped'])}, step ms "
              f"{[round(v, 1) for v in r['ms']]}, launches {r['launches']}")
    with open(os.path.join(run_dir, "training_log.txt")) as f:
        log = [line.split() for line in f if line.strip()]
    epoch_losses = [float(r[k].split("=")[1]) for r in log for k in (2, 3)]
    with open(os.path.join(run_dir, "parameters.json")) as f:
        devices = json.load(f)["devices"]
    n_steps, n_val = 4, 2  # 2 epochs of 2 steps; 1 validation batch of 12 rows an epoch
    for r in results:
        if (r["rc"] != 0 or len(r["losses"]) != n_steps or any(r["skipped"])
                or not all(np.isfinite(v) for v in r["losses"] + epoch_losses)):
            raise AssertionError(f"9a: rank {r['rank']}'s training failed: {r}")
        if (r["launches"]["lstm_recurrence_fwd"] != 4 * n_steps
                or r["launches"]["lstm_recurrence_bwd"] != 4 * n_steps
                or r["launches"]["lstm_recurrence"] != 4 * n_val):
            raise AssertionError(f"9a: rank {r['rank']} missed a kernel: {r['launches']}")
    if results[0]["losses"] != results[1]["losses"]:
        raise AssertionError("9a: the ranks saw different losses")
    if os.path.exists(rank1_dir) or len(devices) != DP_WORLD:
        raise AssertionError(f"9a: rank 1 wrote {rank1_dir}, or the manifest lists {devices}")
    print(f"    epoch train/val losses {epoch_losses}; manifest devices {devices}; rank 1 wrote "
          f"nothing")
    best = os.path.join(run_dir, "checkpoints", "model_best.pth")
    mid = os.path.join(WORK, "request_dp.mid")
    k1 = lk.lstm_recurrence.launches
    transcribe_audio(wav30, best, mid, verbose=False, device="cuda")
    n_notes = len(load_midi(mid).instruments[0].notes)
    print(f"    the world-2 model_best.pth served the 118 s WAV here: {n_notes} notes, K1 "
          f"launches {lk.lstm_recurrence.launches - k1}")
    if lk.lstm_recurrence.launches - k1 != 4:
        raise AssertionError("9a: model_best did not serve through K1")
    results = torchrun("--rank-cli", {"argv": {str(r): argv(run_dir, "--epochs", "3", "--resume",
                                                           "auto") for r in range(DP_WORLD)}},
                       "dp_resume", timeout=300)
    with open(os.path.join(run_dir, "training_log.txt")) as f:
        epochs = [int(line.split()[1]) for line in f if line.strip()]
    final_step = torch.load(os.path.join(run_dir, "checkpoints", "model_final.pt"))["step"]
    print(f"    --resume auto at world 2: rc {[r['rc'] for r in results]}, epochs logged {epochs}, "
          f"final step {final_step}, losses {[round(v, 5) for v in results[0]['losses']]}")
    if any(r["rc"] for r in results) or epochs != [1, 2, 3] or final_step != 6 \
            or results[0]["losses"] != results[1]["losses"]:
        raise AssertionError("9a: --resume auto at world 2 did not continue from model_epoch_2")

    # 9b-9d in the ranks: fp32 steps at dropout 0 from seeded weights on a
    # global batch of 24 at T=DP_T, rank 1's rows shorter (the weighting)
    out_dir = os.path.join(WORK, "dp_steps")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    train_set = HybridMaestroDataset(cache_dir, cache_dir, "train", chunk_length=30.0,
                                     verbose=False)
    mel, roll, lengths = (torch.from_numpy(a) for a in
                          collate_mel([train_set[i] for i in range(24)],
                                      pad_to=acfg.mel_frames_per_chunk))
    torch.save((mel, roll, lengths), os.path.join(out_dir, "time_batch.pt"))
    short = torch.tensor([DP_T] * 12 + list(range(DP_T - 11 * 8, DP_T + 1, 8)), dtype=torch.int32)
    batch = (mel[..., :DP_T].clone(), roll[..., :DP_T].clone(), short)
    torch.save(batch, os.path.join(out_dir, "batch.pt"))
    fp32 = dict(compute_dtype="float32", dropout=0.0, lstm_backend="pallas")
    torch.manual_seed(SEED + 9)
    weights = os.path.join(out_dir, "weights.pth")
    torch.save(TranscriptionModel(ModelConfig(**fp32)).model.state_dict(), weights)
    results = torchrun("--rank-steps",
                       {"weights": weights, "batch": os.path.join(out_dir, "batch.pt"),
                        "time_batch": os.path.join(out_dir, "time_batch.pt"), "out": out_dir},
                       "dp_steps", timeout=400)
    with open(os.path.join(WORK, "dp_steps.log")) as f:
        for line in f:
            if line.startswith("    [rank 0]") or line.startswith("      "):
                print(line.rstrip())
    r0 = results[0]
    for r in results:
        print(f"    rank {r['rank']} on {r['device']} ({r['backend']}): "
              + "; ".join(f"{n} losses {[round(m['loss'], 6) for m in v['metrics']]} launches "
                          f"{ {k: c for k, c in v['launches'].items() if c} } bytes {v['bytes']}"
                          for n, v in r["runs"].items()))
        if any(m["skipped"] or not np.isfinite(m["loss"]) for v in r["runs"].values()
               for m in v["metrics"]):
            raise AssertionError(f"9b: rank {r['rank']} skipped a step")
    if [m["loss"] for v in results[0]["runs"].values() for m in v["metrics"]] != \
            [m["loss"] for v in results[1]["runs"].values() for m in v["metrics"]]:
        raise AssertionError("9b: the ranks saw different losses")
    for name, fwd, extra in (("dp", 8, {}), ("zero1", 8, {}),
                             ("pallas", 4, {"flash_attention_clamped_fwd": 1,
                                            "flash_attention_clamped_dq": 1,
                                            "flash_attention_clamped_dkv": 1})):
        got = r0["runs"][name]["launches"]
        if got["lstm_recurrence_fwd"] != fwd or got["lstm_recurrence_bwd"] != fwd or any(
                got[k] != v for k, v in extra.items()):
            raise AssertionError(f"9b: {name} steps missed a kernel: {got}")

    # 9b here: the same first step in this one process, the whole batch
    rows, one = [], {}
    CNNRNNLarge.CHANNEL_DROPOUT, saved_rates = (0.0, 0.0, 0.0), CNNRNNLarge.CHANNEL_DROPOUT
    try:
        full = tuple(a.cuda() for a in batch)
        for name, attention in (("dp", "xla"), ("pallas", "pallas")):
            cfg = ModelConfig(**fp32, attention_backend=attention)
            state = _fresh_state(torch, cfg, weights, "cuda")
            m = ts.train_step(state, full, 1, max_grad_norm=1.0)
            one[name] = (m, {k: v.cpu() for k, v in state.model.model.state_dict().items()})
            got = r0["runs"][name]["metrics"][0]
            loss_err = abs(got["loss"] - m["loss"]) / abs(m["loss"])
            errs = _state_errors(torch, torch.load(os.path.join(out_dir, f"{name}_step1.pt")),
                                 one[name][1], 1e-4)
            ok = loss_err <= 1e-4 and _within(errs)
            rows.append(f"9b world-2 fp32 step (attention {attention!r}, 2 x 12 rows, T={DP_T}) vs "
                        f"one process: loss rel err {loss_err:.3e} (tol 1e-4), {_fmt(errs)} "
                        f"{'ok' if ok else 'FAIL'}")
            print("    " + rows[-1])
            if not ok:
                raise AssertionError(rows[-1])
            del state

        # 9d: zero1 against dp after 2 steps; its consolidated checkpoint
        # resumes in this one-device process holding the moments the ranks'
        # shards held, bit for bit
        dp_ck = torch.load(os.path.join(out_dir, "dp.pt"), weights_only=False)
        z_path = os.path.join(out_dir, "zero1.pt")
        errs = _state_errors(torch, torch.load(z_path, weights_only=False)["model_state"],
                             dp_ck["model_state"], 1e-4)
        state = _fresh_state(torch, ModelConfig(**fp32), weights, "cuda")
        step = ckpt_lib.load_training_checkpoint(z_path, state.model.model, state.optimizer)
        shards = [torch.load(os.path.join(out_dir, f"zero1_shard_rank{r}.pt"))
                  for r in range(DP_WORLD)]
        params = list(state.model.parameters())
        owned = sorted(i for s in shards for i in s)
        same = owned == list(range(len(params))) and all(
            torch.equal(state.optimizer.state[params[i]][k].cpu(), v)
            for s in shards for i, moments in s.items() for k, v in moments.items())
        dp_adam = dp_ck["optimizer_state"]["state"]
        vs_dp = max(float((state.optimizer.state[p][k].cpu() - dp_adam[i][k].cpu()).abs().max())
                    / float(dp_adam[i][k].abs().max())
                    for i, p in enumerate(params) for k in ("exp_avg", "exp_avg_sq"))
        ok = _within(errs) and step == 2 and same
        rows.append(f"9d zero1 at world 2 (2 steps; per rank {r0['runs']['zero1']['bytes']}, "
                    f"dp's {r0['runs']['dp']['bytes']}) vs dp: {_fmt(errs)}; its checkpoint "
                    f"resumed here at step {step} with every rank's moments bit for bit "
                    f"({[len(s) for s in shards]} parameters a rank): {same}; the moments against "
                    f"the separate dp run's, max over tensors of |diff| / max: {vs_dp:.2e} "
                    f"{'ok' if ok else 'FAIL'}")
        print("    " + rows[-1])
        if not ok:
            raise AssertionError(rows[-1])
        del state

        # 9e: fsdp at world 1 over NCCL, through parallel/partitioning
        store = os.path.join(out_dir, "fsdp_store")
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
        try:
            mesh = make_mesh(1, "cuda")
            state = part.shard_state(ts.data_parallel(
                _fresh_state(torch, ModelConfig(**fp32), weights, "cuda"), mesh), mesh,
                strategy="fsdp")
            m = ts.train_step(state, full, 1, max_grad_norm=1.0)
            sizes = part.sharded_param_bytes(state)
            sd = part.full_model_state_dict(state)
            ref_m, ref_sd = one["dp"]
            errs = _state_errors(torch, sd, ref_sd, 1e-4)
            loss_err = abs(m["loss"] - ref_m["loss"]) / abs(ref_m["loss"])
            plain = TranscriptionModel(ModelConfig(**fp32))
            plain.model.load_state_dict(sd, strict=True)
            same = all(torch.equal(v, sd[k].cpu()) for k, v in plain.model.state_dict().items())
            ok = loss_err <= 1e-4 and _within(errs) and same
            rows.append(f"9e fsdp at world 1 over {dist.get_backend()} (sharded_param_bytes "
                        f"{sizes}) vs the plain step: loss rel err {loss_err:.3e} (tol 1e-4), "
                        f"{_fmt(errs)}; its full state loads into a one-device model: {same} "
                        f"{'ok' if ok else 'FAIL'}")
            print("    " + rows[-1])
            if not ok:
                raise AssertionError(rows[-1])
            del state, sd
        finally:
            dist.destroy_process_group()
    finally:
        CNNRNNLarge.CHANNEL_DROPOUT = saved_rates

    # 9c: the kernels at a rank's shapes
    check_rank_kernels(torch, lk, ak, rows)
    for r in rows[-4:]:
        print("    9c " + r)

    # timing: warm world-2 bf16 steps (both ranks on the one card)
    for r in results:
        print(f"    warm world-{DP_WORLD} train step, rank {r['rank']} (12 rows, T=938, bf16, "
              f"attention 'xla'): {[round(v, 1) for v in r['step_ms']]} ms (median "
              f"{float(np.median(r['step_ms'])):.1f}); gradient all-reduce "
              f"{[round(v, 1) for v in r['reduce_ms']]} ms (median share "
              f"{float(np.median(np.array(r['reduce_ms']) / np.array(r['step_ms']))):.3f}); "
              f"peak {r['peak_gib']:.2f} GiB")
    ms = float(np.median(results[0]["step_ms"]))
    print(f"    beside phase 6's one-process step of 24 rows: {phase6_ms:.1f} ms; ratio "
          f"{ms / phase6_ms:.3f}; {card}; phase wall {time.perf_counter() - t_phase:.1f} s")


# Phase 10: the rest of parallelism. Serving across replicas is held against
# one device on the same card in the same dtype, only the batch split
# changed: logits within SPLIT_TOL of the largest (on an H100 the split moved
# them by 3e-3 of it at most in bf16). Since sigmoid' <= 1/4, a probability
# then moves at most SPLIT_TOL / 4 of the largest logit, and a roll may
# differ only at a frame whose probability lies that close to the threshold.
# A replica fed the wrong block (shifted by one chunk) must fail the bound.
SPLIT_TOL = 1e-2
EVAL_F1_TOL, EVAL_THRESHOLD_TOL = 1e-6, 1e-9  # tests/test_multihost.py's


def replicas_phase(torch, lk, ak, pth, wav30, wav120, card, phase3_ms):
    """10a: serving through two replicas on the one card against one device."""
    from music_transcription_tpu_torch.data.audio import load_audio
    from music_transcription_tpu_torch.transcribe import (
        Transcriber,
        replica_forward,
        transcribe_chunks,
    )

    def forward(model, mel):
        return model(mel).float()

    t_phase = time.perf_counter()
    # 8 windows of 120 s: 4 a replica, which "auto" sends through K3
    wav950 = os.path.join(WORK, "long8.wav")
    write_wav(wav950, 950.0, SEED + 10)
    counters = (lk.lstm_recurrence, ak.flash_attention_clamped)
    print(f"[10] the rest of parallelism on {card}")
    for name, wav, window in (("30 s route, 118 s", wav30, None),
                              ("-w 120, 470 s", wav120, 120.0),
                              ("-w 120, 950 s", wav950, 120.0)):
        one = Transcriber(pth, window=window, device="cuda")
        two = Transcriber(pth, window=window, devices=["cuda:0", "cuda:0"])
        acfg = one.loaded.audio_cfg
        y, _ = load_audio(wav, sr=acfg.sample_rate)
        chunks = one.split(y)
        n, k = chunks.shape[0], -(-chunks.shape[0] // 2)
        attention = two.replicas[0].model.attention
        want_k3 = 2 if attention.route(k, acfg.mel_frames_per_chunk) == "pallas" else 0
        for c in counters:
            c.launches = 0
        notes = two.transcribe_array(y)  # the main path: the entry point, counted
        launches = [c.launches for c in counters]
        roll_one = transcribe_chunks(one.loaded, chunks)
        roll_two = transcribe_chunks(two.loaded, chunks, replicas=two.replicas)
        logits = [replica_forward(r, chunks, acfg, forward)
                  for r in ([one.loaded.model], two.replicas)]
        scale = float(np.abs(logits[0]).max())
        err = float(np.abs(logits[1] - logits[0]).max())
        # the fault: the second replica's block starts one chunk early
        shifted = np.concatenate([chunks[:k], chunks[k - 1:n - 1]])
        fault = float(np.abs(replica_forward(two.replicas, shifted, acfg, forward)
                             - logits[0]).max())
        probs = [1.0 / (1.0 + np.exp(-x.astype(np.float64))) for x in logits]
        tol_p = SPLIT_TOL * scale / 4
        near = np.concatenate(list(np.abs(probs[0] - 0.5) <= tol_p), axis=1)
        differ = roll_one != roll_two
        ms_one, ms_two = warm_request_ms(torch, one, y), warm_request_ms(torch, two, y)
        ok = (err <= SPLIT_TOL * scale < fault and not (differ & ~near).any()
              and launches == [4 * 2, want_k3] and roll_one.shape == roll_two.shape)
        print(f"    10a {name} ({n} chunks, {k} a replica, attention "
              f"{attention.route(k, acfg.mel_frames_per_chunk)!r} a replica): two replicas on "
              f"cuda:0 vs one device: logits max_abs_err {err:.3e} (tol {SPLIT_TOL} x "
              f"{scale:.3e}; a block shifted by one chunk: {fault:.3e}), probabilities "
              f"{float(np.abs(probs[1] - probs[0]).max()):.3e} apart at most; "
              f"{int(differ.sum())} of {differ.size} roll frames differ, {int(near.sum())} "
              f"frames lie within {tol_p:.3e} of the threshold; {len(notes)} notes; launches K1 "
              f"{launches[0]} (want 8), K3 {launches[1]} (want {want_k3}); warm request "
              f"{ms_two:.1f} ms against one device's {ms_one:.1f} ms in this phase (phase 3's: "
              f"{phase3_ms:.1f} ms) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"10a: the replicas' {name} request disagrees with one device")
        del one, two
        gc.collect()
        torch.cuda.empty_cache()
    print(f"    10a wall {time.perf_counter() - t_phase:.1f} s")


def eval_ranks_phase(torch, flash_best):
    """10b: the evaluation CLI at world 2 (gloo: the ranks share the card)
    against one process, on phase 6's cache (the validation split, tuned on
    the train split)."""
    from music_transcription_tpu_torch.ops import attention_kernel as ak
    from music_transcription_tpu_torch.ops import lstm_kernel as lk

    cache_dir = os.path.join(WORK, "train_cache")
    argv = ["--model", flash_best, "--cache_dir", cache_dir, "--split", "validation",
            "--headless", "--tune_threshold", "--tune_split", "train", "--batch_size", "8",
            "-d", "cuda"]
    counters = counters_of(lk, ak)
    reset_counts(counters)
    t0 = time.perf_counter()
    ref = run_evaluate(argv)
    wall_one = time.perf_counter() - t0
    one = {k: v for k, v in read_counts(counters).items() if v}
    results = torchrun("--rank-eval", {"argv": argv}, "eval_ranks", timeout=300)
    got = [{ln.split("=")[0]: float(ln.split("=")[1]) for ln in r["stdout"].splitlines()
            if ln.startswith("EVAL_")} for r in results]
    ok = (all(r["rc"] == 0 for r in results) and not got[1] and set(got[0]) == set(ref)
          and abs(got[0]["EVAL_MEAN_F1"] - ref["EVAL_MEAN_F1"]) <= EVAL_F1_TOL
          and abs(got[0]["EVAL_BEST_THRESHOLD"] - ref["EVAL_BEST_THRESHOLD"])
          <= EVAL_THRESHOLD_TOL
          # 24 validation + 48 train chunks, 12 + 24 a rank: 2 + 3 batches of 8, K1 4 each
          and all(r["launches"]["lstm_recurrence"] == 4 * 5 for r in results))
    print(f"    10b evaluate at world 2 (gloo, both ranks on the card): rank 0 {got[0]}, rank 1 "
          f"printed {len(got[1])} EVAL_ lines; one process {ref} (tol {EVAL_F1_TOL:g} on F1, "
          f"{EVAL_THRESHOLD_TOL:g} on the threshold); launches "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in results]} (one process "
          f"{one}); wall {[round(r['wall_s'], 1) for r in results]} s against one process's "
          f"{wall_one:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("10b: evaluation across ranks disagrees with one process")


def tp_world1_phase(torch, lk):
    """10c: one fp32 step with tp's placement at world 1 over NCCL, on a 1-D
    and a (1, 1) mesh, against the plain step (phase 9's weights and batch)."""
    import torch.distributed as dist

    from music_transcription_tpu_torch.config import ModelConfig
    from music_transcription_tpu_torch.models.cnn_rnn import CNNRNNLarge
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.parallel import partitioning as part
    from music_transcription_tpu_torch.parallel import train_step as ts
    from music_transcription_tpu_torch.parallel.mesh import make_mesh

    out_dir = os.path.join(WORK, "dp_steps")
    weights = os.path.join(out_dir, "weights.pth")
    full = tuple(a.cuda() for a in torch.load(os.path.join(out_dir, "batch.pt")))
    cfg = ModelConfig(compute_dtype="float32", dropout=0.0, lstm_backend="pallas")
    CNNRNNLarge.CHANNEL_DROPOUT, saved_rates = (0.0, 0.0, 0.0), CNNRNNLarge.CHANNEL_DROPOUT
    try:
        plain = _fresh_state(torch, cfg, weights, "cuda")
        ref = ts.train_step(plain, full, 1, max_grad_norm=1.0)
        ref_sd = {k: v.cpu() for k, v in plain.model.model.state_dict().items()}
        del plain
        store = os.path.join(out_dir, "tp_store")
        with contextlib.suppress(FileNotFoundError):
            os.remove(store)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
        try:
            for shape in ((1,), (1, 1)):
                mesh = make_mesh(1, "cuda") if len(shape) == 1 else part.make_mesh_2d(1, 1, "cuda")
                state = part.shard_state(ts.data_parallel(
                    _fresh_state(torch, cfg, weights, "cuda"), mesh), mesh, strategy="tp")
                dims = sorted(set(part.tp_shard_dims(state.model.model, 1).values()))
                fwd, bwd = lk.lstm_recurrence_fwd.launches, lk.lstm_recurrence_bwd.launches
                m = ts.train_step(state, full, 1, max_grad_norm=1.0)
                launches = (lk.lstm_recurrence_fwd.launches - fwd,
                            lk.lstm_recurrence_bwd.launches - bwd)
                sd = part.full_model_state_dict(state)
                errs = _state_errors(torch, sd, ref_sd, 1e-4)
                one = TranscriptionModel(cfg)
                one.model.load_state_dict(sd, strict=True)
                loss_err = abs(m["loss"] - ref["loss"]) / abs(ref["loss"])
                ok = loss_err <= 1e-4 and _within(errs) and launches == (4, 4)
                print(f"    10c tp at world 1 over {dist.get_backend()}, mesh {shape} (shard dims "
                      f"{dims}; sharded_param_bytes {part.sharded_param_bytes(state)}) vs the "
                      f"plain step: loss {m['loss']!r} against {ref['loss']!r} (equal to the "
                      f"bit: {m['loss'] == ref['loss']}; tol 1e-4 relative), {_fmt(errs)}; "
                      f"K2a / K2b launches {launches} on the gathered weights; its gathered "
                      f"state loads into a one-device model {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("10c: the tp step differs from the plain step")
                del state, sd, one
        finally:
            dist.destroy_process_group()
    finally:
        CNNRNNLarge.CHANNEL_DROPOUT = saved_rates
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_phase():
    """10d: the multi-rank gate on this machine's torch, 4 gloo ranks on its CPU."""
    import signal

    t0 = time.perf_counter()
    # a process group of its own, killed whole (the ranks too) if it outlives its time
    proc = subprocess.Popen([sys.executable, "-m", "music_transcription_tpu_torch.parallel.dryrun",
                             "4"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    line = (out.strip().splitlines() or [""])[-1]
    print(f"    10d {line} (rc {proc.returncode}, {time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0 or not line.startswith("dryrun(4): ok"):
        raise AssertionError(f"10d: the dryrun failed:\n{out[-3000:]}")


# Phase 11: the remaining surfaces, each through its entry point, at full
# width. Every check that fails raises.
SURFACE_KERNELS = {"K1": "lstm_recurrence", "K2a": "lstm_recurrence_fwd",
                   "K2b": "lstm_recurrence_bwd", "K3": "flash_attention_clamped",
                   "K3+lse": "flash_attention_clamped_fwd", "K4a": "flash_attention_clamped_dq",
                   "K4b": "flash_attention_clamped_dkv"}


def in_process(fn, argv) -> tuple[int, str]:
    """``fn(argv)`` (a CLI's ``main``) in this process: (its code, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def note_spans(path) -> list:
    from music_transcription_tpu_torch.data.midi import load_midi

    return [(n.pitch, n.start, n.end) for n in load_midi(path).instruments[0].notes]


def serve_phase(torch, lk, pth, wav30, server):
    """11a: the resident server, in watch mode in this process over the
    118 s WAV, a seeded 60 s WAV and a non-audio file, then in stdin mode as
    a subprocess: every MIDI's notes equal phase 3's ``Transcriber``'s on
    the same card, K1 4 launches a request."""
    from music_transcription_tpu_torch import serve

    watch, out, out_warm, out_stdin = (os.path.join(WORK, d) for d in (
        "serve_in", "serve_out", "serve_warm", "serve_stdin"))
    for d in (watch, out, out_warm, out_stdin):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(watch)
    shutil.copy(wav30, os.path.join(watch, "request.wav"))
    write_wav(os.path.join(watch, "second.wav"), 60.0, SEED + 17)
    with open(os.path.join(watch, "notes.txt"), "w") as f:
        f.write("not audio")
    wavs = [os.path.join(watch, n) for n in ("request.wav", "second.wav")]
    lk.lstm_recurrence.launches = 0
    t0 = time.perf_counter()
    rc, log = in_process(serve.main, ["--model", pth, "--watch_dir", watch, "--out_dir", out,
                                      "--once"])
    wall = time.perf_counter() - t0
    k1 = lk.lstm_recurrence.launches
    print(f"[11a] serve --watch_dir --once (in process): rc {rc}, wall {wall:.1f} s, K1 "
          f"launches {k1} for {len(wavs)} requests")
    for line in log.splitlines():
        print(f"    | {line}")
    same = []
    for w in wavs:
        stem = os.path.splitext(os.path.basename(w))[0]
        ref = server.transcribe_file(w, os.path.join(WORK, f"serve_ref_{stem}.mid"))
        got, want = note_spans(os.path.join(out, stem + ".mid")), note_spans(ref)
        same.append(got == want)
        print(f"    {stem}: {len(got)} notes, equal to phase 3's Transcriber's ({len(want)}): "
              f"{got == want}")
    if rc != 0 or sorted(os.listdir(out)) != ["request.mid", "second.mid"] or not all(same):
        raise AssertionError("11a: watch mode failed or its notes differ from the Transcriber's")
    if k1 != 4 * len(wavs):
        raise AssertionError(f"11a: K1 should run 4 times a request, ran {k1}")
    # a warm file on the same path (serve.handle: load, transcribe, MIDI write)
    line = io.StringIO()
    with contextlib.redirect_stdout(line):
        serve.handle(server, wavs[0], out_warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.handle(server, wavs[0], out_warm)
        warm = (time.perf_counter() - t0) * 1e3
    print(f"    warm file (118 s WAV, load and MIDI write included): {warm:.1f} ms")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "music_transcription_tpu_torch.serve",
                           "--model", pth, "--stdin", "--out_dir", out_stdin],
                          input=wavs[0] + "\n", capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    got = note_spans(os.path.join(out_stdin, "request.mid"))
    print(f"    serve --stdin (subprocess): rc {proc.returncode}, wall "
          f"{time.perf_counter() - t0:.1f} s (start-up and model load included)")
    for ln in proc.stdout.splitlines():
        print(f"    | {ln}")
    if proc.returncode != 0 or got != note_spans(os.path.join(out, "request.mid")):
        raise AssertionError(f"11a: stdin mode failed or differs:\n{proc.stderr[-3000:]}")


def visualize_phase(torch, pth, wav30):
    """11b: ``transcribe_rolls`` on the card against ``transcribe_chunks`` on
    the same card; the CLI draws a PNG or exits 1 naming matplotlib."""
    from music_transcription_tpu_torch import visualize
    from music_transcription_tpu_torch.data.audio import load_audio, split_into_chunks
    from music_transcription_tpu_torch.transcribe import load_model, transcribe_chunks

    loaded = load_model(pth, device="cuda")
    acfg = loaded.audio_cfg
    mel, rolls = visualize.transcribe_rolls(loaded, wav30)
    y, _ = load_audio(wav30, sr=acfg.sample_rate, mono=True)
    ref = transcribe_chunks(loaded, split_into_chunks(y, acfg.chunk_samples))[:, :mel.shape[1]]
    pred = rolls["predicted piano roll"]
    ok = pred.shape == ref.shape == (88, mel.shape[1]) and np.array_equal(pred, ref)
    print(f"[11b] visualize.transcribe_rolls on the card: mel {mel.shape}, predicted roll "
          f"{pred.shape} ({int(pred.sum())} active frames), equal to transcribe_chunks: {ok}")
    if not ok or not np.isfinite(mel).all():
        raise AssertionError("11b: the plotted roll differs from transcribe_chunks")
    png = os.path.join(WORK, "visualize.png")
    if os.path.exists(png):
        os.remove(png)
    rc, out = in_process(visualize.main, ["transcribe", wav30, pth, "-o", png])
    if rc == 1 and "matplotlib" in out and not os.path.exists(png):
        print(f"    the CLI without matplotlib: rc 1, {out.strip()!r}")
    elif rc == 0 and os.path.getsize(png) > 0:
        print(f"    the CLI drew {png} ({os.path.getsize(png)} bytes)")
    else:
        raise AssertionError(f"11b: the visualize CLI gave rc {rc}: {out[-2000:]}")
    del loaded
    gc.collect()
    torch.cuda.empty_cache()


def bench_phase(torch, lk, ak, card):
    """11c-11f: the four benches through their functions, each path's
    kernel counters set to 0 before it and read after it."""
    from music_transcription_tpu_torch.bench import attention as bench_attention
    from music_transcription_tpu_torch.bench import components as bench_components
    from music_transcription_tpu_torch.bench import loader as bench_loader
    from music_transcription_tpu_torch.bench import train as bench_train

    counters = counters_of(lk, ak)

    def totals():
        return {k: counters[v].launches for k, v in SURFACE_KERNELS.items() if k != "K1"
                and counters[v].launches}

    flash = {"K3+lse": 1.0, "K4a": 1.0, "K4b": 1.0}
    for argv in ([], ["--batch", "4", "--t", "938"]):
        reset_counts(counters)
        t0 = time.perf_counter()
        print(f"[11c] bench.attention {' '.join(argv) or '(defaults: --t 938 2048 4096 --batch 2)'}"
              f" on {card}")
        rows = bench_attention.run(bench_attention.build_parser().parse_args(argv))
        got = totals()
        print(f"    launches in the run {got}; wall {time.perf_counter() - t0:.1f} s")
        for r in rows:
            ok = (r["fwd_launches"] == {} and r["fwdbwd_launches"] == {} if r["backend"] == "xla"
                  else r["fwd_launches"] == {"K3": 1.0} and r["fwdbwd_launches"] == flash)
            if not ok:
                raise AssertionError(f"11c: {r['backend']} at T={r['t']} launched "
                                     f"{r['fwd_launches']} / {r['fwdbwd_launches']}")
        if set(got) != {"K3", "K3+lse", "K4a", "K4b"}:
            raise AssertionError(f"11c: a flash kernel did not launch: {got}")

    reset_counts(counters)
    t0 = time.perf_counter()
    print("[11d] bench.components --batch_size 16")
    results = bench_components.run(bench_components.build_parser().parse_args([]))
    got = totals()
    print(f"    launches in the run {got}; wall {time.perf_counter() - t0:.1f} s")
    if (results["lstm_tier"]["launches"] != {"K2a": 4.0, "K2b": 4.0}
            or results["conv_stack"]["launches"] or results["attention"]["launches"]
            or set(got) != {"K2a", "K2b"}):
        raise AssertionError(f"11d: K2a and K2b should launch 4 times a LSTM-tier call: "
                             f"{ {k: r['launches'] for k, r in results.items()} }")
    gc.collect()
    torch.cuda.empty_cache()

    reset_counts(counters)
    t0 = time.perf_counter()
    print("[11e] bench.train (defaults: --batch_size 16 --steps 8)")
    r = bench_train.run(bench_train.build_parser().parse_args([]))
    got = totals()
    print(f"    first step {r['first_s']:.1f} s; launches in the run {got}; wall "
          f"{time.perf_counter() - t0:.1f} s")
    # 1 + 8 steps, 4 recurrences each
    if got != {"K2a": 36, "K2b": 36} or not r["ms"] > 0:
        raise AssertionError(f"11e: the train step missed K2a / K2b: {got}")
    gc.collect()
    torch.cuda.empty_cache()

    cache_dir = os.path.join(WORK, "cache_card")  # phase 6b's
    for extra in ([], ["--no_device"]):
        t0 = time.perf_counter()
        print(f"[11f] bench.loader --cache_dir <phase 6b's card-built cache> --passes 4 "
              f"{' '.join(extra)}")
        r = bench_loader.run(bench_loader.build_parser().parse_args(
            ["--cache_dir", cache_dir, "--passes", "4"] + extra))
        print(f"    wall {time.perf_counter() - t0:.1f} s")
        if r is None or r["batches"] != 12 or not r["value"] > 0 or r["demand_1chip"] is not None:
            raise AssertionError(f"11f: bench.loader gave {r}")


def example_eval_phase():
    """11g: the port's example.sh eval on phase 6's run and cache, against
    the evaluation CLI in this process on the same checkpoint and flags."""
    out_root = os.path.join(WORK, "example_out")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    os.symlink(os.path.join(WORK, "train_run"), os.path.join(out_root, "train_run"))
    cache_dir, root = os.path.join(WORK, "train_cache"), os.path.join(WORK, "no_raw_audio")
    best = os.path.join(out_root, "train_run", "checkpoints", "model_best.pth")
    env = dict(os.environ, OUT_ROOT=out_root, CACHE_DIR=cache_dir, ROOT_DIR=root,
               EVAL_SPLIT="validation", DEVICE="cuda", EVAL_EXTRA_ARGS="--headless")
    t0 = time.perf_counter()
    proc = subprocess.run(["bash", os.path.join(REPO, "music_transcription_tpu_torch",
                                                "example.sh"), "eval"],
                          env=env, capture_output=True, text=True, timeout=300, cwd=WORK)
    wall = time.perf_counter() - t0
    flow = {ln.split("=")[0]: float(ln.split("=")[1]) for ln in proc.stdout.splitlines()
            if ln.startswith("EVAL_")}
    ref = run_evaluate(["--model", best, "--split", "validation", "--cache_dir", cache_dir,
                        "--root_dir", root, "--tune_threshold", "--device", "cuda",
                        "--headless"])
    ok = (proc.returncode == 0 and f"=== Evaluating {best} on split 'validation'" in proc.stdout
          and set(flow) == set(ref)
          and abs(flow["EVAL_MEAN_F1"] - ref["EVAL_MEAN_F1"]) <= EVAL_F1_TOL
          and abs(flow["EVAL_BEST_THRESHOLD"] - ref["EVAL_BEST_THRESHOLD"]) <= EVAL_THRESHOLD_TOL)
    print(f"[11g] example.sh eval (DEVICE=cuda, EVAL_EXTRA_ARGS=--headless) on phase 6's "
          f"model_best: rc {proc.returncode}, {flow}, wall {wall:.1f} s; the evaluate CLI in "
          f"this process: {ref} (tol {EVAL_F1_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"11g: example.sh eval disagrees with the CLI:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")


def surfaces_phase(torch, lk, ak, pth, wav30, server, card):
    """Phase 11: serve, visualize, the four benches and example.sh eval."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    serve_phase(torch, lk, pth, wav30, server)
    visualize_phase(torch, pth, wav30)
    bench_phase(torch, lk, ak, card)
    example_eval_phase()
    print(f"    phase 11 wall {time.perf_counter() - t_phase:.1f} s")


def print_ptxas(reports: dict) -> None:
    """ptxas's lines of each kernel (registers, shared memory, spills) from
    ``_build.build()``'s reports."""
    for name, log in reports.items():
        for line in log.splitlines():
            if ("ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line)
                    or re.search(r"[1-9]\d* bytes spill", line)):
                print(f"    {name}: {line.strip()}")


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
    from music_transcription_tpu_torch.ops import conv_kernel as ck
    from music_transcription_tpu_torch.ops import lstm_kernel as lk
    from music_transcription_tpu_torch.transcribe import Transcriber, transcribe_audio

    card = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    # 1. build
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"[1] built {', '.join(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    print_ptxas(reports)
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
    gc.collect()  # a peak counts no garbage of earlier phases
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
    warm30 = warm_request_ms(torch, server, y)
    print(f"    warm request (load_audio excluded): {warm30:.1f} ms")
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
    gc.collect()  # a peak counts no garbage of earlier phases
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
    print(f"    warm request (load_audio excluded): "
          f"{warm_request_ms(torch, server120, y120):.1f} ms")
    profile_request(torch, server120, y120)
    del server120
    fp32_120 = fp32_window_phase(torch, ak, pth, wav120)

    # 4b. K5 at the default model's two ConvBNRelu stages, K6 at its two
    # residual blocks, then its CNN front end through both
    k5, k6, conv_launches = conv_phase(torch, ck, model.model, card)

    # 5. the training kernels against their plain versions
    rows = []
    k2 = check_k2(torch, lk, rows)
    k4 = check_k4(torch, ak, rows)
    print("[5] training kernels vs plain versions on " + card)
    for r in rows:
        print("    " + r)

    # 6. training at full width through the CLI (attention on the plain route)
    train_launches, xla_ms, xla_best = train_phase(torch, lk, ak, wav30, rows)

    # 6b. preprocessing on the card and on the host, then training through
    # slab rotation from the card-built cache
    preprocess_slab_phase(torch, lk, ak, card)

    # 7. training at full width through the flash attention
    flash_launches, flash_best, fp32_flash_launches = flash_train_phase(torch, lk, ak, rows,
                                                                        xla_ms)

    # 8. evaluation on the card
    eval_phase(torch, lk, ak, flash_best, xla_best)

    # 8b. the AST tier's inference path, 8c. its training: no hand-written
    # kernel may launch
    counters = (lk.lstm_recurrence, lk.lstm_recurrence_fwd, lk.lstm_recurrence_bwd,
                ak.flash_attention_clamped, ak.flash_attention_clamped_fwd,
                ak.flash_attention_clamped_dq, ak.flash_attention_clamped_dkv,
                ck.fused_conv_bn_relu, ck.fused_res_block)
    ast_phase(torch, counters, wav30, card)
    ast_train_phase(torch, counters, card)

    # 9. data-parallel training at world 2 on the one card
    dp_phase(torch, lk, ak, wav30, card, xla_ms)

    # 10. serving across replicas, evaluation across ranks, tp at world 1,
    # the multi-rank gate
    t_phase = time.perf_counter()
    replicas_phase(torch, lk, ak, pth, wav30, wav120, card, warm30)
    eval_ranks_phase(torch, flash_best)
    tp_world1_phase(torch, lk)
    dryrun_phase()
    print(f"    phase 10 wall {time.perf_counter() - t_phase:.1f} s")

    # 11. serve, visualize, the benches and example.sh eval at full width
    surfaces_phase(torch, lk, ak, pth, wav30, server, card)

    # 12. report
    attention = "music_transcription_tpu_torch/csrc/flash_attention_clamped.cu"
    pallas = "music_transcription_tpu/ops/attention_pallas.py"
    kernels = [
        dict(name="lstm_recurrence", route="cuda",
             source="music_transcription_tpu_torch/csrc/lstm_recurrence.cu",
             replaces="music_transcription_tpu/ops/lstm_pallas.py:71",
             launches=launches30["lstm_recurrence"], ok=True, **k1),
        dict(name="flash_attention_clamped", route="cuda", source=attention,
             replaces=f"{pallas}:38", launches=launches120["flash_attention_clamped"], ok=True,
             **k3["bfloat16"]),
        dict(name="lstm_recurrence_fwd", route="cuda",
             source="music_transcription_tpu_torch/csrc/lstm_recurrence.cu",
             replaces="music_transcription_tpu/ops/lstm_pallas.py:128",
             launches=train_launches["lstm_recurrence_fwd"], ok=True, **k2["K2a"]),
        dict(name="lstm_recurrence_bwd", route="cuda",
             source="music_transcription_tpu_torch/csrc/lstm_recurrence.cu",
             replaces="music_transcription_tpu/ops/lstm_pallas.py:147",
             launches=train_launches["lstm_recurrence_bwd"], ok=True, **k2["K2b"]),
    ]
    # the flash training kernels: bf16 launches on phase 7's steps, fp32 on
    # its fp32 step; K3 in fp32 on phase 4's fp32 request
    for name, key, line in (("flash_attention_clamped_fwd", "K3+lse", 38),
                            ("flash_attention_clamped_dq", "K4a", 152),
                            ("flash_attention_clamped_dkv", "K4b", 173)):
        kernels.append(dict(name=name, route="cuda", source=attention, replaces=f"{pallas}:{line}",
                            launches=flash_launches[name], ok=True, **k4["bfloat16"][key]))
        kernels.append(dict(name=name + "_f32", route="cuda", source=attention,
                            replaces=f"{pallas}:{line}", launches=fp32_flash_launches[name],
                            ok=True, **k4["float32"][key]))
    kernels.append(dict(name="flash_attention_clamped_f32", route="cuda", source=attention,
                        replaces=f"{pallas}:38", launches=fp32_120["auto_launches"], ok=True,
                        **k3["float32"]))
    kernels += [
        dict(name="fused_conv_bn_relu", route="cuda",
             source="music_transcription_tpu_torch/csrc/conv_bn_relu.cu",
             replaces="music_transcription_tpu/ops/conv_pallas.py:141",
             launches=conv_launches["fused_conv_bn_relu"], ok=True, **k5),
        dict(name="fused_res_block", route="cuda",
             source="music_transcription_tpu_torch/csrc/res_block.cu",
             replaces="music_transcription_tpu/ops/conv_pallas.py:214",
             launches=conv_launches["fused_res_block"], ok=True, **k6),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in RANK_MODES:
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main())
