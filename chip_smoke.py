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
  5. print the kernels line (JSON: launches on the main path, error against
     the plain version, times, bound; a failed check has already exited),
     the card's name and power limit, and as the last line
     {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

import json
import os
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


def profile_request(torch, server, y):
    """Where a warm request's time goes: host stages (clock around work that
    ends in a synchronize) and device time by kernel (torch.profiler)."""
    from torch.autograd import DeviceType
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
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_us = (t3 - t0) * 1e6
    print(f"    profile: split {(t1 - t0) * 1e3:.2f} ms, mel+model+threshold+copy "
          f"{(t2 - t1) * 1e3:.2f} ms, decode {len(notes)} notes {(t3 - t2) * 1e3:.2f} ms; "
          f"device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
          f"(idle share {1 - busy_us / wall_us:.3f})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"      {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


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

    # 5. report
    kernels = [
        dict(name="lstm_recurrence", route="cuda",
             source="music_transcription_tpu_torch/csrc/lstm_recurrence.cu",
             replaces="music_transcription_tpu/ops/lstm_pallas.py:71",
             launches=launches30["lstm_recurrence"], ok=True, **k1),
        dict(name="flash_attention_clamped", route="cuda",
             source="music_transcription_tpu_torch/csrc/flash_attention_clamped.cu",
             replaces="music_transcription_tpu/ops/attention_pallas.py:38",
             launches=launches120["flash_attention_clamped"], ok=True, **k3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
