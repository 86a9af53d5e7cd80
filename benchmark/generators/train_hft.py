"""Training traffic of the hFT-Transformer: the program's train step looped
over segments staged on the card, as its training CLI runs a velocity cache
that fits there.

The mix's file gives the segments a step (``batch``), the segments of the
seeded cache's training and validation splits (``cache_segments``,
``validation_segments``), the notes a segment, their length in frames and
their velocities (``notes``, ``note_frames``, ``velocities``: inclusive
ranges), the steps the reference follows (``checked_steps``), the loader's
reading threads (``loader_workers``), and the profiled stretch of a traced
run (``traced_min_s``, ``traced_min_steps``). The configuration gives the
segment: ``segment_frames`` trained frames and ``margin_frames`` on each
side, at its ``audio`` section's hop.

Set-up first builds the model's skeleton (a program without the model
stops there, at once), then draws the cache on the card into host memory
(``velocity_cache``: log-mel-like noise in dB and rolls of notes with
velocities), stages both splits through ``DeviceStagedLoader`` as the CLI
does (the training split shuffled; under bfloat16 compute the mel in
bfloat16 and the velocity roll in uint8), builds the train state, loads the
seeded weights and drives the first ``checked_steps`` steps through
``train_step``: they warm every shape, and their losses, the first gradient
and the parameters' change are what the reference checks
(``generators/train.py``'s ``compare``, and ``grad_small`` here). The
same state then runs the window, steps back to back until ``--seconds``
have passed. A traced run also splits the stretch's device time by the program's spans
(``common/spans.py``) and hands the split to the per-layer readers as the
window's ``split``.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from benchmark.common import inputs, seeds, spans
from benchmark.common.device import Trace
from benchmark.common.phases import Phases
from benchmark.common.result import Outcome, Window
from benchmark.generators.train import Chunks, _epochs, _faulty, _sync, compare, device_info
from benchmark.reference import training as ref_train

SPAN = "train_step"
NUM_KEYS = 88


def nought(name: str) -> bool:
    """An attention's k bias: it shifts the logits of one query by q . b
    over every key alike, which its softmax ignores, so its gradient is
    nought."""
    return name.endswith(".k.bias")


def clip_coef(grad_norm: float, max_grad_norm: float) -> float:
    """The factor the global-norm clip gives every gradient (torch's)."""
    return min(1.0, max_grad_norm / (grad_norm + 1e-6)) if max_grad_norm > 0 else 1.0


def raw_gradients(params: dict, coef: float) -> dict:
    """Each leaf's norm of the step's gradient before the clip (``coef``),
    from the clipped gradient the step leaves on it (0 where it left none)."""
    return {n: float(p.grad.double().norm()) / coef if p.grad is not None else 0.0
            for n, p in params.items()}


def grad_small(ref_out: dict, raw: dict, decay: dict | None = None) -> float:
    """The worst leaf's |g - g_ref| / g_ref of the raw first gradient's norm
    (before the clip and the weight decay) over the leaves that ``compare``
    leaves out of the change, under a thousandth of the median leaf's, though
    their gradient is not nought by construction: the bin embedding and the
    first block's q bias, small beside the rest since the mel's offset swamps
    the embedding, and under L2 weight decay their change is mostly the
    decay's. 0 where there are none. Every leaf left out is printed with its
    share of the median leaf's gradient, its gap, and (``decay``: each leaf's
    weight decay times its starting norm over the clip's factor) the decay
    over the clipped gradient, the two terms of what Adam takes."""
    ref_raw = ref_out["raw_grad"]
    moved = set(ref_train.moved_leaves(ref_raw))
    med = statistics.median(ref_raw.values())
    out, notes = {}, []
    for k in sorted(set(ref_raw) - moved):
        gap = abs(raw[k] - ref_raw[k]) / max(ref_raw[k], 1e-30)
        note = f"{k} {ref_raw[k] / med:.3g} of the median, gap {gap:.3g}"
        if nought(k):
            note += " (nought)"
        else:
            out[k] = gap
        if decay is not None and raw[k] > 0:
            note += f", decay {decay[k] / raw[k]:.3g}x its gradient"
        notes.append(note)
    print(f"leaves left out of the change: {'; '.join(notes) or 'none'}", file=sys.stderr)
    return max(out.values(), default=0.0)


def velocity_cache(segments: int, n_mels: int, frames: int, seed: int, device, *, notes,
                   note_frames, velocities, block: int = 512):
    """(mel (segments, n_mels, frames) float16 dB, roll (segments, 88, frames)
    uint8) on the host, drawn on ``device`` from one generator, ``block``
    segments a draw. A segment holds ``notes`` (lo, hi) notes, each on a
    random key from a random frame for ``note_frames`` frames (cut at the
    segment's end) at a velocity in ``velocities``; where notes of one key
    overlap, the frame holds the largest velocity."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mel = torch.empty((segments, n_mels, frames), dtype=torch.float16)
    roll = torch.empty((segments, NUM_KEYS, frames), dtype=torch.uint8)
    most = int(notes[1])
    t = torch.arange(frames, device=device)
    for a in range(0, segments, block):
        n = min(block, segments - a)
        m = torch.randn((n, n_mels, frames), generator=gen, device=device)
        mel[a:a + n].copy_(m.mul_(10.0).sub_(40.0).half())
        del m
        counts = torch.randint(int(notes[0]), most + 1, (n, 1), generator=gen, device=device)
        keys = torch.randint(0, NUM_KEYS, (n, most), generator=gen, device=device)
        starts = torch.randint(0, frames, (n, most), generator=gen, device=device)
        lengths = torch.randint(int(note_frames[0]), int(note_frames[1]) + 1, (n, most),
                                generator=gen, device=device)
        vel = torch.randint(int(velocities[0]), int(velocities[1]) + 1, (n, most),
                            generator=gen, device=device, dtype=torch.int32)
        out = torch.zeros((n, NUM_KEYS, frames), dtype=torch.int32, device=device)
        rows = torch.arange(n, device=device)
        for j in range(most):
            kept = (j < counts[:, 0]).int()[:, None]
            cover = (t >= starts[:, j:j + 1]) & (t < starts[:, j:j + 1] + lengths[:, j:j + 1])
            on = cover.int() * kept * vel[:, j:j + 1]
            out[rows, keys[:, j]] = torch.maximum(out[rows, keys[:, j]], on)
        roll[a:a + n].copy_(out.to(torch.uint8))
    return mel.numpy(), roll.numpy()


class Plan:
    """What a run draws from the seed, and the reference's steps on it: the
    configuration, the cache's content, the seeds of the weights, the
    loader's order and the dropout masks."""

    def __init__(self, cell, seed, device):
        from music_transcription_tpu_torch.config import ModelConfig, TrainConfig, config_from_dict
        from music_transcription_tpu_torch.models.transcription import TranscriptionModel

        tr = cell.traffic
        self.cell, self.ref, self.device = cell, cell.reference(), device
        self.model_cfg = config_from_dict(ModelConfig, cell.config["model"])
        with torch.device("meta"):
            self.skeleton = TranscriptionModel(self.model_cfg).model
        self.train_cfg = config_from_dict(TrainConfig, {**cell.config.get("train", {}),
                                                        "batch_size": tr["batch"]})
        cfg, audio = self.model_cfg, cell.config["audio"]
        self.frames = cfg.input_frames
        # trained audio a segment, 2.048 s
        self.segment_s = cfg.segment_frames * audio["hop_length"] / audio["sample_rate"]
        self.bf16 = cfg.compute_dtype == "bfloat16"
        self.checked = int(tr["checked_steps"])
        self.s_weights = seeds.part(seed, "weights")
        self.s_embeddings = seeds.part(seed, "embeddings")
        self.s_loader = seeds.part(seed, "loader") % 2**32
        self.s_dropout = seeds.part(seed, "dropout")
        self.s_validation = seeds.part(seed, "validation")
        self.mel, self.roll = self.draw(int(tr["cache_segments"]), seeds.part(seed, "data"))

    def draw(self, segments: int, seed: int):
        tr = self.cell.traffic
        return velocity_cache(segments, self.model_cfg.n_mels, self.frames, seed, self.device,
                              notes=tr["notes"], note_frames=tr["note_frames"],
                              velocities=tr["velocities"])

    def weights(self) -> dict:
        """``inputs.seeded_weights``, which holds entries of no dense or norm
        layer at zero, with each embedding's table drawn from N(0, 1) (torch's
        ``nn.Embedding`` initialiser) by a generator of its own."""
        out = inputs.seeded_weights(self.skeleton, self.s_weights, self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.s_embeddings)
        for name, mod in self.skeleton.named_modules():
            if isinstance(mod, torch.nn.Embedding):
                out[f"{name}.weight"] = torch.randn(tuple(mod.weight.shape), generator=gen,
                                                    device=self.device)
        return out

    def reference(self, precision: str = "float32") -> dict:
        """The reference's first ``checked`` steps on the run's batches."""
        cfg = self.train_cfg
        batches = ref_train.staged_batches(self.mel, self.roll, cfg.batch_size, self.s_loader,
                                           self.checked, self.bf16, self.device)
        masks = [self.ref.MaskStream(self.s_dropout, i, self.device)
                 for i in range(self.checked)]
        return ref_train.reference_steps(
            self.ref, self.weights(), batches, masks, self.cell.config["model"],
            lr=cfg.learning_rate, eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
            max_grad_norm=cfg.max_grad_norm, precision=precision)


def control(cell, *, seed, device, precision) -> dict:
    """The numbers of the reference computed in ``precision``, in the
    program's place, against the float32 reference, on a run's inputs."""
    plan = Plan(cell, seed, device)
    low, ref_out = plan.reference(precision), plan.reference()
    readings = compare(plan.ref, ref_out, low["losses"], low["grad"], low["change"])
    return {**readings, "grad_small": grad_small(ref_out, low["raw_grad"])}


def run(cell, *, seed, seconds, trace, device, t_start, fault=None):
    from music_transcription_tpu_torch.bench import kernel_launches, launches_since
    from music_transcription_tpu_torch.data.pipeline import DeviceStagedLoader
    from music_transcription_tpu_torch.parallel.train_step import init_train_state, train_step

    tr = cell.traffic
    step_fn = _faulty(fault, train_step)
    phases = Phases(t_start)
    phases.mark("imports")
    plan = Plan(cell, seed, device)
    model_cfg, train_cfg = plan.model_cfg, plan.train_cfg
    frames, batch, checked, s_dropout = plan.frames, train_cfg.batch_size, plan.checked, plan.s_dropout
    phases.mark("training cache drawn")
    compact = dict(bf16_fields=(0,), velocity_fields=(1,)) if plan.bf16 else {}
    workers = int(tr["loader_workers"])
    loader = DeviceStagedLoader(Chunks(plan.mel, plan.roll), batch, device=device, shuffle=True,
                                seed=plan.s_loader, num_workers=workers, drop_last=True,
                                pad_to=frames, **compact)
    validation = DeviceStagedLoader(
        Chunks(*plan.draw(int(tr["validation_segments"]), plan.s_validation)), batch,
        device=device, num_workers=max(1, workers // 2), pad_to=frames, pad_last_batch=True,
        **compact)
    phases.mark("staged, with the validation cache drawn")
    state = init_train_state(model_cfg, train_cfg, device)
    missing = state.model.model.load_state_dict(plan.weights(), strict=False).missing_keys
    if missing:
        raise RuntimeError(f"weights left out: {missing}")
    phases.mark("train state and weights")
    params = {n.removeprefix("model."): p for n, p in state.model.named_parameters()}
    start = {n: p.detach().clone() for n, p in params.items()}
    batches = _epochs(loader)
    losses, first_grad, raw, coef = [], None, None, 1.0
    kwargs = dict(max_grad_norm=train_cfg.max_grad_norm)
    before = kernel_launches()
    for i in range(checked):
        out = step_fn(state, next(batches), s_dropout, **kwargs)
        losses.append(out["loss"])
        if i == 0:  # a leaf the optimizer holds no moment of got no gradient
            moments = state.optimizer.state
            first_grad = {n: float(moments[p]["exp_avg"].double().norm()) / (1 - 0.9)
                          if p in moments else 0.0 for n, p in params.items()}
            del moments
            coef = clip_coef(out["grad_norm"], train_cfg.max_grad_norm)
            raw = raw_gradients(params, coef)
    launches = launches_since(before, checked)
    phases.mark(f"{checked} checked steps")
    with torch.no_grad():
        change = {n: float((p.detach() - start[n]).double().norm()) for n, p in params.items()}
        decay = {n: train_cfg.weight_decay * float(w.double().norm()) / coef
                 for n, w in start.items()}
    del start
    if trace:  # the profiler's first start, here and not inside the window
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
    gc.collect()
    _sync(device)
    phases.mark("collect")
    phases.report()
    window = Window(model=cell.config["model"], reference=plan.ref, frames=frames,
                    chunk_s=plan.segment_s, batch=batch, setup_s=time.perf_counter() - t_start)

    # the measured window
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = stretch = None
    failed = 0
    t0 = time.perf_counter()
    while True:
        if trace and prof is None and window.steps == 1:
            t_traced = time.perf_counter()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t_stretch, traced = time.perf_counter(), 0
        with torch.profiler.record_function(SPAN):
            out = step_fn(state, next(batches), s_dropout, **kwargs)
        window.steps += 1
        if out["skipped"]:
            failed += 1
            print(f"step {window.steps} of the window skipped: {out}", file=sys.stderr)
        now = time.perf_counter()
        if prof is not None and stretch is None:
            traced += 1
            enough = (traced >= int(tr["traced_min_steps"])
                      and now - t_stretch >= float(tr["traced_min_s"]))
            if enough or now - t0 >= seconds:
                _sync(device)
                stretch = (prof, time.perf_counter() - t_stretch)
                prof.__exit__(None, None, None)
                window.traced_steps, window.traced_s = traced, time.perf_counter() - t_traced
        if time.perf_counter() - t0 >= seconds:
            break
    window.seconds = time.perf_counter() - t0
    if device.type == "cuda":
        window.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if stretch is not None:
        window.split = spans.split_profile(stretch[0])
        print(window.split.line(), file=sys.stderr, flush=True)
        window.trace = Trace.from_profile(*stretch, span_names=(SPAN,))
        del stretch, prof
    print(f"window: {window.steps} steps of {batch} x {plan.segment_s:g} s in "
          f"{window.seconds:.3f} s; kernel launches a step {launches}; "
          f"losses of the checked steps {losses}", flush=True)
    del state, loader, validation, batches, params, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_out = plan.reference()
    readings = compare(plan.ref, ref_out, losses, first_grad, change)
    readings["grad_small"] = grad_small(ref_out, raw, decay)
    print(f"readings {readings}", file=sys.stderr)
    checks = {k: (readings[k], float(lim)) for k, lim in cell.limits.items()}
    info = device_info(device, cell.chips, window)
    return Outcome(window, window.steps, failed, checks, readings), info, (
        window.trace.breakdown() if window.trace else None)

