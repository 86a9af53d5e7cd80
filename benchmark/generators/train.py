"""Training traffic: the program's train step looped over batches staged on
the card, as its training CLI runs a cache that fits there.

The mix's file gives the rows a step (``batch``), the chunks of the seeded
cache's training and validation splits (``cache_chunks``,
``validation_chunks``) and their length (``chunk_length``), the steps the
reference follows (``checked_steps``), the loader's reading threads
(``loader_workers``), and the profiled stretch of a traced run
(``traced_min_s``, ``traced_min_steps``).

Set-up draws the cache on the card and keeps it in host memory, then stages
both splits through ``DeviceStagedLoader`` as the CLI does (the training
split shuffled; under bfloat16 compute the mel in bfloat16 and the roll in
uint8), builds the train state with ``init_train_state`` and loads the
seeded weights into it, then drives the first ``checked_steps`` steps
through ``train_step``: they compile and warm every shape, and their losses,
the first gradient (from Adam's first moment after one step) and the
parameters' change after them are what the reference checks. The same
state then runs the window: steps back to back until ``--seconds`` have
passed, each ending in the step's own host read of the loss. A step the
program skips (a loss or gradient that is not finite) counts as failed.
The validation split stays on the card through the window, as it does
through a training epoch, and is not read.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark.common import inputs, seeds
from benchmark.common.device import Trace
from benchmark.common.phases import Phases
from benchmark.common.result import Outcome, Window
from benchmark.reference import training as ref_train

SPAN = "train_step"


class Chunks:
    """The cache as a dataset: item i is (mel (M, T), roll (88, T))."""

    def __init__(self, mel, roll):
        self.mel, self.roll = mel, roll

    def __len__(self) -> int:
        return len(self.mel)

    def __getitem__(self, i: int):
        return self.mel[i], self.roll[i]


def _epochs(loader):
    while True:
        yield from loader


def _faulty(fault, step_fn):
    """The train step broken underneath, for the benchmark's own tests and
    its fault readings: ``frozen`` computes the training loss and returns
    the state unchanged; ``half_batch`` trains on the first half of the rows
    alone."""
    if fault is None:
        return step_fn
    if fault == "half_batch":
        def half(state, batch, *a, **k):
            return step_fn(state, tuple(x[: x.shape[0] // 2] for x in batch), *a, **k)
        return half
    if fault == "frozen":
        def frozen(state, batch, dropout_seed, **k):
            from music_transcription_tpu_torch.parallel.train_step import dropout_generator

            model = state.model
            kept = {n: b.clone() for n, b in model.named_buffers()}
            model.train()
            with torch.no_grad():
                gen = dropout_generator(dropout_seed, state.step, batch[0].device)
                loss = float(model.loss(model(batch[0], return_all_heads=model.multi_head,
                                              generator=gen), batch[1], batch[2]))
                for n, b in model.named_buffers():
                    b.copy_(kept[n])
            state.step += 1
            return {"loss": loss, "grad_norm": 0.0, "skipped": 0.0}
        return frozen
    raise ValueError(f"unknown fault {fault!r}")


class Plan:
    """What a run draws from the seed, and the reference's steps on it: the
    configuration, the cache's content, the seeds of the weights, the
    loader's order and the dropout masks."""

    def __init__(self, cell, seed, device):
        from music_transcription_tpu_torch.config import (AudioConfig, ModelConfig,
                                                          TrainConfig, config_from_dict)
        from music_transcription_tpu_torch.models.transcription import TranscriptionModel

        tr = cell.traffic
        self.cell, self.ref, self.device = cell, cell.reference(), device
        self.model_cfg = config_from_dict(ModelConfig, cell.config["model"])
        self.train_cfg = config_from_dict(TrainConfig, {**cell.config.get("train", {}),
                                                        "batch_size": tr["batch"]})
        self.acfg = AudioConfig(n_mels=self.model_cfg.n_mels,
                                chunk_length=float(tr["chunk_length"]))
        self.frames = self.acfg.mel_frames_per_chunk
        self.bf16 = self.model_cfg.compute_dtype == "bfloat16"
        self.checked = int(tr["checked_steps"])
        self.s_weights = seeds.part(seed, "weights")
        self.s_loader = seeds.part(seed, "loader") % 2**32
        self.s_dropout = seeds.part(seed, "dropout")
        self.mel, self.roll = inputs.train_cache(int(tr["cache_chunks"]), self.model_cfg.n_mels,
                                                 self.frames, seeds.part(seed, "data"), device)
        self.s_validation = seeds.part(seed, "validation")
        with torch.device("meta"):
            self.skeleton = TranscriptionModel(self.model_cfg).model

    def weights(self) -> dict:
        return inputs.seeded_weights(self.skeleton, self.s_weights, self.device)

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
    low = plan.reference(precision)
    return compare(plan.ref, plan.reference(), low["losses"], low["grad"], low["change"])


def run(cell, *, seed, seconds, trace, device, t_start, fault=None):
    from music_transcription_tpu_torch.data.pipeline import DeviceStagedLoader
    from music_transcription_tpu_torch.parallel.train_step import init_train_state, train_step
    from music_transcription_tpu_torch.bench import kernel_launches, launches_since

    tr = cell.traffic
    step_fn = _faulty(fault, train_step)
    phases = Phases(t_start)
    phases.mark("imports")
    plan = Plan(cell, seed, device)
    model_cfg, train_cfg, acfg = plan.model_cfg, plan.train_cfg, plan.acfg
    frames, batch, mel, roll = plan.frames, train_cfg.batch_size, plan.mel, plan.roll
    checked, s_dropout = plan.checked, plan.s_dropout
    phases.mark("training cache drawn")
    compact = dict(bf16_fields=(0,), u8_fields=(1,)) if plan.bf16 else {}
    workers = int(tr["loader_workers"])
    loader = DeviceStagedLoader(Chunks(mel, roll), batch, device=device, shuffle=True,
                                seed=plan.s_loader, num_workers=workers, drop_last=True,
                                pad_to=frames, **compact)
    validation = DeviceStagedLoader(
        Chunks(*inputs.train_cache(int(tr["validation_chunks"]), model_cfg.n_mels, frames,
                                   plan.s_validation, device)),
        batch, device=device, num_workers=max(1, workers // 2), pad_to=frames,
        pad_last_batch=True, **compact)
    phases.mark("staged, with the validation cache drawn")
    state = init_train_state(model_cfg, train_cfg, device)
    module = state.model.model
    missing = module.load_state_dict(plan.weights(), strict=False).missing_keys
    if any("num_batches_tracked" not in k for k in missing):
        raise RuntimeError(f"weights left out: {missing}")
    phases.mark("train state and weights")
    params = {n.removeprefix("model."): p for n, p in state.model.named_parameters()}
    start = {n: p.detach().clone() for n, p in params.items()}
    batches = _epochs(loader)
    losses, first_grad = [], None
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
    launches = launches_since(before, checked)
    phases.mark(f"{checked} checked steps")
    with torch.no_grad():
        change = {n: float((p.detach() - start[n]).double().norm()) for n, p in params.items()}
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
                    chunk_s=acfg.chunk_length, batch=batch,
                    setup_s=time.perf_counter() - t_start)

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
        window.trace = Trace.from_profile(*stretch, span_names=(SPAN,))
        del stretch, prof
    print(f"window: {window.steps} steps of {batch} x {acfg.chunk_length:g} s in "
          f"{window.seconds:.3f} s; kernel launches a step {launches}; "
          f"losses of the checked steps {losses}", flush=True)
    del state, loader, validation, batches, params, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = compare(plan.ref, plan.reference(), losses, first_grad, change)
    print(f"readings {readings}", file=sys.stderr)
    checks = {k: (readings[k], float(lim)) for k, lim in cell.limits.items()}
    info = device_info(device, cell.chips, window)
    return Outcome(window, window.steps, failed, checks, readings), info, (
        window.trace.breakdown() if window.trace else None)


def compare(model, ref_out, losses, first_grad, change) -> dict:
    """The numbers that can be compared: the worst step's loss gap and the
    first step's; the worst and the median leaf's gap of the first gradient
    and of the change; and the worst leaf's of both among the layers past
    every recurrence (``model.PAST_RECURRENCE``), whose gradients do not
    pass back through a BiLSTM. Each layer's worst leaf is printed."""
    inf = float("inf")
    names = set(ref_out["change"])
    if first_grad is None or set(first_grad) != names or set(change) != names:
        print(f"the program's trained leaves differ from the reference's: "
              f"{sorted(names ^ set(change))}", file=sys.stderr)
        return dict.fromkeys(("loss", "loss_first", "grad", "grad_median", "grad_past",
                              "change", "change_median", "change_past"), inf)
    gaps = [abs(a - b) / abs(b) if np.isfinite(a) else inf
            for a, b in zip(losses, ref_out["losses"])]
    moved = ref_train.moved_leaves(ref_out["raw_grad"])
    grad = ref_train.leaf_gaps(first_grad, ref_out["grad"], names)
    chg = ref_train.leaf_gaps(change, ref_out["change"], moved)
    g_leaf, c_leaf = max(grad, key=grad.get), max(chg, key=chg.get)
    for what, got in (("first gradient", grad), ("change", chg)):
        worst = {}
        for k, v in got.items():
            worst[model.layer(k)] = max(worst.get(model.layer(k), 0.0), v)
        print(f"worst {what} leaf a layer: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                        sorted(worst.items())), file=sys.stderr)
    print(f"losses {losses}, reference {ref_out['losses']}; worst first-gradient leaf "
          f"{g_leaf}; worst change leaf {c_leaf}; {len(names) - len(moved)} leaves left out of "
          f"the change: {sorted(names - set(moved))}", file=sys.stderr, flush=True)
    past = {k for k in names if model.layer(k) in model.PAST_RECURRENCE}
    return {"loss": max(gaps), "loss_first": gaps[0], "grad": grad[g_leaf],
            "grad_median": ref_train.median_leaf(first_grad, ref_out["grad"], names),
            "grad_past": max(grad[k] for k in past),
            "change": chg[c_leaf],
            "change_median": ref_train.median_leaf(change, ref_out["change"], moved),
            "change_past": max((chg[k] for k in past if k in chg), default=0.0)}


def device_info(device, chips, window) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": window.peak_bytes}
    if window.trace is not None:
        info["busy_s"] = window.trace.busy_s()
        info["window_s"] = window.trace.wall_s
    return info


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
