"""PyTorch port: the microbenchmarks (``python -m music_transcription_tpu_torch.bench.*``)
on the CPU at tiny shapes.

Checked: each bench's ``main(argv)`` with ``--device cpu`` prints the JAX
script's line; ``stage_macs`` equals the JAX script's MAC expressions
exactly; ``bench.loader``'s JSON has the JAX script's fields and values
(but the rate) on the same tree, and null demand fields without
``--demand_step_ms``; ``bench.train`` refuses a ``--data_parallel`` other
than the ranks launched; every bench exits 1 without a card unless asked
for the CPU; the timer's medians and call counts.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from music_transcription_tpu_torch import bench
from music_transcription_tpu_torch.bench import attention as bench_attention
from music_transcription_tpu_torch.bench import components as bench_components
from music_transcription_tpu_torch.bench import loader as bench_loader
from music_transcription_tpu_torch.bench import train as bench_train
from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.data import cache as C
from tests.maestro_fixture import make_maestro_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = r"\s*\d+\.\d+"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tiny_geometry(monkeypatch):
    """The model benches at a tiny width: H=8 (components: 16), 1 s chunks."""
    monkeypatch.setattr(bench_components, "HIDDEN_SIZE", 16)
    monkeypatch.setattr(bench_components, "NUM_LAYERS", 2)
    monkeypatch.setattr(bench_components, "CHUNK_LENGTH", 1.0)
    monkeypatch.setattr(bench_train, "HIDDEN_SIZE", 8)
    monkeypatch.setattr(bench_train, "NUM_LAYERS", 1)
    monkeypatch.setattr(bench_train, "CHUNK_LENGTH", 1.0)


def test_attention_prints_the_jax_line(capsys):
    before = bench.kernel_launches()
    assert bench_attention.main(["--device", "cpu", "--t", "20", "37", "--batch", "1",
                                 "--heads", "2", "--head_dim", "16", "--iters", "2",
                                 "--chain", "2"]) == 0
    out = capsys.readouterr()
    lines = [ln for ln in out.out.splitlines() if "fwd=" in ln]
    assert len(lines) == 4
    for line, (t, backend) in zip(lines, [(20, "xla"), (20, "pallas"), (37, "xla"),
                                          (37, "pallas")]):
        assert re.fullmatch(rf"T={t:5d} {backend:6s} fwd={MS}ms fwd\+bwd={MS}ms", line), line
    assert "launches a call: fwd {} fwd+bwd {}" in out.out  # the CPU runs the plain versions
    assert "host clock" in out.err
    assert bench.kernel_launches() == before


def test_attention_rows_time_both_backends():
    args = bench_attention.build_parser().parse_args(
        ["--device", "cpu", "--t", "9", "--batch", "2", "--heads", "1", "--head_dim", "8",
         "--iters", "1", "--chain", "1"])
    rows = bench_attention.run(args)
    assert [(r["t"], r["backend"]) for r in rows] == [(9, "xla"), (9, "pallas")]
    assert all(r["fwd_ms"] > 0 and r["fwdbwd_ms"] > 0 for r in rows)


def _jax_stage_macs(B, T, mels, H):
    """scripts/bench_components.py:125-147, as written there."""
    def conv_macs(cout, hw, k, cin):
        return B * cout * hw * k * cin

    hw1, hw2, hw3 = (mels // 2) * T, (mels // 4) * T, (mels // 8) * T
    lstm_in = 256 * (mels // 8)
    return {
        "conv_stack": (
            conv_macs(32, mels * T, 9, 1)
            + conv_macs(64, hw1, 9, 32) + conv_macs(64, hw1, 9, 64) + conv_macs(64, hw1, 1, 32)
            + conv_macs(128, hw2, 9, 64) + conv_macs(128, hw2, 9, 128) + conv_macs(128, hw2, 1, 64)
            + conv_macs(256, hw2, 21, 128)
        ),
        "lstm_tier": (
            B * T * lstm_in * 4 * H * 2            # main l1 xw (both dirs)
            + 2 * (B * T * 2 * H * 4 * H * 2)      # main l2, l3 xw
            + 3 * (T * 2 * B * H * 4 * H)          # main recurrences
            + B * T * lstm_in * 4 * (H // 2) * 2   # local xw
            + T * 2 * B * (H // 2) * 4 * (H // 2)  # local recurrence
        ),
        "attention": (
            B * T * 1536 * 3 * 1536 + 2 * B * 8 * T * T * 192 + B * T * 1536 * 1536
        ),
    }


@pytest.mark.parametrize("B,T,mels,H", [(16, 938, 320, 512), (3, 61, 48, 96)])
def test_stage_macs_equal_the_jax_expressions(B, T, mels, H):
    ours = bench_components.stage_macs(B, T, mels, H)
    assert ours == _jax_stage_macs(B, T, mels, H)
    assert all(isinstance(v, int) for v in ours.values())


def test_components_prints_each_stage(tiny_geometry, capsys):
    assert bench_components.main(["--device", "cpu", "--batch_size", "2", "--n_mels", "16",
                                  "--iters", "1", "--chain", "1"]) == 0
    out = capsys.readouterr().out
    assert "B=2 T=32 n_mels=16 lstm=pallas device=cpu (host clock)" in out
    for name in ("conv_stack", "lstm_tier", "attention"):
        assert re.search(rf"^{name:12s} fwd\+bwd{MS} ms \|{MS} TFLOP \|{MS} TFLOP/s achieved",
                         out, re.M), out
    assert re.search(rf"^SUM {' ' * 8}{' ' * 9}{MS} ms \|{MS} TFLOP$", out, re.M), out
    assert "on cpu" in out


def test_train_prints_the_jax_line(tiny_geometry, capsys):
    assert bench_train.main(["--device", "cpu", "--batch_size", "2", "--n_mels", "16",
                             "--steps", "2"]) == 0
    out = capsys.readouterr()
    assert re.fullmatch(rf"train step:{MS} ms \|{MS} chunks/s \| \d+ audio-seconds/s\n", out.out)
    assert "devices=1 batch=2 T=32 (host clock)" in out.err


def test_train_refuses_ranks_it_was_not_launched_with(tiny_geometry):
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        bench_train.main(["--device", "cpu", "--data_parallel", "2"])


@pytest.fixture(scope="module")
def maestro_root(tmp_path_factory):
    return make_maestro_root(tmp_path_factory.mktemp("maestro"))


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """7 train chunks of seeded mel and roll at n_mels 16, 1 s."""
    root = tmp_path_factory.mktemp("cache")
    acfg = AudioConfig(n_mels=16, chunk_length=1.0)
    t = acfg.mel_frames_per_chunk
    rng = np.random.default_rng(0)
    for i in range(7):
        C.save_chunk(root / "train", i, {
            "mel": (rng.standard_normal((16, t)) * 10 - 40).astype(np.float32),
            "roll": (rng.random((88, t)) > 0.9).astype(np.uint8)})
    C.save_metadata(root, "train", {"num_chunks": 7, "chunk_length": 1.0, "overlap": 0.0,
                                    "n_mels": 16, "sr": acfg.sample_rate,
                                    "hop_length": acfg.hop_length})
    return str(root)


@pytest.mark.parametrize("no_device", [False, True], ids=["device_feed", "loader_alone"])
def test_loader_on_a_cache_has_null_demand_without_a_step_time(cache_dir, capsys, no_device):
    argv = ["--cache_dir", cache_dir, "--n_mels", "16", "--chunk_length", "1.0",
            "--batch_size", "2", "--num_workers", "2", "--device", "cpu", "--passes", "2"]
    assert bench_loader.main(argv + (["--no_device"] if no_device else [])) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["source"] == "cache" and out["batches"] == 6 and out["value"] > 0
    assert out["device_feed"] is not no_device
    assert {k: out[k] for k in out if k.startswith(("demand", "headroom"))} == {
        "demand_1chip": None, "headroom_vs_1chip": None}


def test_loader_matches_the_jax_script_on_a_raw_tree(maestro_root, capsys):
    argv = ["--root_dir", maestro_root, "--raw", "--n_mels", "32", "--chunk_length", "1.0",
            "--batch_size", "2", "--num_workers", "2", "--device", "cpu", "--no_device",
            "--demand_step_ms", "250.0", "--demand_chips", "8"]
    assert bench_loader.main(argv) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _jax_script("bench_loader").main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(ours) == list(theirs)
    for k in ("value", "audio_s_per_s", "headroom_vs_8chip"):  # rates: measured, not equal
        ours.pop(k), theirs.pop(k)
    assert ours == theirs and ours["source"] == "raw" and ours["demand_8chip"] == 64.0


def test_loader_names_the_demand_fields_by_the_chips_given(maestro_root, capsys):
    assert bench_loader.main(["--root_dir", maestro_root, "--n_mels", "32",
                              "--chunk_length", "1.0", "--batch_size", "2", "--device", "cpu",
                              "--no_device", "--demand_step_ms", "100", "--demand_chips",
                              "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["demand_1chip"], out["demand_4chip"]) == (20.0, 80.0)
    assert abs(out["headroom_vs_4chip"] - out["value"] / 80.0) <= 0.01  # both rounded


def test_loader_needs_a_source_and_enough_items(tmp_path, cache_dir):
    assert bench_loader.main(["--device", "cpu"]) == 2
    assert bench_loader.main(["--cache_dir", cache_dir, "--batch_size", "4", "--n_mels", "16",
                              "--device", "cpu"]) == 2  # one batch of 4 in 7 items


@pytest.mark.parametrize("module,argv", [
    (bench_attention, []), (bench_components, []), (bench_train, []),
    (bench_loader, ["--cache_dir", "unused"])], ids=["attention", "components", "train",
                                                     "loader"])
def test_every_bench_needs_a_card_unless_asked_for_the_cpu(module, argv, capsys):
    if torch.cuda.is_available():
        return
    assert module.main(argv) == 1
    assert "CUDA is not available" in capsys.readouterr().out


def test_time_ms_takes_the_median_window_over_its_calls():
    calls = []
    ms, n = bench.time_ms(lambda: calls.append(1), "cpu", iters=3, warmup=2, chain=4)
    assert n == len(calls) == 2 + 3 * 4 and ms >= 0
    assert bench.clock("cpu") == "host clock" and bench.clock("cuda:0") == "CUDA events"


def test_launches_since_reports_per_call(monkeypatch):
    before = bench.kernel_launches()
    monkeypatch.setattr(bench.KERNELS["K2a"], "launches", before["K2a"] + 8)
    assert bench.launches_since(before, calls=2) == {"K2a": 4.0}
