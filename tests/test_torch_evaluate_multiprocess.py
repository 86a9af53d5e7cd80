"""PyTorch port: the evaluation CLI across ranks, the counterpart of
tests/test_multihost.py's two-process evaluation: ``python -m
music_transcription_tpu_torch.evaluate`` in 2 gloo ranks on the CPU
(``tests/_torch_dist_worker.py``, as torchrun would start them) against the
same CLI in one process, on an eval split of an odd number of samples (the
exact shards differ in length) with the threshold tuned on a separate
split: ``EVAL_MEAN_F1`` and ``EVAL_ONSET_F1`` within 1e-6 and
``EVAL_BEST_THRESHOLD`` within 1e-9, as the JAX test holds its own; rank 1
prints no ``EVAL_`` line; in the normal mode rank 0 alone writes, and the
confusion it plots is one process's. Also ``tune_threshold(grid_fn=...)``
against the JAX package's on the same cached predictions.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from _torch_dist_worker import spawn
from music_transcription_tpu import eval as JE
from music_transcription_tpu_torch import eval as E
from music_transcription_tpu_torch import evaluate as cli
from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, config_to_dict
from music_transcription_tpu_torch.data import cache as C
from music_transcription_tpu_torch.models.transcription import TranscriptionModel

N_MELS, CHUNK = 16, 2.0
MODEL = dict(model_type="cnn_rnn_large", n_mels=N_MELS, hidden_size=8, num_layers=1,
             compute_dtype="float32")


def _scores(text):
    return {line.split("=")[0]: float(line.split("=")[1]) for line in text.splitlines()
            if line.startswith("EVAL_") and "=" in line}


def _one_process(argv):
    out, plotted = io.StringIO(), []
    real = E.plot_confusion
    E.plot_confusion = lambda path, confusion: (plotted.append(np.asarray(confusion)),
                                                real(path, confusion))
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        E.plot_confusion = real
    assert rc == 0, out.getvalue()[-3000:]
    return out.getvalue(), plotted


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A seeded small cnn_rnn_large (.pth + .json), a mel cache with 7 test
    and 4 validation chunks of uneven length, and the CLI run in 2 ranks
    (headless with tuning and onset F1; the normal mode) and in one process."""
    work = tmp_path_factory.mktemp("evaluate_mp")
    acfg = AudioConfig(n_mels=N_MELS, chunk_length=CHUNK)
    torch.manual_seed(0)
    pth = work / "model.pth"
    torch.save(TranscriptionModel(ModelConfig(**MODEL)).model.state_dict(), pth)
    (work / "model.json").write_text(json.dumps({"model": MODEL,
                                                 "audio": config_to_dict(acfg)}))
    cache = work / "cache"
    rng = np.random.default_rng(1)
    t = acfg.mel_frames_per_chunk
    for split, n in (("test", 7), ("validation", 4)):
        for i in range(n):
            C.save_chunk(cache / split, i, {
                "mel": (rng.standard_normal((N_MELS, t - 2 * i)) * 10 - 30).astype(np.float32),
                "roll": (rng.random((88, t - 2 * i)) > 0.7).astype(np.uint8)})
        C.save_metadata(cache, split, {"num_chunks": n, "chunk_length": CHUNK, "overlap": 0.0,
                                       "n_mels": N_MELS, "sr": acfg.sample_rate,
                                       "hop_length": acfg.hop_length})
    base = ["--model", str(pth), "--cache_dir", str(cache), "--split", "test",
            "--batch_size", "2", "-d", "cpu", "--tune_threshold", "--tune_rounds", "3",
            "--tune_split", "validation", "--onset_f1"]

    def normal(out_dir):
        return base + ["--out_dir", str(out_dir), "--midi_limit", "1"]

    for rank in (0, 1):
        (work / f"argv_{rank}.json").write_text(json.dumps(
            {"runs": [base + ["--headless"], normal(work / f"out_rank{rank}")]}))
    _, outs = spawn("evaluate", work)
    headless, _ = _one_process(base + ["--headless"])
    text, plotted = _one_process(normal(work / "out_one"))
    return dict(work=work, outs=outs, headless=headless, normal=text, confusion=plotted[0])


def _run_output(out, i):
    """Rank output of run ``i`` (its lines up to its RUN= marker)."""
    parts = out.split("RUN=")
    assert len(parts) == 3, out[-3000:]
    assert parts[i + 1].startswith(f"{i} RC=0"), out[-3000:]
    return parts[i]


def test_two_rank_evaluate_matches_one_process(setup):
    got = _scores(_run_output(setup["outs"][0], 0))
    want = _scores(setup["headless"])
    assert set(got) == set(want) == {"EVAL_BEST_THRESHOLD", "EVAL_MEAN_F1", "EVAL_ONSET_F1"}
    assert abs(got["EVAL_MEAN_F1"] - want["EVAL_MEAN_F1"]) < 1e-6, (got, want)
    assert abs(got["EVAL_ONSET_F1"] - want["EVAL_ONSET_F1"]) < 1e-6, (got, want)
    assert abs(got["EVAL_BEST_THRESHOLD"] - want["EVAL_BEST_THRESHOLD"]) < 1e-9
    assert not _scores(setup["outs"][1])  # rank 1 prints no EVAL_ line


def test_normal_mode_rank_0_alone_writes_one_process_report(setup):
    work = setup["work"]
    assert not (work / "out_rank1").exists()
    (run_dir,) = [work / "out_rank0" / d for d in os.listdir(work / "out_rank0")]
    (one_dir,) = [work / "out_one" / d for d in os.listdir(work / "out_one")]
    summary, one = ((d / "eval_summary.txt").read_text() for d in (run_dir, one_dir))
    assert "samples: 7" in summary and "ranks: 2" in summary
    mean = next(ln for ln in setup["normal"].splitlines() if ln.startswith("Mean F1:"))
    assert mean in _run_output(setup["outs"][0], 1)  # "Mean F1: <v> over 7 samples"
    assert "Mean F1:" not in setup["outs"][1]
    confusions = [json.loads(ln.removeprefix("CONFUSION=")) for ln in setup["outs"][0].splitlines()
                  if ln.startswith("CONFUSION=")]
    assert len(confusions) == 1 and "CONFUSION=" not in setup["outs"][1]
    assert np.array_equal(np.asarray(confusions[0]), setup["confusion"])
    # the threshold, F1 statistics and best / worst samples in global order
    assert summary.split("threshold:")[1] == one.split("threshold:")[1]


def _cached(n, seed):
    rng = np.random.default_rng(seed)
    probs, targets, lengths = [], [], []
    for i in range(n):
        t = 30 + 3 * i
        probs.append(rng.random((88, t)).astype(np.float16))
        targets.append(rng.random((88, t)) > 0.6)
        lengths.append(t)
    return probs, targets, lengths


@pytest.mark.parametrize("n_ranks", [1, 2, 3])
def test_tune_threshold_grid_fn_matches_jax(n_ranks):
    """A grid that sums the F1 sums of round-robin shards, as the ranks do,
    gives JAX's tuning on the same predictions, and one process's."""
    probs, targets, lengths = _cached(7, 3)

    def grid_fn(module):
        def grid(cached, thresholds):
            sums, count = np.zeros(len(thresholds)), 0
            for p in range(n_ranks):
                part = module.CachedPredictions(probs=cached.probs[p::n_ranks],
                                                targets=cached.targets[p::n_ranks],
                                                lengths=cached.lengths[p::n_ranks])
                s, c = module.grid_f1_sums(part, thresholds)
                sums, count = sums + s, count + c
            return sums / max(1.0, float(count))
        return grid

    kw = dict(rounds=4, verbose=False)
    got = E.tune_threshold(E.CachedPredictions(probs, targets, lengths), grid_fn=grid_fn(E), **kw)
    want = JE.tune_threshold(JE.CachedPredictions(probs, targets, lengths),
                             grid_fn=grid_fn(JE), **kw)
    plain = E.tune_threshold(E.CachedPredictions(probs, targets, lengths), **kw)
    assert got[0] == want[0] == plain[0]
    assert abs(got[1] - want[1]) < 1e-12 and abs(got[1] - plain[1]) < 1e-12
