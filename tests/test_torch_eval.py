"""PyTorch port: evaluation (``music_transcription_tpu_torch.eval`` and the
``python -m music_transcription_tpu_torch.evaluate`` CLI) against the JAX
package's ``eval.py`` and ``scripts/evaluate.py``.

The metrics and report helpers on seeded predictions must give the JAX
package's values exactly. ``predict_probs`` and the CLI run a small
cnn_rnn_large (n_mels 16, hidden 8, fp32) whose weights cross over as one
``.pth`` + ``.json``, which both packages load: the probabilities within
1e-3 (both cache them as float16, one unit of which is 5e-4 near 0.5, and
their fp32 sigmoids differ by float rounding), ``EVAL_MEAN_F1`` and the other
``EVAL_*`` scores within 2e-3 (a frame whose cached probability sits on a
threshold may land on either side of it), ``EVAL_BEST_THRESHOLD`` identical.
"""

import contextlib
import importlib.util
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from music_transcription_tpu import eval as JE
from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.data import cache as JC
from music_transcription_tpu.data.pipeline import Loader as JLoader
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu_torch import eval as E
from music_transcription_tpu_torch import evaluate as cli
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig
from music_transcription_tpu_torch.data.pipeline import Loader
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from tests.maestro_fixture import make_maestro_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MELS, CHUNK = 16, 2.0
MODEL = dict(model_type="cnn_rnn_large", n_mels=N_MELS, hidden_size=8, num_layers=1,
             compute_dtype="float32")
PROB_TOL, F1_TOL = 1e-3, 2e-3


def _cached(module, n=5, t=40, seed=0):
    rng = np.random.default_rng(seed)
    probs = [rng.random((88, t - 3 * i)).astype(np.float16) for i in range(n)]
    targets = [rng.random(p.shape) > 0.8 for p in probs]
    return module.CachedPredictions(probs=probs, targets=targets, lengths=[p.shape[1] for p in probs])


class _EventTokenizer:
    def decode_to_notes(self, tokens):
        from music_transcription_tpu_torch.data.midi import Note

        return [Note(pitch=60 + int(t) % 12, start=0.1 * i, end=0.1 * i + 0.3, velocity=80)
                for i, t in enumerate(tokens)]


class _RollTokenizer:
    def decode_to_pianoroll(self, tokens, max_t):
        roll = np.zeros((88, max_t), np.float32)
        for i, t in enumerate(tokens):
            roll[int(t) % 88, 3 * i:3 * i + 5] = 1
        return roll


def _metric(name, module, tmp_path):
    """One metric or helper of ``module`` (the port's eval or the JAX
    package's) on seeded inputs, as plain Python / numpy values."""
    c = _cached(module)
    rng = np.random.default_rng(4)
    roll_a = (rng.random((88, 60)) > 0.9).astype(np.float32)
    roll_b = (rng.random((88, 60)) > 0.9).astype(np.float32)
    notes_a = [(int(p), float(s), float(s) + 0.2) for p, s in zip(rng.integers(21, 108, 30),
                                                                 rng.random(30) * 5)]
    notes_b = [(p + int(d), s + 0.04 * e, s + 0.3) for (p, s, _), d, e in
               zip(notes_a, rng.integers(0, 2, 30), rng.standard_normal(30))]
    if name == "f1_from_counts":
        return [module.f1_from_counts(*x) for x in ((3, 1, 2), (0, 0, 0), (0, 4, 1))]
    if name == "per_sample_f1":
        return module.per_sample_f1(c, 0.4)
    if name == "mean_f1":
        return module.mean_f1(c, 0.55)
    if name == "grid_f1_sums":
        return module.grid_f1_sums(c, np.arange(0.05, 1.0, 0.1))
    if name == "grid_mean_f1":
        return module.grid_mean_f1(c, np.arange(0.05, 1.0, 0.05))
    if name == "tune_threshold":
        return module.tune_threshold(c, verbose=False)
    if name == "note_onset_prf":
        return module.note_onset_prf(roll_a, roll_b, fs=31.25, tolerance_s=0.1)
    if name == "per_sample_onset_f1":
        return module.per_sample_onset_f1(c, 0.6, fs=31.25)
    if name == "trim_tokens":
        return module.trim_tokens([5, 2, 7, 9, 1, 4, 2], eos_id=1, pad_id=2)
    if name == "note_f1":
        return module.note_f1(notes_b, notes_a, onset_tol=0.05, pitch_tol=0.0)
    if name == "decode_tokens_to_notes":
        return (module.decode_tokens_to_notes([3, 15, 40], _EventTokenizer(), 31.25),
                module.decode_tokens_to_notes([3, 15, 40], _RollTokenizer(), 31.25, max_t=64))
    if name == "global_confusion":
        return module.global_confusion(c, 0.5)
    if name == "write_summary":
        path = tmp_path / f"{module.__name__}.txt"
        module.write_summary(path, module.per_sample_f1(c, 0.5), 0.5, extra={"model": "m"},
                             n_best_worst=3)
        return path.read_text()
    if name == "plot_confusion":
        path = tmp_path / f"{module.__name__}.png"
        module.plot_confusion(path, module.global_confusion(c, 0.5))
        return path.exists()
    if name == "write_sample_midis":
        from music_transcription_tpu_torch.data.midi import load_midi

        out = tmp_path / module.__name__
        module.write_sample_midis(c, 0.7, out, fs=31.25, limit=3)
        return [[(n.pitch, n.start, n.end, n.velocity) for n in load_midi(out / f).instruments[0].notes]
                for f in sorted(os.listdir(out))]
    raise KeyError(name)


METRICS = ["f1_from_counts", "per_sample_f1", "mean_f1", "grid_f1_sums", "grid_mean_f1",
           "tune_threshold", "note_onset_prf", "per_sample_onset_f1", "trim_tokens", "note_f1",
           "decode_tokens_to_notes", "global_confusion", "write_summary", "plot_confusion",
           "write_sample_midis"]


def _plain(x):
    """Notes, tuples and arrays as comparable Python values."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "pitch"):
        return (x.pitch, x.start, x.end)
    return x


@pytest.mark.parametrize("name", METRICS)
def test_metric_equals_jax(name, tmp_path):
    got = _metric(name, E, tmp_path)
    want = _metric(name, JE, tmp_path)
    if name == "write_summary":  # the same report, line for line
        assert got == want
    else:
        assert _plain(got) == _plain(want)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A .pth + .json of a JAX-initialized small cnn_rnn_large, a seeded mel
    cache (test and validation splits) and a synthetic raw MAESTRO tree."""
    d = tmp_path_factory.mktemp("torch_eval")
    acfg = JAudioConfig(n_mels=N_MELS, chunk_length=CHUNK)
    jm = JModel(JModelConfig(**MODEL))
    variables = jax.tree.map(np.asarray, dict(jm.init(jax.random.key(0), jm.example_input(batch=1, t=8))))
    sd = state_dict_from_jax(variables, ModelConfig(**MODEL))
    pth = d / "model.pth"
    torch.save(sd, pth)
    from music_transcription_tpu.config import config_to_dict

    (d / "model.json").write_text(json.dumps({"model": config_to_dict(jm.config),
                                              "audio": config_to_dict(acfg)}))
    cache = d / "cache"
    rng = np.random.default_rng(1)
    t = acfg.mel_frames_per_chunk
    for split, n in (("test", 5), ("validation", 3)):
        for i in range(n):
            JC.save_chunk(cache / split, i, {
                "mel": (rng.standard_normal((N_MELS, t - 2 * i)) * 10 - 30).astype(np.float32),
                "roll": (rng.random((88, t - 2 * i)) > 0.7).astype(np.float32)})
        JC.save_metadata(cache, split, {"num_chunks": n, "chunk_length": CHUNK, "overlap": 0.0,
                                        "n_mels": N_MELS, "sr": 16000, "hop_length": 512,
                                        "return_waveform": False, "tokenize": False})
    root = make_maestro_root(d / "maestro")
    return dict(dir=d, pth=str(pth), cache=str(cache), root=str(root), jm=jm,
                variables=variables)


def test_predict_probs_matches_jax(setup):
    from music_transcription_tpu.data.cache import CachedMaestroDataset as JDataset

    from music_transcription_tpu_torch.data.cache import CachedMaestroDataset

    t = JAudioConfig(n_mels=N_MELS, chunk_length=CHUNK).mel_frames_per_chunk
    ref = JE.predict_probs(setup["jm"], setup["variables"],
                           JLoader(JDataset(setup["cache"], "test", verbose=False), 2, pad_to=t),
                           pad_batch_to=2)
    pm = TranscriptionModel(ModelConfig(**MODEL))
    pm.model.load_state_dict(torch.load(setup["pth"]))
    got = E.predict_probs(pm, Loader(CachedMaestroDataset(setup["cache"], "test", verbose=False), 2,
                                     pad_to=t), pad_batch_to=2)
    assert got.lengths == ref.lengths and len(got.probs) == 5
    for p, r, gt, rt in zip(got.probs, ref.probs, got.targets, ref.targets):
        assert p.dtype == r.dtype == np.float16 and p.shape == r.shape
        assert np.abs(p.astype(np.float32) - r.astype(np.float32)).max() <= PROB_TOL
        assert np.array_equal(gt, rt)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("_jax_evaluate", os.path.join(REPO, "scripts",
                                                                                "evaluate.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _scores(text):
    return {line.split("=")[0]: float(line.split("=")[1]) for line in text.splitlines()
            if line.startswith("EVAL_") and "=" in line}


CLI_MODES = {
    "tuned": ["--split", "test", "--tune_threshold", "--tune_rounds", "3"],
    "tuned_same_split_onset": ["--split", "validation", "--tune_threshold", "--tune_split",
                               "validation", "--onset_f1"],
    "window": ["--data_source", "full", "--split", "train", "--window", "4.0"],
    "full_pieces": ["--data_source", "full", "--split", "train", "--full_pieces", "--onset_f1"],
    "full_pieces_overlap": ["--data_source", "full", "--split", "train", "--full_pieces",
                            "--overlap", "0.5"],
}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_scores_equal_jax(setup, mode):
    argv = ["--model", setup["pth"], "--cache_dir", setup["cache"], "--root_dir", setup["root"],
            "--headless", "--batch_size", "2", *CLI_MODES[mode]]
    rc, want = _run(_jax_cli().main, argv + ["--device", "cpu"])
    assert rc == 0, want
    rc, got = _run(cli.main, argv + ["-d", "cpu"])
    assert rc == 0, got
    got, want = _scores(got), _scores(want)
    assert set(got) == set(want) and "EVAL_MEAN_F1" in got
    for key, value in want.items():
        if key == "EVAL_BEST_THRESHOLD":
            assert got[key] == value
        else:
            assert 0.0 <= got[key] <= 1.0 and abs(got[key] - value) <= F1_TOL, key


def test_cli_report_artifacts_and_show_results(setup):
    out_dir = setup["dir"] / "eval_out"
    rc, text = _run(cli.main, ["--model", setup["pth"], "--cache_dir", setup["cache"], "--split",
                               "test", "--out_dir", str(out_dir), "--subset", "4", "--midi_limit",
                               "2", "--onset_f1", "-d", "cpu"])
    assert rc == 0, text
    assert "Mean F1:" in text and "over 4 samples" in text
    (run_dir,) = [out_dir / r for r in os.listdir(out_dir)]
    summary = (run_dir / "eval_summary.txt").read_text()
    assert "samples: 4" in summary and "mean onset F1" in summary
    assert (run_dir / "confusion_matrix.png").exists()
    assert len(os.listdir(run_dir / "midis")) == 2
    rc, shown = _run(cli.main, ["--show_results", str(run_dir)])
    assert rc == 0 and "EVALUATION SUMMARY" in shown


@pytest.mark.parametrize("extra,expect", [
    (["--dry_run"], "Samples:     5"),
    (["--verify_compatibility"], "Compatibility check passed."),
    (["--window", "4.0"], "raw data source"),
    (["--full_pieces"], "raw data source"),
    (["--tune_threshold", "--tune_split", "train"], "tune_split"),
])
def test_cli_modes_and_refusals(setup, extra, expect):
    rc, text = _run(cli.main, ["--model", setup["pth"], "--cache_dir", setup["cache"], "--split",
                               "test", "--headless", "-d", "cpu", *extra])
    assert expect in text
    assert rc == (0 if extra[0] in ("--dry_run", "--verify_compatibility") else 1), text


def test_cli_refuses_ast_orbax_and_missing_card(setup, tmp_path, monkeypatch):
    ast = tmp_path / "ast.pth"
    ast.write_bytes(b"")
    (tmp_path / "ast.json").write_text(json.dumps({"model": {"model_type": "ast"}}))
    rc, text = _run(cli.main, ["--model", str(ast), "--cache_dir", setup["cache"], "-d", "cpu"])
    assert rc == 1 and "AST" in text
    orbax = tmp_path / "ckpt_dir"
    orbax.mkdir()
    rc, text = _run(cli.main, ["--model", str(orbax), "--cache_dir", setup["cache"], "-d", "cpu"])
    assert rc == 1 and "orbax" in text and "save_torch_checkpoint" in text
    assert _run(cli.main, ["--cache_dir", setup["cache"]])[0] == 1  # no --model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, text = _run(cli.main, ["--model", setup["pth"], "--cache_dir", setup["cache"]])
    assert rc == 1 and "CUDA is not available" in text


def test_cli_background_spawns_and_logs(setup, tmp_path):
    log = tmp_path / "bg.log"
    rc, text = _run(cli.main, ["--model", setup["pth"], "--cache_dir", setup["cache"], "--split",
                               "test", "--dry_run", "-d", "cpu", "--background", "--log_file",
                               str(log), "--out_dir", str(tmp_path)])
    assert rc == 0 and "started in background" in text
    pid = int(text.split("pid ")[1].split(")")[0])
    deadline = 120.0
    import time

    while deadline > 0 and "DRY RUN - no evaluation" not in (log.read_text() if log.exists() else ""):
        time.sleep(0.5)
        deadline -= 0.5
    assert "DRY RUN - no evaluation" in log.read_text()
    with contextlib.suppress(ChildProcessError):
        os.waitpid(pid, 0)
