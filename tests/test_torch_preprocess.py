"""PyTorch port: preprocessing (``data/preprocess.py``, the CLI
``python -m music_transcription_tpu_torch.preprocess``) and the REMI
tokenizer against the JAX package's, on the synthetic MAESTRO tree of
tests/maestro_fixture.py.

The chunk files and metadata equal the JAX package's: rolls, tokens,
waveforms and the chunk index exactly, the host path's mel within 1e-5 dB
(both run the same numpy code), the device path's mel (run here on the
CPU, in both packages) within 6e-2 dB, the bound of JAX's own device-vs-host
test. Covered as in tests/test_preprocess.py: the host path with its rerun
skip, device vs host, the tail transient, multiprocessing, waveform and
tokenized caches with ``--token_len``, the compact cache, and the CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.data import cache as JC
from music_transcription_tpu.data.preprocess import preprocess_split as j_preprocess_split
from music_transcription_tpu.models.remi_tokenizer import REMITokenizer as JREMITokenizer
from music_transcription_tpu_torch import preprocess as cli
from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.data import cache as C
from music_transcription_tpu_torch.data import preprocess as P
from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer

from tests.maestro_fixture import make_maestro_root, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG, JCFG = AudioConfig(n_mels=32, chunk_length=2.0), JAudioConfig(n_mels=32, chunk_length=2.0)
MEL_HOST_TOL, MEL_DEVICE_TOL = 1e-5, 6e-2  # dB


@pytest.fixture(scope="module")
def maestro_root(tmp_path_factory):
    return make_maestro_root(tmp_path_factory.mktemp("maestro"))


def _port(root, cache_dir, **kw):
    kw = {"device": "cpu", "num_workers": 1, "verbose": False, **kw}
    return P.preprocess_split(root_dir=root, cache_dir=cache_dir, split=kw.pop("split", "train"),
                              audio_cfg=kw.pop("cfg", CFG), chunk_length=2.0, **kw)


def _jax(root, cache_dir, **kw):
    kw = {"use_device": False, "num_workers": 1, "verbose": False, **kw}
    return j_preprocess_split(root_dir=root, cache_dir=cache_dir, split=kw.pop("split", "train"),
                              audio_cfg=kw.pop("cfg", JCFG), chunk_length=2.0, **kw)


def _assert_caches_match(ours, ref, split="train", mel_tol=0.0):
    meta, ref_meta = C.load_metadata(ours, split), JC.load_metadata(ref, split)
    assert meta == ref_meta
    for i in range(meta["num_chunks"]):
        a, b = C.load_chunk(os.path.join(ours, split), i), JC.load_chunk(os.path.join(ref, split), i)
        assert set(a) == set(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k == "mel":
                assert np.abs(a[k] - b[k]).max() <= mel_tol, i
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} of chunk {i}")


def test_host_path_matches_jax_and_skips_on_rerun(maestro_root, tmp_path):
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert _port(maestro_root, ours) == {"total": 5, "processed": 5, "skipped": 0, "failed": 0}
    _jax(maestro_root, ref)
    _assert_caches_match(ours, ref, mel_tol=MEL_HOST_TOL)
    assert C.verify_cache(ours, "train") == (True, "5 chunks ok")
    assert _port(maestro_root, ours)["skipped"] == 5
    assert _port(maestro_root, ours, force=True)["processed"] == 5


def test_device_path_matches_host_and_jax_device_path(maestro_root, tmp_path):
    """The device path, on the CPU here: fixed-shape batches of 2 (the last
    one short), the mel cut back and floored on the host."""
    dev, host, ref = str(tmp_path / "dev"), str(tmp_path / "host"), str(tmp_path / "ref")
    assert _port(maestro_root, dev, use_device=True, device_batch=2)["processed"] == 5
    _port(maestro_root, host)
    _jax(maestro_root, ref, use_device=True, device_batch=2)
    _assert_caches_match(dev, ref, mel_tol=MEL_DEVICE_TOL)
    for i in range(5):
        a, b = C.load_chunk(os.path.join(dev, "train"), i), C.load_chunk(os.path.join(host, "train"), i)
        assert a["mel"].shape == b["mel"].shape
        assert np.abs(a["mel"] - b["mel"]).max() < MEL_DEVICE_TOL
        np.testing.assert_array_equal(a["roll"], b["roll"])


def test_device_path_tail_transient_floor(tmp_path):
    """A loud transient at the very end of a tail chunk moves no floor: the
    floor ranges over the retained frames only, as on the host path."""
    from music_transcription_tpu_torch.data import midi as M

    root, sr = tmp_path / "root", 16000
    y = np.full(3 * sr, 1e-4, np.float32)
    y[-800:] = 0.9  # loud burst in the final 50 ms; 2 s chunks: the tail holds it
    write_wav(root / "2020" / "p.wav", y, sr)
    M.save_midi(M.notes_to_midi([M.Note(pitch=60, start=0.2, end=0.4)]), root / "2020" / "p.midi")
    (root / "maestro-v3.0.0.csv").write_text(
        "canonical_composer,canonical_title,split,year,midi_filename,audio_filename,duration\n"
        "x,p,train,2020,2020/p.midi,2020/p.wav,3.0\n")
    dev, host, ref = str(tmp_path / "d"), str(tmp_path / "h"), str(tmp_path / "r")
    _port(root, dev, use_device=True)
    _port(root, host)
    _jax(root, ref, use_device=True)
    h, v = C.load_chunk(os.path.join(host, "train"), 1), C.load_chunk(os.path.join(dev, "train"), 1)
    assert h["mel"].shape == v["mel"].shape
    assert np.abs(h["mel"] - v["mel"]).max() < MEL_DEVICE_TOL
    _assert_caches_match(dev, ref, mel_tol=MEL_DEVICE_TOL)


def test_device_is_chosen_by_the_device_argument_alone(maestro_root, tmp_path, monkeypatch):
    """use_device=None: the device path exactly for a mel cache on cuda;
    with no card that path raises rather than falling back to the CPU."""
    taken = []
    real = P._preprocess_device
    monkeypatch.setattr(P, "_preprocess_device",
                        lambda *a, **k: taken.append(k["device"]) or real(*a, **k))
    _port(maestro_root, str(tmp_path / "c"), device="cpu")
    _port(maestro_root, str(tmp_path / "w"), device="cuda", return_waveform=True)
    assert taken == []
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            _port(maestro_root, str(tmp_path / "m"), device="cuda")
        assert taken == [torch.device("cuda")]
        assert not os.path.exists(C.metadata_path(tmp_path / "m", "train"))


def test_multiprocessing_pool_writes_the_same_cache(maestro_root, tmp_path):
    one, pool = str(tmp_path / "one"), str(tmp_path / "pool")
    _port(maestro_root, one)
    assert _port(maestro_root, pool, num_workers=2) == {
        "total": 5, "processed": 5, "skipped": 0, "failed": 0}
    assert C.verify_cache(pool, "train")[0]
    for i in range(5):
        a, b = C.load_chunk(os.path.join(one, "train"), i), C.load_chunk(os.path.join(pool, "train"), i)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("token_len", [512, 1024])
def test_waveform_and_tokenized_caches_match_jax(maestro_root, tmp_path, token_len):
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    _port(maestro_root, ours, tokenize=True, token_len=token_len)
    _jax(maestro_root, ref, tokenize=True, token_len=token_len)
    _assert_caches_match(ours, ref)
    data = C.load_chunk(os.path.join(ours, "train"), 0)
    assert set(data) == {"waveform", "tokens", "roll"} and data["tokens"].shape == (token_len,)
    wave, tokens = C.CachedMaestroDataset(ours, "train", verbose=False)[0]
    assert tokens.shape == (token_len,)
    assert C.verify_cache(ours, "train")[0]
    wav_ours, wav_ref = str(tmp_path / "w_ours"), str(tmp_path / "w_ref")
    _port(maestro_root, wav_ours, return_waveform=True)
    _jax(maestro_root, wav_ref, return_waveform=True)
    _assert_caches_match(wav_ours, wav_ref)


def test_compact_cache_matches_jax_and_reads_back_as_the_plain_one(maestro_root, tmp_path):
    plain, compact, ref = str(tmp_path / "plain"), str(tmp_path / "compact"), str(tmp_path / "ref")
    _port(maestro_root, plain, tokenize=True)
    _port(maestro_root, compact, tokenize=True, compact=True)
    _jax(maestro_root, ref, tokenize=True, compact=True)
    for i in range(5):
        with np.load(C.chunk_path(os.path.join(compact, "train"), i)) as z, \
                np.load(JC.chunk_path(os.path.join(ref, "train"), i)) as zr:
            assert z["waveform"].dtype == np.int16 and z["roll"].dtype == np.uint8
            for k in z.files:
                np.testing.assert_array_equal(z[k], zr[k])
        p, c = C.load_chunk(os.path.join(plain, "train"), i), C.load_chunk(os.path.join(compact, "train"), i)
        for k in p:
            np.testing.assert_array_equal(p[k], c[k])
    assert C.load_metadata(compact, "train") == JC.load_metadata(ref, "train")


def test_quantize_i16_is_jax_encoder_and_load_chunk_inverts_it():
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 4096).astype(np.float32)
    np.testing.assert_array_equal(C.quantize_i16(x), JC.quantize_i16(x))
    grid = np.arange(-32768, 32768, 7, dtype=np.int16)
    assert C.PCM16_SCALE == JC.PCM16_SCALE == 32768.0
    np.testing.assert_array_equal(C.quantize_i16(grid.astype(np.float32) / C.PCM16_SCALE), grid)


def test_verify_cache_cases(maestro_root, tmp_path):
    assert C.verify_cache(tmp_path / "none", "train") == (False, "missing metadata for split 'train'")
    C.save_metadata(tmp_path / "empty", "test", {"num_chunks": 0})
    assert C.verify_cache(tmp_path / "empty", "test") == (True, "0 chunks (empty split)")
    cache = tmp_path / "c"
    _port(maestro_root, str(cache))
    os.remove(C.chunk_path(cache / "train", 4))
    ok, msg = C.verify_cache(cache, "train")
    assert not ok and msg == JC.verify_cache(cache, "train")[1] == (
        "chunk count mismatch: metadata=5 files=4")


# ---------------------------------------------------------------------------
# REMI tokenizer
# ---------------------------------------------------------------------------


def test_remi_tokens_equal_jax():
    ours, ref = REMITokenizer(), JREMITokenizer()
    rng = np.random.default_rng(0)
    for t, density in ((50, 0.02), (300, 0.1), (938, 0.05), (40, 0.0)):
        roll = np.zeros((88, t), np.float32)
        for _ in range(int(density * 88 * t / 10)):
            k, s = rng.integers(0, 88), rng.integers(0, t)
            roll[k, s:s + rng.integers(1, 20)] = 1.0
        for max_len in (64, 512, 1024):
            toks = ours.encode_from_pianoroll(roll, max_len=max_len)
            assert toks == ref.encode_from_pianoroll(roll, max_len=max_len)
            assert toks == ours.encode_from_pianoroll(roll.T, max_len=max_len)
            np.testing.assert_array_equal(ours.decode_to_pianoroll(toks, max_t=t),
                                          ref.decode_to_pianoroll(toks, max_t=t))
    np.testing.assert_array_equal(ours.transition_mask(), ref.transition_mask())
    np.testing.assert_array_equal(ours.note_token_mask(), ref.note_token_mask())
    assert ours.decode_to_pianoroll([0, 98, 109, 305, 1], max_t=16).sum() == 0
    small = REMITokenizer(vocab_size=100)
    assert small.note_off_id(80) == small.pad == JREMITokenizer(vocab_size=100).note_off_id(80)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_dry_run_as_a_module(maestro_root, tmp_path):
    proc = subprocess.run([sys.executable, "-m", "music_transcription_tpu_torch.preprocess",
                           "--root_dir", str(maestro_root), "--dry_run", "--n_mels", "32"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DRY RUN" in proc.stdout and "cached_dataset_mels32" in proc.stdout
    assert "Device:      cuda" in proc.stdout


def test_cli_tokenize_requires_waveform(capsys):
    assert cli.main(["--tokenize"]) == 1
    assert "--tokenize requires --waveform" in capsys.readouterr().out


def test_cli_full_run_info_and_verify(maestro_root, tmp_path, capsys):
    cache_dir = str(tmp_path / "clicache")
    assert cli.main(["--root_dir", str(maestro_root), "--cache_dir", cache_dir,
                     "--splits", "train,validation", "--chunk_length", "2.0",
                     "--n_mels", "32", "--verify", "-d", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("verify: OK") == 2
    assert cli.main(["--cache_dir", cache_dir, "--show_cache_info"]) == 0
    info = capsys.readouterr().out
    assert "train: 5 chunks (5 files" in info
    assert "validation: 2 chunks" in info  # 3 s piece, 2 s chunks: a tail of 50% is kept
    ref = str(tmp_path / "ref")
    for split in ("train", "validation"):
        _jax(maestro_root, ref, split=split)
        _assert_caches_match(cache_dir, ref, split=split, mel_tol=MEL_HOST_TOL)


def test_cli_exits_1_under_cuda_with_no_card(maestro_root, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--root_dir", str(maestro_root), "--cache_dir", str(tmp_path / "c"),
                     "--n_mels", "32", "--chunk_length", "2.0"]) == 1
    assert "CUDA is not available" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "c" / "train")
