"""End-to-end transcription pipeline: audio file -> MIDI, on a CUDA card.

Port of the JAX package's ``transcribe.py``. Every 30 s chunk of a
recording becomes a row of one device batch; the log-mel frontend, the model
forward, sigmoid and threshold run on the device; note decoding (roll ->
MIDI) stays on the host, vectorized over all pitches.

Per-chunk semantics: 30 s windows zero-padded at the tail, per-chunk dB
floor, sigmoid > threshold, rolls concatenated along time (or stitched from
overlapping windows), transition decode at fs = sr / hop = 31.25 fps with
velocity 100.

AST checkpoints take the token route: every chunk's tokens are generated
on the device (greedy, ``beam`` search, grammar-``constrained``), decoded to
a roll of ``roll_frames_per_chunk`` frames on the host by the checkpoint's
tokenizer, and the rolls concatenated.

Serving across devices, as the JAX package's mesh branch: ``Transcriber``
loads one replica of the model on each of its ``devices`` (every visible
card for ``device="cuda"``, one CPU device for ``device="cpu"``, or an
explicit list such as ``["cuda:0", "cuda:1"]``), each built from the loaded
state_dict once at load. A request's chunk count is padded to a multiple of
the replica count, contiguous blocks go to the replicas in order, every
block is launched before any result is copied back (so the cards overlap),
and the padded rows are dropped. Each replica runs the whole pipeline on
its rows with no collective, its kernels on its card, and the "auto"
attention rule decides from its own block. With one device the path is the
single-device one, bit for bit. The AST token route serves on the first
device, as in JAX.

Entry points default to ``device="cuda"`` and raise ``RuntimeError`` when no
card is visible, unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from music_transcription_tpu_torch.checkpoints import load_torch_checkpoint
from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, config_from_dict
from music_transcription_tpu_torch.data import audio as audio_io
from music_transcription_tpu_torch.data import midi as midi_io
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.ops.mel import log_mel_batch

CONVERT_HINT = (
    "convert it with the JAX package: python -c \"import json,sys; "
    "from music_transcription_tpu.config import ModelConfig; "
    "from music_transcription_tpu.train.checkpoints import load_checkpoint, save_torch_checkpoint; "
    "d,o=sys.argv[1:]; c=json.load(open(d+'/config.json')); "
    "save_torch_checkpoint(o, load_checkpoint(d), ModelConfig(**c['model'])); "
    "json.dump(c, open(o[:-4]+'.json','w'))\" CKPT_DIR model.pth; "
    "an AST checkpoint (which save_torch_checkpoint refuses) through this "
    "package's map, on a machine with both packages: python -c \"import json,sys,torch; "
    "from music_transcription_tpu.train.checkpoints import load_checkpoint; "
    "from music_transcription_tpu_torch.config import ModelConfig; "
    "from music_transcription_tpu_torch.checkpoints import state_dict_from_jax; "
    "d,o=sys.argv[1:]; c=json.load(open(d+'/config.json')); "
    "torch.save(state_dict_from_jax(load_checkpoint(d), ModelConfig(**c['model'])), o); "
    "json.dump(c, open(o[:-4]+'.json','w'))\" CKPT_DIR model.pth"
)


@dataclass
class LoadedModel:
    model: TranscriptionModel
    audio_cfg: AudioConfig


def resolve_device(device="cuda") -> torch.device:
    """The torch device to run on; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: no GPU is visible to PyTorch. Pass "
            "device='cpu' (CLI: -d cpu) to run on the CPU.")
    return dev


def serving_devices(device="cuda", devices=None) -> list[torch.device]:
    """The devices a server holds a replica on: ``devices`` as given (each
    through ``resolve_device``), else every visible card for ``"cuda"``
    without an index, else ``device`` alone."""
    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("devices is empty: name at least one device")
        return out
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def replicate_model(model: TranscriptionModel, devices) -> list[TranscriptionModel]:
    """``model`` (on ``devices[0]``) and a replica on each other device,
    built from its config and loaded from its state_dict, in eval mode."""
    replicas = [model]
    for device in devices[1:]:
        replica = TranscriptionModel(model.config)
        replica.load_state_dict(model.state_dict())
        replicas.append(replica.eval().to(device))
    return replicas


def load_model(checkpoint_path, model_cfg: ModelConfig | None = None,
               audio_cfg: AudioConfig | None = None, device="cuda") -> LoadedModel:
    """Load a ``.pth`` state_dict and its ``X.json`` sidecar (model + audio
    config) onto ``device``, in eval mode. Without a sidecar the shipped
    defaults apply."""
    device = resolve_device(device)
    path = str(checkpoint_path)
    if os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory; the PyTorch port "
                         f"reads .pth + .json: {CONVERT_HINT}")
    sidecar = os.path.splitext(path)[0] + ".json"
    if os.path.exists(sidecar) and (model_cfg is None or audio_cfg is None):
        try:
            with open(sidecar) as f:
                saved = json.load(f)
            if not isinstance(saved, dict):
                raise ValueError(f"expected a JSON object, got {type(saved).__name__}")
            if model_cfg is None and isinstance(saved.get("model"), dict):
                model_cfg = config_from_dict(ModelConfig, saved["model"])
            if audio_cfg is None and isinstance(saved.get("audio"), dict):
                audio_cfg = config_from_dict(AudioConfig, saved["audio"])
        except (OSError, ValueError, TypeError) as e:  # an unrelated X.json must not break X.pth loads
            print(f"Warning: ignoring config sidecar {sidecar}: {e}")
    model = TranscriptionModel(model_cfg or ModelConfig())
    load_torch_checkpoint(path, model.model)
    model.eval().to(device)
    return LoadedModel(model=model, audio_cfg=audio_cfg or AudioConfig())


def stitch_rolls(rolls: np.ndarray, hop_frames: int) -> np.ndarray:
    """(N, 88, T) per-chunk rolls from OVERLAPPING chunks -> (88, total) roll.

    Chunk i covers absolute frames [i*hop, i*hop + T). Each frame is taken
    from the chunk whose interior covers it: chunk i contributes
    [i*hop + lo, i*hop + T - hi) with lo = hi = (T - hop)//2 (first chunk
    keeps its left edge, last its right edge).
    """
    n, _, t = rolls.shape
    if hop_frames >= t or n == 1:
        return np.concatenate(list(rolls), axis=1)
    half = (t - hop_frames) // 2
    total = (n - 1) * hop_frames + t
    out = np.zeros((rolls.shape[1], total), rolls.dtype)
    for i in range(n):
        lo = 0 if i == 0 else half
        hi = t if i == n - 1 else t - (t - hop_frames - half)
        out[:, i * hop_frames + lo: i * hop_frames + hi] = rolls[i][:, lo:hi]
    return out


def _token_rolls(loaded: LoadedModel, chunks: np.ndarray, constrained: bool,
                 beam: int) -> np.ndarray:
    """AST: (N, chunk_samples) -> (N, 88, roll_frames_per_chunk) rolls, each
    decoded from ``max_output_len`` generated tokens and padded or cut to
    the chunk's frames."""
    max_t = loaded.audio_cfg.roll_frames_per_chunk
    device = next(loaded.model.parameters()).device
    with torch.inference_mode():
        y = torch.from_numpy(np.ascontiguousarray(chunks, dtype=np.float32)).to(device)
        rolls = loaded.model.predict(
            y, max_T=max_t, generate_max_len=loaded.model.config.max_output_len,
            constrained=constrained, **({"beam_size": beam} if beam > 1 else {})).numpy()
    out = np.zeros((rolls.shape[0], 88, max_t), np.float32)
    out[:, :, : rolls.shape[2]] = rolls[:, :, :max_t]
    return out


def replica_forward(replicas, chunks: np.ndarray, acfg: AudioConfig, fn) -> np.ndarray:
    """``fn(model, mel)`` over ``replicas``: (N, chunk_samples) padded to the
    next power of two for one replica (as the JAX package buckets a batch)
    and to a multiple of their count for several (as its mesh branch does), a
    contiguous block of rows each (its log-mel (k, 1, n_mels, T) on the
    replica's device), every block launched before any is copied back; the
    outputs of the N real rows, on the host."""
    n, r = chunks.shape[0], len(replicas)
    rows = 1 << max(n - 1, 0).bit_length() if r == 1 else n + -n % r
    padded = np.pad(np.asarray(chunks, np.float32), ((0, rows - n), (0, 0)))
    k = rows // r
    pending = []
    with torch.inference_mode():
        for i, model in enumerate(replicas):
            device = next(model.parameters()).device
            y = torch.from_numpy(np.ascontiguousarray(padded[i * k:(i + 1) * k])).to(device)
            pending.append(fn(model, log_mel_batch(y, acfg)[:, None]))
        out = [t.cpu().numpy() for t in pending]
    return np.concatenate(out)[:n]


def transcribe_chunks(loaded: LoadedModel, chunks: np.ndarray, threshold: float = 0.5,
                      hop_frames: int | None = None, constrained: bool = False,
                      beam: int = 1, replicas=None) -> np.ndarray:
    """(num_chunks, chunk_samples) -> (88, frames) binary roll.

    The chunks go through ``replica_forward`` on ``replicas`` (models on
    their devices, ``replicate_model``; default ``loaded``'s model alone):
    one replica pads the chunk count to the next power of two, as in the JAX
    package, so the same request sees the same batch (and so the same
    attention route) in both; several pad it to a multiple of their count
    and split it among them, as JAX's mesh branch does. With
    ``hop_frames`` the per-chunk rolls are stitched (``stitch_rolls``), else
    concatenated. AST checkpoints take the token route on ``loaded``'s
    device (no padding of the chunk count, ``threshold`` unused), with
    ``constrained`` and ``beam``.
    """
    if loaded.model.config.is_ast:
        return np.concatenate(list(_token_rolls(loaded, chunks, constrained, beam)), axis=1)
    rolls = replica_forward(replicas or [loaded.model], chunks, loaded.audio_cfg,
                            lambda model, mel: model.predict(mel, threshold))
    if hop_frames is not None:
        return stitch_rolls(rolls, hop_frames)
    return np.concatenate(list(rolls), axis=1)


class Transcriber:
    """Serving wrapper: load a checkpoint once (weights moved to the device
    at load, a replica on each of ``devices``), transcribe many recordings."""

    def __init__(self, checkpoint_path, model_cfg=None, audio_cfg=None,
                 threshold: float = 0.5, window: float | None = None, overlap: float = 0.0,
                 constrained: bool = False, beam: int = 1, device="cuda", devices=None):
        self.devices = serving_devices(device, devices)
        loaded = load_model(checkpoint_path, model_cfg=model_cfg, audio_cfg=audio_cfg,
                            device=self.devices[0])
        is_ast = loaded.model.config.is_ast
        if window is not None:
            if is_ast:
                raise ValueError(
                    "--window applies to CNN-RNN checkpoints; the AST tier "
                    "generates per trained chunk length")
            # Long-window mode: one forward over a larger T (--window 120 ->
            # T=3751 at the shipped geometry); the weights apply unchanged.
            loaded = LoadedModel(model=loaded.model, audio_cfg=dataclasses.replace(
                loaded.audio_cfg, chunk_length=float(window)))
        # "auto" keeps the materialized-scores attention at the 30 s window
        # and switches to the flash kernel for long windows.
        if not is_ast and loaded.model.config.attention_backend != "pallas":
            loaded.model.set_attention_backend("auto")
        self.loaded = loaded
        # the token route serves on the first device alone
        self.replicas = ([loaded.model] if is_ast
                         else replicate_model(loaded.model, self.devices))
        self.threshold = threshold
        if constrained and not is_ast:
            raise ValueError(
                "constrained decoding applies to AST checkpoints (token "
                "grammar masking); the CNN-RNN route thresholds frame probs")
        if beam > 1 and not is_ast:
            raise ValueError(
                "beam search applies to AST checkpoints (token decoding); "
                "the CNN-RNN route has no token hypotheses to rank")
        self.constrained = constrained
        self.beam = beam
        self.hop_samples = None
        self.hop_frames = None
        if overlap and overlap > 0.0:
            if is_ast:
                raise ValueError(
                    "overlap applies to CNN-RNN checkpoints (frame grid "
                    "stitching); the AST token route has no frame alignment")
            acfg = loaded.audio_cfg
            if not overlap < acfg.chunk_length:
                raise ValueError(
                    f"overlap ({overlap}s) must be smaller than the "
                    f"inference window ({acfg.chunk_length}s)")
            hop_s = acfg.chunk_samples - int(round(overlap * acfg.sample_rate))
            # snap the hop to the mel hop grid so chunk i's frame f IS
            # global frame i*hop_frames + f
            hop_s = max(acfg.hop_length, (hop_s // acfg.hop_length) * acfg.hop_length)
            self.hop_samples = hop_s
            self.hop_frames = hop_s // acfg.hop_length

    def split(self, y: np.ndarray) -> np.ndarray:
        return audio_io.split_into_chunks(np.asarray(y, np.float32),
                                          self.loaded.audio_cfg.chunk_samples,
                                          hop_samples=self.hop_samples)

    def transcribe_array(self, y: np.ndarray, threshold: float | None = None) -> list:
        """float mono audio at the model sample rate -> list[Note]."""
        roll = transcribe_chunks(
            self.loaded, self.split(y),
            threshold=self.threshold if threshold is None else threshold,
            hop_frames=self.hop_frames, constrained=self.constrained, beam=self.beam,
            replicas=self.replicas,
        )
        return midi_io.pianoroll_to_notes(roll, fs=self.loaded.audio_cfg.frame_rate)

    def transcribe_file(self, audio_path, output_path=None, threshold=None):
        y, _ = audio_io.load_audio(audio_path, sr=self.loaded.audio_cfg.sample_rate, mono=True)
        notes = self.transcribe_array(y, threshold=threshold)
        if output_path is None:
            output_path = os.path.splitext(str(audio_path))[0] + "_transcription.mid"
        midi_io.save_midi(midi_io.notes_to_midi(notes), output_path)
        return output_path


def transcribe_audio(
    audio_path,
    checkpoint_path,
    output_path=None,
    threshold: float = 0.5,
    model_cfg: ModelConfig | None = None,
    audio_cfg: AudioConfig | None = None,
    verbose: bool = True,
    window: float | None = None,
    overlap: float = 0.0,
    constrained: bool = False,
    beam: int = 1,
    device="cuda",
    devices=None,
):
    """Full pipeline. Returns the MIDI path. ``devices``: as ``Transcriber``'s."""

    def log(msg):
        if verbose:
            print(msg)

    server = Transcriber(
        checkpoint_path, model_cfg=model_cfg, audio_cfg=audio_cfg, threshold=threshold,
        window=window, overlap=overlap, constrained=constrained, beam=beam, device=device,
        devices=devices,
    )
    acfg = server.loaded.audio_cfg

    log(f"Loading audio from {audio_path}...")
    y, _ = audio_io.load_audio(audio_path, sr=acfg.sample_rate, mono=True)
    log(f"Audio duration: {len(y) / acfg.sample_rate:.2f} seconds")

    chunks = server.split(y)
    log(f"Split audio into {chunks.shape[0]} chunks of {acfg.chunk_length}s each"
        + (f" (hop {server.hop_samples / acfg.sample_rate:.2f}s, stitched)"
           if server.hop_samples else "")
        + (" (batched on device)" if len(server.replicas) == 1
           else f" (split over {len(server.replicas)} replicas)"))

    combined = transcribe_chunks(server.loaded, chunks, threshold=threshold,
                                 hop_frames=server.hop_frames, constrained=constrained,
                                 beam=beam, replicas=server.replicas)

    log("Converting to MIDI...")
    notes = midi_io.pianoroll_to_notes(combined, fs=acfg.frame_rate)
    if output_path is None:
        output_path = os.path.splitext(str(audio_path))[0] + "_transcription.mid"
    midi_io.save_midi(midi_io.notes_to_midi(notes), output_path)
    log(f"MIDI file saved to: {output_path}")
    return output_path
