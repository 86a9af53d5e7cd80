"""Visualization CLI: mel spectrogram + piano-roll overlays.

The port of the JAX package's ``scripts/visualize.py``, with its flags:

    # dataset sample: mel + ground-truth roll
    python -m music_transcription_tpu_torch.visualize sample --root_dir maestro-v3.0.0 --index 0

    # inference: mel + predicted roll (+ ground-truth overlay when MIDI given)
    python -m music_transcription_tpu_torch.visualize transcribe song.wav model.pth -o viz.png

    # MIDI -> engraved sheet music (needs music21 + MuseScore)
    python -m music_transcription_tpu_torch.visualize sheet song.mid

``transcribe`` runs the model on ``-d cuda`` (the default; exits 1 when no
card is visible) or ``-d cpu``; ``transcribe_rolls`` returns what it plots.
The plots need matplotlib, imported when a plot is drawn: without it
``sample`` and ``transcribe`` exit 1 and say so.
"""

import argparse
import os
import sys

PLOT_HINT = ("Error: plotting needs the optional 'matplotlib' package "
             "(pip install matplotlib).")


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _plot(mel, rolls: dict, out_path, fs: float, title=""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = 1 + len(rolls)
    fig, axes = plt.subplots(n, 1, figsize=(14, 3.2 * n), sharex=False)
    if n == 1:
        axes = [axes]
    t_mel = mel.shape[1] / fs
    axes[0].imshow(mel, aspect="auto", origin="lower", cmap="magma",
                   extent=[0, t_mel, 0, mel.shape[0]])
    axes[0].set_ylabel("mel bin")
    axes[0].set_title(title or "log-mel spectrogram")
    for ax, (name, roll) in zip(axes[1:], rolls.items()):
        t_roll = roll.shape[1] / fs
        ax.imshow(roll, aspect="auto", origin="lower", cmap="Greys",
                  extent=[0, t_roll, 21, 109], interpolation="nearest")
        ax.set_ylabel("MIDI pitch")
        ax.set_title(name)
    axes[-1].set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    print(f"Saved {out_path}")


def cmd_sample(args):
    from music_transcription_tpu_torch.config import AudioConfig
    from music_transcription_tpu_torch.data.maestro import MaestroDataset

    acfg = AudioConfig(n_mels=args.n_mels, chunk_length=args.chunk_length)
    ds = MaestroDataset(args.root_dir, split=args.split,
                        chunk_length=args.chunk_length, audio_cfg=acfg)
    mel, roll = ds[args.index]
    out = args.output or f"sample_{args.split}_{args.index}.png"
    _plot(mel, {"ground-truth piano roll": roll}, out, acfg.frame_rate,
          title=f"{args.split}[{args.index}]")
    return 0


def transcribe_rolls(loaded, audio_file, threshold: float = 0.5, reference_midi=None):
    """The arrays ``transcribe`` plots, for ``loaded`` (a ``LoadedModel``):
    (log-mel (n_mels, T) of the whole recording, {"predicted piano roll":
    (88, T) [, "ground-truth piano roll": (88, T)]}). The roll comes from
    ``transcribe_chunks`` on the model's device, the mel from the host's
    ``log_mel_numpy``."""
    from music_transcription_tpu_torch.data import audio as audio_io
    from music_transcription_tpu_torch.data import midi as midi_io
    from music_transcription_tpu_torch.ops.mel import log_mel_numpy
    from music_transcription_tpu_torch.transcribe import transcribe_chunks

    acfg = loaded.audio_cfg
    y, _ = audio_io.load_audio(audio_file, sr=acfg.sample_rate, mono=True)
    chunks = audio_io.split_into_chunks(y, acfg.chunk_samples)
    pred = transcribe_chunks(loaded, chunks, threshold=threshold)
    mel = log_mel_numpy(y, acfg)
    rolls = {"predicted piano roll": pred[:, : mel.shape[1]]}
    if reference_midi:
        mf = midi_io.load_midi(reference_midi)
        rolls["ground-truth piano roll"] = mf.keys_roll(fs=acfg.frame_rate)[:, : mel.shape[1]]
    return mel, rolls


def cmd_transcribe(args):
    import torch

    from music_transcription_tpu_torch.transcribe import load_model

    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: CUDA is not available: no GPU is visible to PyTorch. "
              "Pass -d cpu to transcribe on the CPU.")
        return 1
    loaded = load_model(args.model_file, device=args.device)
    mel, rolls = transcribe_rolls(loaded, args.audio_file, args.threshold, args.reference_midi)
    out = args.output or os.path.splitext(args.audio_file)[0] + "_viz.png"
    _plot(mel, rolls, out, loaded.audio_cfg.frame_rate, title=os.path.basename(args.audio_file))
    return 0


def cmd_sheet(args):
    """MIDI -> engraved sheet-music PNG via music21 + MuseScore. Both tools
    are optional, so the path is guarded: it runs when they are installed
    and fails with install instructions when not."""
    try:
        from music21 import converter, environment
    except ImportError:
        print("Error: sheet-music rendering needs the optional 'music21' "
              "package (pip install music21) plus MuseScore "
              "(apt-get install musescore).")
        return 1

    if args.musescore:
        us = environment.UserSettings()
        us["musescoreDirectPNGPath"] = args.musescore
        us["musicxmlPath"] = args.musescore
    else:
        for cand in ("/usr/bin/mscore", "/usr/bin/musescore3", "/usr/bin/musescore"):
            if os.path.exists(cand):
                us = environment.UserSettings()
                us["musescoreDirectPNGPath"] = cand
                us["musicxmlPath"] = cand
                break

    score = converter.parse(args.midi_file)
    try:
        png_path = str(score.write("musicxml.png"))
    except Exception as exc:
        print(f"Error: MuseScore rendering failed ({exc}). Install MuseScore "
              f"or pass --musescore /path/to/mscore.")
        return 1
    out = args.output or os.path.splitext(args.midi_file)[0] + "_sheet.png"
    if png_path != out:
        import shutil

        shutil.copyfile(png_path, out)
    print(f"Sheet music written to {out}")
    return 0


def build_parser():
    p = argparse.ArgumentParser(description="Visualize mel spectrograms and piano rolls")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("sample", help="plot a dataset sample (mel + ground-truth roll)")
    s.add_argument("--root_dir", type=str, default="maestro-v3.0.0")
    s.add_argument("--split", type=str, default="train")
    s.add_argument("--index", type=int, default=0)
    s.add_argument("--n_mels", type=int, default=320)
    s.add_argument("--chunk_length", type=float, default=30.0)
    s.add_argument("-o", "--output", type=str, default=None)

    t = sub.add_parser("transcribe", help="transcribe + plot mel/predicted roll")
    t.add_argument("audio_file", type=str)
    t.add_argument("model_file", type=str)
    t.add_argument("--reference_midi", type=str, default=None)
    t.add_argument("-t", "--threshold", type=float, default=0.5)
    t.add_argument("-o", "--output", type=str, default=None)
    t.add_argument("-d", "--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to transcribe on (default: cuda; fails when no GPU is visible)")

    sh = sub.add_parser("sheet", help="render MIDI as engraved sheet music "
                                      "(requires optional music21 + MuseScore)")
    sh.add_argument("midi_file", type=str)
    sh.add_argument("-o", "--output", type=str, default=None)
    sh.add_argument("--musescore", type=str, default=None,
                    help="path to the MuseScore binary (autodetected when omitted)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "sheet":
        return cmd_sheet(args)
    if not _have_matplotlib():
        print(PLOT_HINT)
        return 1
    if args.cmd == "sample":
        return cmd_sample(args)
    return cmd_transcribe(args)


if __name__ == "__main__":
    sys.exit(main())
