"""Inference CLI: transcribe an audio file to MIDI on a CUDA card.

    python -m music_transcription_tpu_torch song.wav model.pth [-o out.mid] [-t 0.5]
        [-w SECONDS] [--overlap SECONDS] [--beam N] [--constrained] [-d cuda|cpu]

``model.pth`` is a reference-format state_dict; an ``X.json`` sidecar beside
``X.pth`` carries the model and audio config (else the shipped
cnn_rnn_large / n_mels=320 defaults apply); an AST sidecar selects the
token route, where ``--beam`` and ``--constrained`` apply. The flags and messages are
those of the JAX package's ``main.py``; ``-d`` takes ``cuda`` (the default:
a model replica on every visible card, each request's chunks split among
them; ``CUDA_VISIBLE_DEVICES`` picks the cards) or ``cpu``.
"""

import argparse
import os
import sys


def main():
    parser = argparse.ArgumentParser(
        description="Transcribe audio files to MIDI using a trained transcription model"
    )
    parser.add_argument("audio_file", type=str, help="Path to input audio file (wav)")
    parser.add_argument("model_file", type=str, help="Path to model checkpoint (.pth)")
    parser.add_argument("-o", "--output", type=str, default=None, help="Output MIDI path")
    parser.add_argument(
        "-d", "--device", type=str, choices=["cuda", "cpu"], default="cuda",
        help="Device to run on (default: cuda; fails when no GPU is visible)",
    )
    parser.add_argument(
        "-t", "--threshold", type=float, default=0.5, help="Note prediction threshold"
    )
    parser.add_argument(
        "-w", "--window", type=float, default=None,
        help="Inference window in seconds (default: the checkpoint's chunk "
             "length, 30 s). Long windows (e.g. 120) run as one forward per "
             "window, with the clamped flash-attention kernel once the score "
             "tensor is large: no chunk boundaries bisect sustained notes.",
    )
    parser.add_argument(
        "--overlap", type=float, default=0.0,
        help="Chunk overlap in seconds (e.g. 4). Chunks are run overlapped "
             "and each output frame is taken from a window where it sits in "
             "the interior, removing chunk-seam artifacts. 0 = "
             "non-overlapping chunks.",
    )
    parser.add_argument(
        "--beam", type=int, default=1,
        help="AST checkpoints only: beam size for token generation (default "
             "1 = greedy). Vectorized beam search with GNMT length "
             "normalization; composes with --constrained.",
    )
    parser.add_argument(
        "--constrained", action="store_true",
        help="AST checkpoints only: grammar-constrained decoding (logits "
             "masked by the tokenizer's transition table, so generation "
             "can only emit sequences the encoder could produce).",
    )
    args = parser.parse_args()
    if args.overlap and args.window:
        print("Error: --overlap and --window are alternative seam "
              "strategies; pass one.")
        sys.exit(1)
    if not os.path.exists(args.audio_file):
        print(f"Error: Audio file not found: {args.audio_file}")
        sys.exit(1)
    if not os.path.exists(args.model_file):
        print(f"Error: Model file not found: {args.model_file}")
        sys.exit(1)

    import torch

    from music_transcription_tpu_torch.transcribe import serving_devices, transcribe_audio

    print("=" * 60)
    print("Music Transcription Pipeline (PyTorch/CUDA)")
    print("=" * 60)
    if args.device == "cuda" and torch.cuda.is_available():
        # a replica on every visible card (CUDA_VISIBLE_DEVICES narrows them)
        names = [f"{d} ({torch.cuda.get_device_name(d)})" for d in serving_devices("cuda")]
        print(f"Device: {args.device}: {', '.join(names)}")
    else:
        print(f"Device: {args.device}")

    try:
        output_path = transcribe_audio(
            args.audio_file, args.model_file, args.output,
            threshold=args.threshold, window=args.window,
            overlap=args.overlap, constrained=args.constrained,
            beam=args.beam, device=args.device,
        )
        print("=" * 60)
        print("Transcription completed successfully!")
        print(f"Output: {output_path}")
        print("=" * 60)
    except Exception as e:  # CLI boundary: report, print the traceback, exit 1
        print(f"Error during transcription: {e}")
        import traceback

        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
