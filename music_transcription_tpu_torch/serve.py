"""Serving daemon: transcribe recordings continuously with a resident model.

The port of the JAX package's ``scripts/serve.py``. The model loads once (a
replica on every visible card, as ``python -m music_transcription_tpu_torch``
holds them), then either

  * watch mode: poll a directory for new audio files and write MIDI next to
    them (or into --out_dir):

        python -m music_transcription_tpu_torch.serve --model model.pth \\
            --watch_dir incoming/ --out_dir done/ [--poll 2.0] [--once]

  * stdin mode: read audio paths on stdin, one a line, and print the output
    MIDI path of each (a backend for a queue worker):

        find . -name '*.wav' | python -m music_transcription_tpu_torch.serve \\
            --model model.pth --stdin

The flags are the JAX script's; ``--device`` takes ``cuda`` (the default:
the CLI exits 1 when no card is visible) or ``cpu``. A file that fails
prints ``ERROR <path>: ...`` on stderr and serving goes on; stdin mode exits
1 if any file failed. A request's chunk count is padded to the next power of
two (``transcribe.replica_forward``), so a server sees few batch shapes.
"""

import argparse
import os
import sys
import time

AUDIO_EXTS = (".wav", ".mp3", ".flac", ".ogg")


def build_parser():
    p = argparse.ArgumentParser(description="Resident transcription server")
    p.add_argument("--model", type=str, required=True, help="checkpoint (.pth + .json sidecar)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to serve on (default: cuda, a replica on every visible "
                        "card; fails when no GPU is visible)")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--watch_dir", type=str, help="poll this directory for audio files")
    mode.add_argument("--stdin", action="store_true", help="read audio paths from stdin")
    p.add_argument("--out_dir", type=str, default=None,
                   help="where MIDI goes (default: next to the input)")
    p.add_argument("--poll", type=float, default=2.0, help="watch-mode poll interval (s)")
    p.add_argument("--overlap", type=float, default=0.0,
                   help="chunk overlap in seconds (stitched interior-keep "
                        "inference, see the main CLI's --overlap)")
    p.add_argument("--constrained", action="store_true",
                   help="AST checkpoints only: grammar-constrained token "
                        "decoding (see the main CLI's --constrained)")
    p.add_argument("--beam", type=int, default=1,
                   help="AST checkpoints only: beam size for token "
                        "decoding (see the main CLI's --beam)")
    p.add_argument("--once", action="store_true",
                   help="watch mode: process what's there now, then exit")
    return p


def out_path(audio_path, out_dir):
    stem = os.path.splitext(os.path.basename(str(audio_path)))[0]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        return os.path.join(out_dir, stem + ".mid")
    return os.path.splitext(str(audio_path))[0] + ".mid"


def handle(server, path, out_dir) -> str | None:
    """Transcribe one file with ``server`` (a ``Transcriber``): print
    ``<path> -> <midi> (<s>s)`` and return the MIDI path, or print ``ERROR``
    on stderr and return None."""
    t0 = time.perf_counter()
    try:
        out = server.transcribe_file(path, out_path(path, out_dir))
    except Exception as e:  # keep serving on per-file failures
        print(f"ERROR {path}: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return None
    dt = time.perf_counter() - t0
    print(f"{path} -> {out} ({dt:.2f}s)", flush=True)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: CUDA is not available: no GPU is visible to PyTorch. "
              "Pass --device cpu to serve on the CPU.")
        return 1

    from music_transcription_tpu_torch.transcribe import Transcriber, serving_devices

    devices = [str(d) if d.type == "cpu" else f"{d} ({torch.cuda.get_device_name(d)})"
               for d in serving_devices(args.device)]
    print(f"Loading model from {args.model} (devices: {', '.join(devices)})...", flush=True)
    server = Transcriber(args.model, threshold=args.threshold, overlap=args.overlap,
                         constrained=args.constrained, beam=args.beam, device=args.device)

    if args.stdin:
        failed = 0
        for line in sys.stdin:
            path = line.strip()
            if path and handle(server, path, args.out_dir) is None:
                failed += 1
        return 1 if failed else 0

    # watch mode
    done: set[str] = set()
    print(f"Watching {args.watch_dir} (poll every {args.poll}s)...", flush=True)
    while True:
        try:
            names = sorted(os.listdir(args.watch_dir))
        except FileNotFoundError:
            print(f"Error: watch dir {args.watch_dir} does not exist", file=sys.stderr)
            return 1
        for name in names:
            path = os.path.join(args.watch_dir, name)
            if path in done or not name.lower().endswith(AUDIO_EXTS):
                continue
            if not os.path.exists(out_path(path, args.out_dir)):
                handle(server, path, args.out_dir)
            done.add(path)
        if args.once:
            return 0
        time.sleep(args.poll)


if __name__ == "__main__":
    sys.exit(main())
