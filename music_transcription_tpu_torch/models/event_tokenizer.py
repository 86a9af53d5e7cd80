"""Event-based MIDI tokenizer (NOTE_ON / NOTE_OFF / TIME_SHIFT) for the
experimental AST tier (host, numpy).

The port's own copy of the JAX package's ``models/event_tokenizer.py``, with
the same vocabulary, grammar table and decode, on the port's ``data/midi``
types. Vocabulary:

    0: <sos>   1: <eos>   2: <pad>
    10..137    NOTE_ON(pitch)    (MIDI pitch 0..127)
    160..287   NOTE_OFF(pitch)
    320..419   TIME_SHIFT(k)     (k = 1..max_time_shift frames @ frame_rate)

Events are encoded straight from note timings (sub-frame onsets round to the
frame grid once), pitches are real MIDI numbers (not 88-key roll indices),
and there are no velocity tokens. ``encode_from_pianoroll`` /
``decode_to_pianoroll`` are the roll bridge shared with ``REMITokenizer``.
"""

from __future__ import annotations

import numpy as np

from music_transcription_tpu_torch.config import MIN_MIDI, NUM_KEYS
from music_transcription_tpu_torch.data.midi import Instrument, MidiFile, Note


class EventMIDITokenizer:
    def __init__(self, vocab_size: int = 512, frame_rate: float = 100,
                 max_time_shift: int = 100):
        # frame_rate accepts floats (the repo's roll grid is 31.25 fps,
        # AudioConfig.frame_rate) — the reference notebook used int 100.
        self.vocab_size = int(vocab_size)
        self.frame_rate = float(frame_rate)
        self.max_time_shift = int(max_time_shift)

        self.sos = 0
        self.eos = 1
        self.pad = 2

        # reference keeps gaps between ranges "for safety/readability"
        self.note_on_base = 10     # 10..137
        self.note_off_base = 160   # 160..287
        self.time_shift_base = 320  # 320..(320+max_time_shift-1)

        needed = self.time_shift_base + self.max_time_shift
        if needed > self.vocab_size:
            raise ValueError(
                f"vocab_size too small; need >= {needed}, got {self.vocab_size}"
            )

    def note_token_mask(self):
        """(V,) bool — True on the NOTE_ON/NOTE_OFF ids (128 MIDI pitches
        each). The per-class weight mask behind train_ast's
        ``--pitch_loss_weight``."""
        m = np.zeros(self.vocab_size, bool)
        m[self.note_on_base:self.note_on_base + 128] = True
        m[self.note_off_base:self.note_off_base + 128] = True
        return m

    # -------------------------------------------------------------- grammar
    def transition_mask(self):
        """(V, V) bool successor table of ``encode_notes``'s grammar.

        Looser than REMI's: events carry no velocity and truncation may cut
        the stream anywhere, so any of {NOTE_ON, NOTE_OFF, TIME_SHIFT, EOS}
        may follow an event token. <sos> -> {NOTE_ON, TIME_SHIFT, EOS} (a
        frame-0 event is necessarily an on — offs land at frame >= on+1 —
        and an empty note list encodes to [sos, eos]);
        <eos>/<pad> -> <pad>. Gap ids (138..159, 288..319, tail) keep
        all-False rows. For grammar-constrained decoding
        (``ASTTranscriber.generate``'s ``allowed_next``)."""
        v = self.vocab_size
        on = np.zeros(v, bool)
        on[self.note_on_base:self.note_on_base + 128] = True
        off = np.zeros(v, bool)
        off[self.note_off_base:self.note_off_base + 128] = True
        shift = np.zeros(v, bool)
        shift[self.time_shift_base:self.time_shift_base + self.max_time_shift] = True

        mask = np.zeros((v, v), bool)
        event = on | off | shift
        mask[self.sos] = on | shift
        mask[self.sos, self.eos] = True
        mask[event] = event
        mask[event, self.eos] = True
        mask[self.eos, self.pad] = True
        mask[self.pad, self.pad] = True
        return mask

    # ------------------------------------------------------------ token ids
    def note_on_id(self, pitch: int) -> int:
        return self.note_on_base + int(pitch)

    def note_off_id(self, pitch: int) -> int:
        return self.note_off_base + int(pitch)

    def time_shift_id(self, k: int) -> int:
        k = int(max(1, min(self.max_time_shift, k)))
        return self.time_shift_base + (k - 1)

    def is_note_on(self, tok: int) -> bool:
        return self.note_on_base <= tok < self.note_on_base + 128

    def is_note_off(self, tok: int) -> bool:
        return self.note_off_base <= tok < self.note_off_base + 128

    def is_time_shift(self, tok: int) -> bool:
        return self.time_shift_base <= tok < self.time_shift_base + self.max_time_shift

    def tok_to_pitch(self, tok: int) -> int:
        if self.is_note_on(tok):
            return tok - self.note_on_base
        if self.is_note_off(tok):
            return tok - self.note_off_base
        raise ValueError("Not a pitch token")

    def tok_to_shift(self, tok: int) -> int:
        return (tok - self.time_shift_base) + 1

    # --------------------------------------------------------------- encode
    def encode_notes(self, notes, max_len: int = 512) -> list[int]:
        """(pitch, start_s, end_s) triples or data/midi Note objects -> ids.

        Reference semantics (cell 5 ``encode_pretty_midi``): events sort by
        (frame, OFF-before-ON); zero-length notes get a one-frame floor;
        TIME_SHIFTs split at max_time_shift; truncation keeps room for <eos>;
        output is padded to exactly ``max_len``.
        """
        events: list[tuple[int, int, int]] = []  # (frame, kind 0=off/1=on, pitch)
        for n in notes:
            pitch, start, end = (
                (n.pitch, n.start, n.end) if isinstance(n, Note) else n
            )
            on_f = int(round(start * self.frame_rate))
            off_f = int(round(end * self.frame_rate))
            if off_f <= on_f:
                off_f = on_f + 1
            pitch = int(pitch)
            if 0 <= pitch <= 127:
                events.append((on_f, 1, pitch))
                events.append((off_f, 0, pitch))
        events.sort(key=lambda x: (x[0], x[1]))

        seq = [self.sos]
        cur_f = 0

        def emit_shift(delta: int):
            while delta > 0 and len(seq) < max_len - 1:
                k = min(self.max_time_shift, delta)
                seq.append(self.time_shift_id(k))
                delta -= k

        for f, kind, pitch in events:
            if len(seq) >= max_len - 1:
                break
            delta = f - cur_f
            if delta > 0:
                emit_shift(delta)
                cur_f = f
            if len(seq) >= max_len - 1:
                break
            seq.append(self.note_off_id(pitch) if kind == 0 else self.note_on_id(pitch))

        seq.append(self.eos)
        if len(seq) < max_len:
            seq += [self.pad] * (max_len - len(seq))
        return seq[:max_len]

    def encode_midi(self, midi, max_len: int = 512) -> list[int]:
        """Path or MidiFile -> token ids (all non-drum instruments)."""
        if not isinstance(midi, MidiFile):
            from music_transcription_tpu_torch.data.midi import load_midi

            midi = load_midi(midi)
        notes = [
            n for inst in midi.instruments if not inst.is_drum for n in inst.notes
        ]
        return self.encode_notes(notes, max_len=max_len)

    def encode_from_pianoroll(self, piano_roll, frame_rate: float | None = None,
                              max_len: int = 512) -> list[int]:
        """(88, T) or (T, 88) roll -> ids, via roll-transition note events.

        Bridge for the AST training pipeline (same interface as
        REMITokenizer): roll row r maps to MIDI pitch MIN_MIDI + r.
        """
        from music_transcription_tpu_torch.data.midi import pianoroll_to_notes

        fr = self.frame_rate if frame_rate is None else float(frame_rate)
        pr = np.asarray(piano_roll, dtype=np.float32)
        if pr.ndim != 2:
            raise ValueError("piano_roll must be 2-D")
        if pr.shape[1] == NUM_KEYS and pr.shape[0] != NUM_KEYS:
            pr = pr.T  # (T, 88) -> (88, T)
        if pr.shape[0] != NUM_KEYS:
            raise ValueError("piano_roll must have 88 pitches")
        # canonical vectorized transition scan (roll row r <-> MIDI MIN_MIDI+r)
        notes = pianoroll_to_notes(pr > 0.5, fs=fr)
        return self.encode_notes(notes, max_len=max_len)

    # --------------------------------------------------------------- decode
    def decode_to_notes(self, tokens) -> list[Note]:
        """ids -> data/midi Notes (reference ``decode_to_pretty_midi`` body:
        skip sos/pad, stop at eos, ignore re-onsets of active pitches, close
        hanging notes at the final cursor, one-frame minimum duration)."""
        t_f = 0
        active: dict[int, int] = {}
        notes: list[Note] = []

        def close(pitch: int, start_f: int, end_f: int):
            start = start_f / self.frame_rate
            end = max(end_f / self.frame_rate, start + 1.0 / self.frame_rate)
            notes.append(Note(pitch=pitch, start=start, end=end, velocity=80))

        for tok in tokens:
            tok = int(tok)
            if tok in (self.sos, self.pad):
                continue
            if tok == self.eos:
                break
            if self.is_time_shift(tok):
                t_f += self.tok_to_shift(tok)
            elif self.is_note_on(tok):
                p = self.tok_to_pitch(tok)
                if p not in active:  # re-onset of an active pitch: ignore
                    active[p] = t_f
            elif self.is_note_off(tok):
                p = self.tok_to_pitch(tok)
                if p in active:
                    close(p, active.pop(p), t_f)
            # unknown ids: skip
        for p, start_f in active.items():
            close(p, start_f, t_f)
        notes.sort(key=lambda n: (n.start, n.pitch))
        return notes

    def decode_to_midi(self, tokens, out_path=None) -> MidiFile:
        """ids -> MidiFile (optionally written to ``out_path``)."""
        midi = MidiFile(instruments=[Instrument(program=0, notes=self.decode_to_notes(tokens))])
        if out_path is not None:
            from music_transcription_tpu_torch.data.midi import save_midi

            save_midi(midi, out_path)
        return midi

    def decode_to_pianoroll(self, tokens, max_t: int = 1024) -> np.ndarray:
        """ids -> (88, t) roll (REMITokenizer-compatible bridge).

        Width covers the time cursor AND every decoded note's end frame
        (hanging notes close one frame past the cursor), capped at max_t.
        """
        notes = self.decode_to_notes(tokens)
        t_end = 0
        for tok in tokens:
            tok = int(tok)
            if tok == self.eos:
                break
            if self.is_time_shift(tok):
                t_end += self.tok_to_shift(tok)
        for n in notes:
            t_end = max(t_end, int(round(n.end * self.frame_rate)))
        t_end = min(int(t_end), max_t)
        pr = np.zeros((NUM_KEYS, t_end), dtype=np.float32)
        for n in notes:
            r = n.pitch - MIN_MIDI
            if 0 <= r < NUM_KEYS:
                a = int(round(n.start * self.frame_rate))
                b = int(round(n.end * self.frame_rate))
                pr[r, a : max(b, a + 1)] = 1.0
        return pr
