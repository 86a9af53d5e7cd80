"""REMI-style tokenizer for the experimental AST tier (host, numpy).

The port's own copy of the JAX package's ``models/remi_tokenizer.py``, with
the same vocabulary and the same tokens for the same roll; preprocessing's
``--tokenize`` stores them.

Deterministic small vocabulary identical to the reference
(reference models/remi_tokenizer.py:4-169):

  0 <sos>, 1 <eos>, 2 <pad>
  10..97    NOTE_ON_0..87
  110..197  NOTE_OFF_0..87
  210..242  VELOCITY_0..32
  300..399  TIME_SHIFT_1..100 (frames, run-length merged)

Encoding walks frames emitting NOTE_ON(p)+VELOCITY(0) on 0->1 transitions,
NOTE_OFF(p) on 1->0, then a (merged) TIME_SHIFT; sequences carry <sos>/<eos>
and pad/truncate to max_len. Out-of-vocab ids clamp to <pad>
(reference models/remi_tokenizer.py:47-55). Decoding replays the events into
an (88, T) roll and returns the written prefix.
"""

from __future__ import annotations

import numpy as np


class REMITokenizer:
    def __init__(self, vocab_size: int = 512, max_time_shift: int = 100):
        self.vocab_size = vocab_size
        self.sos = 0
        self.eos = 1
        self.pad = 2
        self.note_on_base = 10
        self.note_off_base = 110
        self.velocity_base = 210
        self.time_shift_base = 300
        self.max_time_shift = max_time_shift

    # ------------------------------------------------------------ token ids
    def _safe_id(self, idx: int) -> int:
        if idx < 0 or idx >= self.vocab_size:
            return self.pad
        return int(idx)

    def note_on_id(self, pitch: int) -> int:
        return self._safe_id(self.note_on_base + int(pitch))

    def note_off_id(self, pitch: int) -> int:
        return self._safe_id(self.note_off_base + int(pitch))

    def velocity_id(self, vel_idx: int) -> int:
        return self._safe_id(self.velocity_base + int(vel_idx))

    def time_shift_id(self, frames: int) -> int:
        frames = max(1, min(self.max_time_shift, int(frames)))
        return self._safe_id(self.time_shift_base + (frames - 1))

    def note_token_mask(self) -> np.ndarray:
        """(V,) bool — True on the NOTE_ON/NOTE_OFF ids ``encode`` can emit
        (pitches 0..87). The per-class weight mask behind train_ast's
        ``--pitch_loss_weight``."""
        m = np.zeros(self.vocab_size, bool)
        m[self.note_on_base:self.note_on_base + 88] = True
        m[self.note_off_base:self.note_off_base + 88] = True
        return m

    # -------------------------------------------------------------- grammar
    def transition_mask(self) -> np.ndarray:
        """(V, V) bool successor table of the encoder's grammar.

        ``mask[prev, nxt]`` is True iff ``nxt`` may follow ``prev`` in any
        sequence ``encode_from_pianoroll`` can emit: NOTE_ON -> VELOCITY;
        VELOCITY -> {NOTE_ON, NOTE_OFF, TIME_SHIFT}; NOTE_OFF -> {NOTE_OFF,
        TIME_SHIFT} (ons precede offs inside a frame group); TIME_SHIFT ->
        {NOTE_ON, NOTE_OFF, TIME_SHIFT, EOS} (EOS always follows a shift);
        <sos> -> {NOTE_ON, TIME_SHIFT, EOS} (no offs from the all-zero
        state; a zero-frame roll encodes to [sos, eos]);
        <eos>/<pad> -> <pad>. Rows for gap ids (unreachable under the
        grammar) stay all-False. Used for grammar-constrained decoding
        (TranscriptionTransformer.generate ``allowed_next``)."""
        v = self.vocab_size
        on = np.zeros(v, bool)
        on[self.note_on_base:self.note_on_base + 88] = True
        off = np.zeros(v, bool)
        off[self.note_off_base:self.note_off_base + 88] = True
        vel = np.zeros(v, bool)
        vel[self.velocity_base:self.velocity_base + 33] = True
        shift = np.zeros(v, bool)
        shift[self.time_shift_base:self.time_shift_base + self.max_time_shift] = True

        mask = np.zeros((v, v), bool)
        mask[self.sos] = on | shift
        mask[self.sos, self.eos] = True
        mask[on] = vel
        mask[vel] = on | off | shift
        mask[off] = off | shift
        mask[shift] = on | off | shift
        mask[shift, self.eos] = True
        mask[self.eos, self.pad] = True
        mask[self.pad, self.pad] = True
        return mask

    # --------------------------------------------------------------- encode
    def encode_from_pianoroll(self, piano_roll, frame_rate: int = 100, max_len: int = 256):
        """(88, T) or (T, 88) roll -> token id list of length max_len."""
        pr = np.asarray(piano_roll, dtype=np.float32)
        if pr.ndim != 2:
            raise ValueError("piano_roll must be 2-D")
        if pr.shape[0] == 88:
            pr = pr.T  # -> (T, 88)
        t_total, p = pr.shape
        if p != 88:
            raise ValueError("piano_roll must have 88 pitches")

        active = pr > 0.5
        seq = [self.sos]
        prev = np.zeros(88, dtype=bool)
        t = 0
        while t < t_total:
            frame = active[t]
            ons = frame & ~prev
            offs = ~frame & prev
            for pitch in np.nonzero(ons)[0]:
                seq.append(self.note_on_id(pitch))
                seq.append(self.velocity_id(0))
            for pitch in np.nonzero(offs)[0]:
                seq.append(self.note_off_id(pitch))

            # merge consecutive change-free frames into one TIME_SHIFT
            num_frames = 1
            if not (ons.any() or offs.any()) and t + 1 < t_total:
                while t + num_frames < t_total and num_frames < self.max_time_shift:
                    nxt = active[t + num_frames]
                    if (nxt & ~frame).any() or (~nxt & frame).any():
                        break
                    num_frames += 1
                    frame = nxt
            seq.append(self.time_shift_id(num_frames))
            prev = frame
            t += num_frames
            if len(seq) >= max_len - 1:
                break

        seq.append(self.eos)
        if len(seq) < max_len:
            seq += [self.pad] * (max_len - len(seq))
        return seq[:max_len]

    # --------------------------------------------------------------- decode
    def decode_to_pianoroll(self, tokens, max_t: int = 1024) -> np.ndarray:
        """Token ids -> (88, t_written) float32 roll."""
        pr = np.zeros((88, max_t), dtype=np.float32)
        t = 0
        active: set[int] = set()
        for tok in tokens:
            tok = int(tok)
            if t >= max_t or tok == self.eos:
                break
            if tok == self.sos:
                continue
            if self.note_on_base <= tok < self.note_off_base:
                pitch = tok - self.note_on_base
                if pitch < 88:  # ids 98..109 decode to pitches >= 88: ignore
                    active.add(pitch)
                    pr[pitch, t] = 1.0
            elif self.note_off_base <= tok < self.velocity_base:
                active.discard(tok - self.note_off_base)
            elif self.time_shift_base <= tok < self.time_shift_base + self.max_time_shift:
                frames = (tok - self.time_shift_base) + 1
                for _ in range(frames):
                    if t >= max_t:
                        break
                    for pitch in active:
                        pr[pitch, t] = 1.0
                    t += 1
            # velocity / unknown tokens: skip
        return pr[:, :t]
