"""Standard MIDI File I/O and piano-roll conversion (host side, numpy).

The port's own copy of ``music_transcription_tpu.data.midi``:

  * parse .mid/.midi files (format 0/1, running status, tempo map)
  * ``MidiFile.piano_roll(fs, times)`` with pretty_midi semantics, including
    CC64 sustain-pedal extension (running-max while the pedal is down)
  * write a note list back to a .mid file
  * ``pianoroll_to_notes``: the transition-scan decode (velocity 100,
    frame index / fs timing), vectorized over all 88 pitches
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from music_transcription_tpu_torch.config import MIN_MIDI, NUM_KEYS

_SUSTAIN_CC = 64


@dataclass
class Note:
    pitch: int
    start: float  # seconds
    end: float  # seconds
    velocity: int = 100


@dataclass
class ControlChange:
    number: int
    value: int
    time: float  # seconds


@dataclass
class Instrument:
    program: int = 0
    is_drum: bool = False
    notes: list[Note] = field(default_factory=list)
    control_changes: list[ControlChange] = field(default_factory=list)


@dataclass
class MidiFile:
    instruments: list[Instrument] = field(default_factory=list)
    resolution: int = 480

    # ------------------------------------------------------------------ util
    def end_time(self) -> float:
        ends = [n.end for inst in self.instruments for n in inst.notes]
        ccs = [c.time for inst in self.instruments for c in inst.control_changes]
        return max(ends + ccs, default=0.0)

    # ------------------------------------------------------- piano-roll path
    def piano_roll(
        self,
        fs: float = 100.0,
        times: np.ndarray | None = None,
        pedal_threshold: int | None = 64,
    ) -> np.ndarray:
        """128-pitch piano roll, summed over non-drum instruments.

        Matches pretty_midi.PrettyMIDI.get_piano_roll: each note adds its
        velocity to columns int(start*fs):int(end*fs); while the sustain pedal
        (CC64 >= threshold) is held, each pitch retains its running-max
        velocity; with ``times`` given, output frame n is the mean of columns
        round(times[n]*fs):round(times[n+1]*fs) (the final frame is left 0).
        """
        rolls = [
            _instrument_roll(inst, fs=fs, times=times, pedal_threshold=pedal_threshold)
            for inst in self.instruments
            if not inst.is_drum
        ]
        if not rolls:
            n_cols = 0 if times is None else len(times)
            return np.zeros((128, n_cols))
        width = max(r.shape[1] for r in rolls)
        out = np.zeros((128, width))
        for r in rolls:
            out[:, : r.shape[1]] += r
        return out

    def keys_roll(self, fs: float, times: np.ndarray | None = None) -> np.ndarray:
        """Binarized 88-key roll, sliced [MIN_MIDI : MIN_MIDI+88] and > 0
        (reference data/dataset.py:141-146)."""
        full = self.piano_roll(fs=fs, times=times)
        return (full[MIN_MIDI : MIN_MIDI + NUM_KEYS] > 0).astype(np.float32)


def _fill_roll(notes, fs: float, n_cols: int) -> np.ndarray:
    """Velocity-summed note fill."""
    roll = np.zeros((128, n_cols))
    for n in notes:
        roll[n.pitch, int(n.start * fs) : int(n.end * fs)] += n.velocity
    return roll


def _instrument_roll(inst, fs, times, pedal_threshold):
    if not inst.notes:
        n_cols = 0 if times is None else len(times)
        return np.zeros((128, n_cols))
    end_time = max(n.end for n in inst.notes)
    if times is not None and len(times) and times[-1] > end_time:
        end_time = float(times[-1])
    n_cols = int(fs * end_time)
    roll = _fill_roll(inst.notes, fs, n_cols)

    if pedal_threshold is not None:
        # pretty_midi applies the running-max only on pedal on->off
        # transitions; a sustain-on that never receives a pedal-off is
        # silently dropped (no tail extension) — matched here because the
        # reference's MAESTRO training targets were produced this way.
        pedal_on_at = 0
        is_on = False
        for cc in inst.control_changes:
            if cc.number != _SUSTAIN_CC:
                continue
            t = int(cc.time * fs)
            now_on = cc.value >= pedal_threshold
            if not is_on and now_on:
                pedal_on_at, is_on = t, True
            elif is_on and not now_on:
                seg = roll[:, pedal_on_at:t]
                roll[:, pedal_on_at:t] = np.maximum.accumulate(seg, axis=1)
                is_on = False

    if times is None:
        return roll
    cols = np.round(np.asarray(times) * fs).astype(np.int64)
    out = np.zeros((128, len(cols)))
    for i, (a, b) in enumerate(zip(cols[:-1], cols[1:])):
        if 0 <= a < n_cols:
            if b == a:  # pretty_midi widens empty spans to one column
                b = a + 1
            out[:, i] = roll[:, a:b].mean(axis=1)
    return out


# ---------------------------------------------------------------------------
# Roll -> notes (the inference decode, reference main.py:189-226)
# ---------------------------------------------------------------------------


def pianoroll_to_notes(
    roll: np.ndarray, fs: float, min_midi: int = MIN_MIDI, velocity: int = 100
) -> list[Note]:
    """Decode a binary (88, T) roll into Note events.

    Vectorized transition scan over all pitches at once: pad each row with 0
    at both ends, diff, +1 = onset frame, -1 = offset frame; note spans
    [onset/fs, offset/fs). Equivalent to the per-pitch loop at reference
    main.py:204-223 (velocity fixed at 100, main.py:217).
    """
    active = (np.asarray(roll) > 0).astype(np.int8)
    padded = np.zeros((active.shape[0], active.shape[1] + 2), dtype=np.int8)
    padded[:, 1:-1] = active
    changes = np.diff(padded, axis=1)
    pitches, onsets = np.nonzero(changes == 1)
    pitches_off, offsets = np.nonzero(changes == -1)
    # Onsets/offsets pair up in order within each pitch row because activity
    # alternates; nonzero returns row-major order so the k-th event of each
    # pitch lines up between the two lists.
    assert len(pitches) == len(pitches_off)
    notes = []
    for p, on, off in zip(pitches, onsets, offsets):
        start, end = on / fs, off / fs
        if end > start:
            notes.append(Note(pitch=min_midi + int(p), start=start, end=end, velocity=velocity))
    notes.sort(key=lambda n: (n.start, n.pitch))
    return notes


def notes_to_midi(notes: list[Note], program: int = 0) -> MidiFile:
    inst = Instrument(program=program, notes=list(notes))
    return MidiFile(instruments=[inst])


# ---------------------------------------------------------------------------
# SMF parsing
# ---------------------------------------------------------------------------


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def load_midi(path) -> MidiFile:
    """Parse a Standard MIDI File (format 0 or 1) into a MidiFile.

    Tempo changes from any track apply globally (format-1 semantics); tick
    times are converted to seconds through the tempo map. note_on with
    velocity 0 is treated as note_off.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"{path}: not a Standard MIDI File")
    hlen = struct.unpack(">I", data[4:8])[0]
    fmt, ntrks, division = struct.unpack(">HHH", data[8:14])
    if fmt not in (0, 1):
        raise ValueError(
            f"{path}: SMF format {fmt} is not supported (independent-sequence "
            f"format-2 files have per-track tempo maps)"
        )
    if division & 0x8000:
        raise ValueError("SMPTE time division is not supported")
    pos = 8 + hlen

    # Pass 1: collect raw events (tick, kind, payload) per track.
    tracks = []
    tempo_events = []  # (tick, us_per_quarter)
    for _ in range(ntrks):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        tlen = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        tdata = data[pos + 8 : pos + 8 + tlen]
        pos += 8 + tlen
        events = []
        tick = 0
        i = 0
        running = None
        while i < len(tdata):
            delta, i = _read_varlen(tdata, i)
            tick += delta
            status = tdata[i]
            if status == 0xFF:  # meta
                meta_type = tdata[i + 1]
                length, j = _read_varlen(tdata, i + 2)
                payload = tdata[j : j + length]
                i = j + length
                if meta_type == 0x51:  # set tempo
                    tempo_events.append((tick, int.from_bytes(payload, "big")))
                running = None
            elif status in (0xF0, 0xF7):  # sysex
                length, j = _read_varlen(tdata, i + 1)
                i = j + length
                running = None
            else:
                if status & 0x80:
                    i += 1
                    running = status
                else:
                    status = running
                    if status is None:
                        raise ValueError("running status without prior status byte")
                kind = status & 0xF0
                channel = status & 0x0F
                if kind in (0xC0, 0xD0):  # program change / channel pressure: 1 byte
                    events.append((tick, kind, channel, tdata[i], 0))
                    i += 1
                else:  # 2 data bytes
                    events.append((tick, kind, channel, tdata[i], tdata[i + 1]))
                    i += 2
        tracks.append(events)

    # Tempo map -> tick->seconds conversion.
    tempo_events.sort(key=lambda e: e[0])
    if not tempo_events or tempo_events[0][0] != 0:
        tempo_events.insert(0, (0, 500000))  # default 120 bpm
    boundaries_ticks = np.array([t for t, _ in tempo_events], dtype=np.float64)
    tempos = np.array([q for _, q in tempo_events], dtype=np.float64)
    boundary_secs = np.zeros(len(tempo_events))
    for k in range(1, len(tempo_events)):
        dt = boundaries_ticks[k] - boundaries_ticks[k - 1]
        boundary_secs[k] = boundary_secs[k - 1] + dt * tempos[k - 1] / (1e6 * division)

    def tick_to_sec(tick: int) -> float:
        k = int(np.searchsorted(boundaries_ticks, tick, side="right")) - 1
        return boundary_secs[k] + (tick - boundaries_ticks[k]) * tempos[k] / (1e6 * division)

    # Pass 2: build instruments. One instrument per (track, channel, program)
    # seen; piano data uses a single instrument in practice.
    midi = MidiFile(resolution=division)
    for events in tracks:
        per_channel: dict[int, Instrument] = {}
        pending: dict[tuple[int, int], list[tuple[int, int]]] = {}  # (ch,pitch) -> [(tick, vel)]
        for tick, kind, channel, d1, d2 in events:
            inst = per_channel.get(channel)
            if inst is None:
                inst = per_channel[channel] = Instrument(is_drum=(channel == 9))
            if kind == 0xC0:
                inst.program = d1
            elif kind == 0xB0:
                inst.control_changes.append(
                    ControlChange(number=d1, value=d2, time=tick_to_sec(tick))
                )
            elif kind == 0x90 and d2 > 0:
                pending.setdefault((channel, d1), []).append((tick, d2))
            elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                # pretty_midi semantics: a note_off closes ALL open notes at
                # this pitch; zero-length ones (on tick == off tick) are kept
                # open for a later off rather than dropped.
                stack = pending.get((channel, d1))
                if stack:
                    closed = [(on, vel) for on, vel in stack if on != tick]
                    kept = [(on, vel) for on, vel in stack if on == tick]
                    for on_tick, vel in closed:
                        inst.notes.append(
                            Note(
                                pitch=d1,
                                start=tick_to_sec(on_tick),
                                end=tick_to_sec(tick),
                                velocity=vel,
                            )
                        )
                    if closed and kept:  # same-tick note-ons stay open
                        pending[(channel, d1)] = kept
                    else:
                        del pending[(channel, d1)]
        for inst in per_channel.values():
            if inst.notes or inst.control_changes:
                inst.notes.sort(key=lambda n: (n.start, n.pitch))
                midi.instruments.append(inst)
    return midi


# ---------------------------------------------------------------------------
# SMF writing
# ---------------------------------------------------------------------------


def _varlen(value: int) -> bytes:
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(chunks))


def save_midi(midi: MidiFile, path, tempo_us_per_quarter: int = 500000) -> None:
    """Write a format-1 SMF: tempo track + one track per instrument."""
    division = midi.resolution

    def sec_to_tick(sec: float) -> int:
        return int(round(sec * 1e6 * division / tempo_us_per_quarter))

    def track_chunk(events_bytes: bytes) -> bytes:
        body = events_bytes + b"\x00\xff\x2f\x00"  # end of track
        return b"MTrk" + struct.pack(">I", len(body)) + body

    # Tempo track
    tempo_track = b"\x00\xff\x51\x03" + tempo_us_per_quarter.to_bytes(3, "big")

    inst_tracks = []
    for ch, inst in enumerate(midi.instruments):
        channel = 9 if inst.is_drum else min(ch, 15) if ch != 9 else 10
        events: list[tuple[int, int, bytes]] = []  # (tick, order, bytes)
        events.append((0, 0, bytes([0xC0 | channel, inst.program & 0x7F])))
        for cc in inst.control_changes:
            events.append(
                (sec_to_tick(cc.time), 1, bytes([0xB0 | channel, cc.number & 0x7F, cc.value & 0x7F]))
            )
        for n in inst.notes:
            on, off = sec_to_tick(n.start), sec_to_tick(n.end)
            events.append((on, 2, bytes([0x90 | channel, n.pitch & 0x7F, max(1, min(127, n.velocity))])))
            events.append((off, 1, bytes([0x80 | channel, n.pitch & 0x7F, 0])))
        events.sort(key=lambda e: (e[0], e[1]))
        out = bytearray()
        prev = 0
        for tick, _, msg in events:
            out += _varlen(tick - prev) + msg
            prev = tick
        inst_tracks.append(bytes(out))

    ntrks = 1 + len(inst_tracks)
    header = b"MThd" + struct.pack(">IHHH", 6, 1, ntrks, division)
    with open(path, "wb") as f:
        f.write(header)
        f.write(track_chunk(tempo_track))
        for t in inst_tracks:
            f.write(track_chunk(t))
