"""The port's event tokenizer against the JAX package's: the same ids for the
same notes, rolls and MIDI files, the same decode of arbitrary ids, the same
grammar table; round trips; and the REMI tables the constrained route
shares."""

import numpy as np
import pytest

from music_transcription_tpu.models.event_tokenizer import EventMIDITokenizer as JEventTokenizer
from music_transcription_tpu.models.remi_tokenizer import REMITokenizer as JREMITokenizer
from music_transcription_tpu_torch.data.midi import Instrument, MidiFile, Note, save_midi
from music_transcription_tpu_torch.models.event_tokenizer import EventMIDITokenizer
from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer


def _notes(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    starts = np.round(rng.random(n) * 6.0, 3)
    return [(int(p), float(s), float(s + d)) for p, s, d in
            zip(rng.integers(0, 128, n), starts, np.round(rng.random(n) * 1.5, 3))]


def _spans(notes):
    return [(n.pitch, n.start, n.end, n.velocity) for n in notes]


@pytest.mark.parametrize("frame_rate,max_len", [(100, 512), (31.25, 512), (100, 64)])
def test_encode_and_decode_match_jax(frame_rate, max_len):
    tok, jtok = EventMIDITokenizer(frame_rate=frame_rate), JEventTokenizer(frame_rate=frame_rate)
    trips = _notes(int(frame_rate) + max_len)
    ids = tok.encode_notes(trips, max_len=max_len)
    assert ids == jtok.encode_notes(trips, max_len=max_len)
    assert ids == tok.encode_notes([Note(p, s, e) for p, s, e in trips], max_len=max_len)
    assert len(ids) == max_len and ids[0] == tok.sos and tok.eos in ids
    assert _spans(tok.decode_to_notes(ids)) == _spans(jtok.decode_to_notes(ids))
    np.testing.assert_array_equal(tok.decode_to_pianoroll(ids, max_t=400),
                                  jtok.decode_to_pianoroll(ids, max_t=400))


def test_round_trip_of_notes_and_rolls():
    tok = EventMIDITokenizer(frame_rate=100)
    notes = [Note(60, 0.0, 0.5), Note(64, 0.1, 0.4), Note(60, 0.7, 1.25), Note(21, 0.7, 0.9)]
    got = sorted((n.pitch, round(n.start, 6), round(n.end, 6))
                 for n in tok.decode_to_notes(tok.encode_notes(notes, max_len=128)))
    assert got == sorted((n.pitch, n.start, n.end) for n in notes)
    # roll bridge: (88, T) -> ids -> roll; JAX's encode of the same roll
    rng = np.random.default_rng(3)
    roll = np.zeros((88, 120), np.float32)
    for _ in range(15):
        key, a = int(rng.integers(0, 88)), int(rng.integers(0, 110))
        roll[key, a:a + int(rng.integers(2, 30))] = 1.0
    ids = tok.encode_from_pianoroll(roll, max_len=1024)
    assert ids == JEventTokenizer(frame_rate=100).encode_from_pianoroll(roll, max_len=1024)
    back = tok.decode_to_pianoroll(ids, max_t=120)
    np.testing.assert_array_equal(back, roll[:, :back.shape[1]])
    assert ids == tok.encode_from_pianoroll(roll.T, max_len=1024)  # (T, 88) too


def test_encode_midi_matches_jax(tmp_path):
    notes = [Note(p, s, e, 90) for p, s, e in _notes(7, 30)]
    path = tmp_path / "x.mid"
    save_midi(MidiFile(instruments=[Instrument(notes=notes),
                                    Instrument(is_drum=True, notes=[Note(40, 0.0, 1.0)])]), path)
    tok, jtok = EventMIDITokenizer(), JEventTokenizer()
    assert tok.encode_midi(str(path)) == jtok.encode_midi(str(path))
    out = tmp_path / "y.mid"
    midi = tok.decode_to_midi(tok.encode_midi(str(path)), out_path=str(out))
    assert out.exists() and len(midi.instruments[0].notes) == len(notes)


def test_decode_of_arbitrary_ids_matches_jax():
    tok, jtok = EventMIDITokenizer(frame_rate=31.25), JEventTokenizer(frame_rate=31.25)
    rng = np.random.default_rng(9)
    for _ in range(20):
        ids = rng.integers(0, 512, 200).tolist()
        assert _spans(tok.decode_to_notes(ids)) == _spans(jtok.decode_to_notes(ids))
        np.testing.assert_array_equal(tok.decode_to_pianoroll(ids, max_t=937),
                                      jtok.decode_to_pianoroll(ids, max_t=937))


@pytest.mark.parametrize("port_cls,jax_cls", [(EventMIDITokenizer, JEventTokenizer),
                                              (REMITokenizer, JREMITokenizer)])
def test_grammar_tables_match_jax_and_accept_the_encoder(port_cls, jax_cls):
    """transition_mask (the constrained route's table), note_token_mask and
    the decode of random ids equal JAX's; every id pair the encoder emits is
    allowed by the table."""
    tok, jtok = port_cls(), jax_cls()
    mask = tok.transition_mask()
    np.testing.assert_array_equal(mask, jtok.transition_mask())
    np.testing.assert_array_equal(tok.note_token_mask(), jtok.note_token_mask())
    rng = np.random.default_rng(5)
    roll = (rng.random((88, 200)) < 0.05).astype(np.float32)
    ids = np.asarray(tok.encode_from_pianoroll(roll, max_len=2048))
    assert mask[ids[:-1], ids[1:]].all()
    rand = rng.integers(0, 512, 300).tolist()
    np.testing.assert_array_equal(tok.decode_to_pianoroll(rand, max_t=500),
                                  jtok.decode_to_pianoroll(rand, max_t=500))
