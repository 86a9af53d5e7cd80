"""Host-side audio and MIDI I/O (numpy)."""
