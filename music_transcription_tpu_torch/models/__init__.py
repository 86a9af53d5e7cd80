"""Transcription models as torch.nn.Modules."""
