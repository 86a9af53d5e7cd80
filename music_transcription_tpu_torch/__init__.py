"""PyTorch/CUDA port of music_transcription_tpu for the NVIDIA H100.

Inference path: WAV -> log-mel -> CNNRNN / CNNRNNLarge -> piano roll ->
MIDI (``python -m music_transcription_tpu_torch song.wav model.pth``). The
two TPU kernels on that path, the fused BiLSTM recurrence and the clamped
flash attention, are hand-written CUDA kernels in ``csrc/``. The package
imports neither JAX nor the JAX package.
"""
