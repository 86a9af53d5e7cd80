"""Spans of the port's layers, on the profiler's clock.

``span(name)`` is a context manager. While a ``torch.profiler`` session
records, it enters ``torch.profiler.record_function(name)``, so the span's
start and end come from the clock of the device's kernels and copies in
the same trace, and a device event can be put down to the span that
launched it. Otherwise it returns one shared no-op context: one flag test,
no allocation. There is no setting: spans are on exactly when a profiler
is, and the profiler keeps them (the training CLI's ``--profile_steps``
writes them out with its trace). A thread the profiler does not record,
such as one started after it, opens none.

The spans, by layer:

  * ``train.step`` (``parallel/train_step.train_step``) holding
    ``train.forward``, ``train.loss``, ``train.backward``, ``train.clip``,
    ``train.host_read`` (the guard's blocking read) and ``train.update``
    (Adam, or the running statistics put back on a skip);
  * ``model.cnn``, ``model.rnn``, ``model.attention`` and ``model.heads``
    (``models/cnn_rnn.py``, in every forward: training, evaluation and
    serving);
  * ``data.gather`` (``data/pipeline.py``): one batch gathered from the
    staged cache and widened.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
