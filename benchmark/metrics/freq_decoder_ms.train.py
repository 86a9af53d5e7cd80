"""Device ms a step of the hFT model's ``model.freq_decoder`` span in the
profiled stretch (the frequency decoder's blocks and the first-stage heads,
forward and backward): the device time that the stretch's split by program
span (``common/spans.py``, handed over by ``generators/train_hft.py`` as the
window's ``split``) gives to the span, over the split's steps. None without
a split, or where the program opens no such span."""


def read(w):
    split = getattr(w, "split", None)
    return None if split is None else split.ms_per_step("model.freq_decoder")
