"""How fast one block on every SM streams a buffer from L2 into shared
memory by TMA bulk copies (``csrc/l2_probe.cu``), with and without
``.multicast::cluster`` to a pair of blocks: the rate K5's walk needs for its
weight stream (``conv_kernel.k5_traffic``).

    python -m music_transcription_tpu_torch.ops.l2_probe

prints one line a configuration: the buffer (freq_aware_conv's 1.38 MB of
bf16 weights, which stays in L2), the copy size, the stages in flight, the
time, the bytes read from L2 a second and the bytes landed in shared memory a
second (twice the first with multicast).
"""

from __future__ import annotations

import ctypes

import torch

from music_transcription_tpu_torch.ops import _build

BUF_BYTES = 7 * 3 * 128 * 256 * 2  # freq_aware_conv's weights in bf16


def run(chunk: int, stages: int, multicast: bool, copies: int = 2000) -> dict:
    """One timed launch on one block an SM (an even count with multicast)."""
    lib = _build.load("l2_probe")
    lib.l2_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_float)]
    lib.l2_probe.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms - sms % 2 if multicast else sms
    buf = torch.empty(BUF_BYTES, dtype=torch.uint8, device="cuda")
    ms = ctypes.c_float()
    _build.check(lib, lib.l2_probe(buf.data_ptr(), BUF_BYTES, chunk, stages, copies,
                                   int(multicast), blocks, ctypes.byref(ms)), "l2_probe")
    issuers = blocks // 2 if multicast else blocks
    read = issuers * copies * chunk
    return {"chunk": chunk, "stages": stages, "multicast": multicast, "blocks": blocks,
            "ms": ms.value, "l2_read_TBps": read / ms.value / 1e9,
            "landed_TBps": read * (2 if multicast else 1) / ms.value / 1e9}


def main() -> None:
    for multicast in (False, True):
        for chunk, stages in ((14336, 4), (14336, 8), (6144, 8), (43008, 2)):
            r = run(chunk, stages, multicast)
            print(f"l2_probe {torch.cuda.get_device_name(0)}: buffer {BUF_BYTES} B, copies of "
                  f"{chunk} B, {stages} in flight, {r['blocks']} blocks"
                  f"{', multicast to 2' if multicast else ''}: {r['ms']:.4f} ms, L2 read "
                  f"{r['l2_read_TBps']:.3f} TB/s, landed in shared memory "
                  f"{r['landed_TBps']:.3f} TB/s")


if __name__ == "__main__":
    main()
