"""The yardstick's table of peaks and kernel B2's work, frozen here.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, without
sparsity), which assume the card's full power limit of 700 W: 67 TFLOP/s
in FP32 outside the tensor cores, 3.35 TB/s of HBM3.  A run reports the
card's power limit beside every share of them.

B2's FP32 operations (copied from chip_smoke.py's B2_OPS_REJECT and
B2_OPS_ACCEPT, the f32 form): every in-image (pixel, neighbour) pair of
the (2r+1)^2 window runs the 3-channel acceptance test, 15 operations; an
accepted pair adds its weight (spatial 3, 6 G-buffer planes x 4), expf
(~8), valid and the weight sum (2) and the 3 payload sums (2 each): 43
more.  An FMA counts two.  Bytes: each input read once (mc, d2 and the
payload [H,W,C], the planes [H,W,G], valid [H,W]) and each output written
once (out [H,W,CF], wsum [H,W]), in float32.
"""
from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
B2_TEST_OPS = 3 * 5
B2_ACCEPT_OPS = 3 + 6 * 4 + 8 + 2 + 3 * 2


def b2_ops(pairs: int, accepted: int) -> float:
    return float(pairs * B2_TEST_OPS + accepted * B2_ACCEPT_OPS)


def b2_bytes(n_pixels: int, C: int, CF: int, G: int) -> float:
    return 4.0 * n_pixels * (2 * C + CF + G + 1 + CF + 1)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the bandwidth."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
