"""The least time the chip could take for a stage, from its shapes.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at the full 700 W): 3.35 TB/s of HBM3, 67 TFLOP/s in float32
outside the tensor cores, 989 TFLOP/s in bfloat16 on them.  A stage's
least time is the larger of its bytes over the bandwidth and its float32
operations over the float32 rate.  The bytes are what the stage needs:
each input byte read once and each output byte written once, whatever a
kernel reads again; the operations are per element of the stage's
arithmetic (a transcendental function counted as about 20).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

PLL_OPS_PER_SAMPLE = 60     # sincos, atan2, the loop update, the wrap
AGC_OPS_PER_SAMPLE = 12     # the gain step and the int16 convert


def least_s(nbytes: float, ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger bound."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pyramid_width(r: int, levels: int) -> int:
    return sum(r >> i for i in range(levels))


def waterfall(rows: int, r: int, levels: int) -> tuple[float, float]:
    """Bytes and operations of the waterfall stage on ``rows`` due hops of
    ``r`` display bins: each complex64 bin read once, the flat int8
    pyramid written once; power (3) per bin, a pair sum and the dB
    quantization (6) per pyramid byte."""
    p = pyramid_width(r, levels)
    return 8.0 * rows * r + rows * p, 3.0 * rows * r + 6.0 * rows * p


def am_pll(c: int, n: int) -> tuple[float, float]:
    """The AM carrier PLL over ``c`` channels of ``n`` samples: carrier
    and baseband (complex64) read, the float32 output written, the
    phase and frequency read and written."""
    return c * n * (8 + 8 + 4) + 4 * c * 4, c * n * PLL_OPS_PER_SAMPLE


def agc(c: int, n: int, w: int) -> tuple[float, float]:
    """The look-ahead AGC and int16 over ``c`` channels of ``n`` samples
    at window ``w``: the float32 stream, the carried tail (w - 1), gain
    and count read; int16 audio, tail, gain and count written; the
    window max (log2 w per sample of tail and stream) and the gain
    step."""
    m = w - 1 + n
    return (c * (4 * n + 4 * (w - 1) + 8) + c * (2 * n + 4 * (w - 1) + 8),
            c * (m * math.log2(w) + n * AGC_OPS_PER_SAMPLE))
