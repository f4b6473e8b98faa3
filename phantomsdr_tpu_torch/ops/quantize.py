"""Waterfall power / int8-dB quantization / downsample pyramid.

Output semantics match the reference kernels (reference:
src/fft_impl.cpp:13-61 CPU, src/fft_impl.cpp:198-223 OpenCL):

- spectrum is normalized by the FFT length N *before* the power is taken
  (``complexbuf[i] /= normalize`` with ``normalize = N``),
- ``power = re^2 + im^2`` of the normalized bin,
- quantized int8 value ``q = sat_trunc(20*log10(power) + 127 +
  power_offset * 6.020599913279624)`` clamped to [-128, 127], where
  ``power_offset = round(log2(N)) + brightness_offset`` at the full
  resolution level and decreases by 1 per pyramid level,
- each pyramid level sums adjacent *power* pairs of the previous level
  (src/fft_impl.cpp:45-61) and re-quantizes with the decremented offset.

For IQ (c2c) input the quantized buffer is rolled so that bin 0 is the
lowest frequency: quantized[j] corresponds to FFT bin
``(j + base_idx) % N`` with ``base_idx = N/2 + 1``
(src/fft_impl.cpp:148-160).  The complex spectrum itself is *not*
rolled (the audio path indexes it through the same base_idx offset).

These are the plain versions; on the card the main path computes the
power, the roll and the whole pyramid in one kernel
(ops/cuda/waterfall.py), which uses the same constants and the same
``p[2j] + p[2j+1]`` pair-sum order.
"""

from __future__ import annotations

import numpy as np
import torch

# 20 * log10(2): dB per power-of-two, reference src/fft_impl.cpp:42
_DB_PER_OCTAVE = 6.020599913279624
# log10(2) * 20 applied to log2(power), reference src/fft_impl.cpp:42
_LOG2_TO_DB = 0.3010299956639812 * 20.0


def offset_db(power_offset: int) -> float:
    """``power_offset * 6.0206`` rounded as one float32 product (the
    kernel and the plain version add exactly this value)."""
    return float(np.float32(power_offset) * np.float32(_DB_PER_OCTAVE))


def quantize_power(power: torch.Tensor, power_offset: int) -> torch.Tensor:
    """int8 dB quantization of a (already normalized) power array.

    ``q = sat_trunc(log2(p) * 20*log10(2) + 127 + offset*6.0206)``;
    zero power maps to -128 (log -> -inf -> clamped).
    """
    p = torch.clamp_min(power, 0.0)
    db = torch.log2(p) * _LOG2_TO_DB + 127.0 + offset_db(power_offset)
    db = torch.where(p > 0, db, -128.0)
    # Reference CPU does (int8)max(-128.f, v) (truncation toward zero);
    # OpenCL uses convert_char_sat_rtz (round-to-zero, saturate).
    return torch.clamp(torch.trunc(db), -128.0, 127.0).to(torch.int8)


def spectrum_power(spec: torch.Tensor) -> torch.Tensor:
    """|X|^2 of an (already normalized) complex spectrum."""
    return spec.real * spec.real + spec.imag * spec.imag


def roll_iq(x: torch.Tensor, base_idx: int) -> torch.Tensor:
    """Roll the last axis so output[j] = x[(j + base_idx) % R].

    For IQ input ``base_idx = N/2 + 1`` puts the lowest frequency at
    bin 0 (reference src/fft_impl.cpp:148-153).  For real input
    base_idx == 0 and this is the identity.
    """
    if base_idx == 0:
        return x
    return torch.roll(x, -base_idx, dims=-1)


def waterfall_pyramid(power0: torch.Tensor, levels: int,
                      size_log2: int) -> list[torch.Tensor]:
    """Build the int8 waterfall pyramid from full-resolution power.

    ``power0``: [..., R] normalized power in *display order* (already
    rolled for IQ).  Returns ``levels`` int8 arrays, level i of width
    R >> i, with power offset ``size_log2 - i``
    (reference src/fft_impl.cpp:162-172).  Each level is the
    adjacent-pair sum ``p[2j] + p[2j+1]`` of the previous one.
    """
    out = [quantize_power(power0, size_log2)]
    p = power0
    for i in range(1, levels):
        p = p[..., 0::2] + p[..., 1::2]
        out.append(quantize_power(p, size_log2 - i))
    return out


def pyramid_flat(pyramid: list[torch.Tensor]) -> torch.Tensor:
    """Concatenate pyramid levels into the reference's flat layout.

    quantizedbuf[0:R] = level0, then R/2, R/4, ... -- matches the pointer
    walk in the reference waterfall loop (src/websocket.cpp:207-236).
    """
    return torch.cat(pyramid, dim=-1)


def pyramid_level_offsets(fft_result_size: int, levels: int) -> list[int]:
    """Byte offsets of each level inside the flat pyramid buffer."""
    offs = []
    o = 0
    for i in range(levels):
        offs.append(o)
        o += fft_result_size >> i
    return offs
