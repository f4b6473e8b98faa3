"""On-device sample-format conversion.

The reference converts raw SDR samples to float on the host CPU
(reference: src/samplereader.cpp:29-66): unsigned integer types are
XOR'd with their sign bit (an unsigned->signed recentre) and every
integer type is scaled by ``signed_max + 1`` into [-1, 1).

Here the raw integer bytes go to the device and are converted there:
at 35 MSPS IQ that is 70 MB/s of u8 over PCIe instead of 280 MB/s of
f32.  The converted values are bit-identical to the reference's
(``(x ^ 0x80 as s8) / 128 == (int(x) - 128) / 128`` etc.).

Supported formats (reference src/spectrumserver.cpp:349-363 plus the
explicit template instantiations in src/samplereader.cpp:72-81):
u8, s8, u16, s16, u32, s32, f32, f64.

u16 and u32 travel as the same bits reinterpreted as int16/int32
(``host_preconvert``), and ``to_float`` XORs the sign bit in the
integer domain, so the device only ever sees dtypes every PyTorch
backend handles.
"""

from __future__ import annotations

import numpy as np
import torch

# format name -> (numpy dtype of raw wire data, scale divisor or None for float)
SAMPLE_FORMATS: dict[str, tuple[np.dtype, float | None]] = {
    "u8": (np.dtype(np.uint8), 128.0),
    "s8": (np.dtype(np.int8), 128.0),
    "u16": (np.dtype(np.uint16), 32768.0),
    "s16": (np.dtype(np.int16), 32768.0),
    "u32": (np.dtype(np.uint32), 2147483648.0),
    "s32": (np.dtype(np.int32), 2147483648.0),
    "f32": (np.dtype(np.float32), None),
    "f64": (np.dtype(np.float64), None),
}

# unsigned wide formats ship as their signed reinterpretation
_SIGNED_VIEW = {"u16": np.dtype(np.int16), "u32": np.dtype(np.int32)}


def wire_dtype(fmt: str) -> np.dtype:
    """Numpy dtype of the raw sample stream for a given format string."""
    return SAMPLE_FORMATS[fmt][0]


def host_preconvert(raw: np.ndarray, fmt: str) -> np.ndarray:
    """Host-side step: reinterpret raw bytes as the dtype shipped to the
    device.

    Only f64 needs an actual host conversion (downcast to f32); u16/u32
    become zero-copy int16/int32 views of the same bits; everything else
    is a zero-copy view as the wire dtype.
    """
    d = SAMPLE_FORMATS[fmt][0]
    arr = raw.view(d) if raw.dtype != d else raw
    if d == np.float64:
        return arr.astype(np.float32)
    if fmt in _SIGNED_VIEW:
        return arr.view(_SIGNED_VIEW[fmt])
    return arr


def device_dtype(fmt: str) -> np.dtype:
    """Dtype of ``host_preconvert``'s output, the one the device sees:
    the wire dtype, with f64 as f32 and u16/u32 as their signed views.
    The mesh's overlap halo must have it, since it is concatenated with
    the raw shards on the device."""
    d = SAMPLE_FORMATS[fmt][0]
    if d == np.float64:
        return np.dtype(np.float32)
    return _SIGNED_VIEW.get(fmt, d)


def to_float(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """Device-side conversion of ``host_preconvert`` output to
    normalized float32 in [-1, 1).

    Matches reference src/samplereader.cpp:29-40: unsigned types are
    recentred by subtracting 2^(bits-1); all integer types divide by
    2^(bits-1); floats pass through (scale 1.0).
    """
    d, scale = SAMPLE_FORMATS[fmt]
    if scale is None:
        return x.to(torch.float32)
    if fmt in _SIGNED_VIEW:
        # u16/u32 arrive as signed bits: XOR the sign bit in the INTEGER
        # domain like the reference, then cast.  Casting to f32 first
        # would round 32-bit values to the 24-bit mantissa BEFORE the
        # subtract: 0x80000001 would become 0.0 instead of 2^-31.
        signbit = -(1 << (8 * d.itemsize - 1))
        x = torch.bitwise_xor(x, signbit)
        return x.to(torch.float32) * (1.0 / scale)
    if d.kind == "u":
        # u8 fits the f32 mantissa exactly; subtract after cast
        return (x.to(torch.float32) - scale) * (1.0 / scale)
    return x.to(torch.float32) * (1.0 / scale)


def iq_to_complex(x: torch.Tensor) -> torch.Tensor:
    """Interleaved IQ float32 stream (even length, contiguous) ->
    complex64, as a zero-copy view."""
    return torch.view_as_complex(x.view(-1, 2))
