"""K-WF: power + IQ roll + int8-dB waterfall pyramid (csrc/waterfall.cu).

Replaces the Pallas kernel ``fused_waterfall_pyramid``
(phantomsdr_tpu/ops/pallas/waterfall.py), which never lowered on its
TPU compiler, and on the main path also the ``spectrum_power`` and
``roll_iq`` steps in front of it.  It reads the complex spectra of the
cadence-due hops in place (row indices, no gather of the [B, R]
spectrum) and writes the flat [D, P] int8 pyramid that
``waterfall_pyramid`` + ``pyramid_flat`` give.

Bound on the card: bytes -- 8 read per bin of each due row, about 2
written.  One block per 2048 display bins of a row: each lane loads its
8 bins with 16-byte loads and builds their levels in registers, warp
shuffles and one shared-memory exchange, so only the int8 rows reach
device memory, in packed stores.  The log2 of the quantization comes
from lg2.approx, with the accurate log2f where the dB value lies near an
integer, so the result equals the plain version's (csrc/waterfall.cu
says how and why).

``waterfall_rows_plain`` is the same function in plain PyTorch; the
wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..quantize import (
    _DB_PER_OCTAVE, _LOG2_TO_DB, pyramid_flat, roll_iq, spectrum_power,
    waterfall_pyramid,
)
from .build import (
    F, I, I64, P, CudaKernel, check_host_or_cuda, require_cuda,
    stream_and_device,
)

KERNEL = CudaKernel("waterfall", [P, I64, P, I, I, I, I, I, F, F, P, I64, P,
                                  I, P])
CHUNK_LOG2 = 11  # csrc/waterfall.cu kChunkLog2: levels 0-11 in one block
_L2DB = float(np.float32(_LOG2_TO_DB))
_DPO = float(np.float32(_DB_PER_OCTAVE))


def pyramid_width(fft_result_size: int, levels: int) -> int:
    return sum(fft_result_size >> i for i in range(levels))


@functools.lru_cache(maxsize=64)
def launch_plan(fft_result_size: int, levels: int,
                columns: int) -> tuple[int, int]:
    """(P, scratch floats per due row) of a launch over rows of
    ``columns`` bins; raises ValueError for a shape the kernel does not
    take.  Scratch holds the per-chunk sums of a pyramid deeper than one
    chunk (levels > CHUNK_LOG2 + 1), two buffers of R >> CHUNK_LOG2."""
    r = fft_result_size
    if r <= 0 or r & (r - 1) or columns < r:
        raise ValueError(f"fft_result_size {r} must be a power of two "
                         f"<= {columns}")
    if not 1 <= levels <= r.bit_length():
        raise ValueError(f"levels {levels} out of range for width {r}")
    last = min(levels - 1, CHUNK_LOG2)
    return (pyramid_width(r, levels),
            2 * (r >> last) if last < levels - 1 else 0)


def waterfall_rows_plain(spec: torch.Tensor, rows: torch.Tensor, *,
                         fft_result_size: int, base_idx: int, levels: int,
                         size_log2: int) -> torch.Tensor:
    """[B, R'] complex spectra, [D] row indices -> [D, P] int8."""
    sel = spec.index_select(0, rows.to(torch.int64))[:, :fft_result_size]
    pw = roll_iq(spectrum_power(sel), base_idx)
    return pyramid_flat(waterfall_pyramid(pw, levels, size_log2))


def waterfall_rows(spec: torch.Tensor, rows: torch.Tensor, *,
                   fft_result_size: int, base_idx: int, levels: int,
                   size_log2: int) -> torch.Tensor:
    """Flat int8 waterfall pyramids of the spectra rows ``rows``.

    spec: [B, R'] complex64 normalized spectra in natural FFT order
    (R' >= R = fft_result_size); rows: [D] int32 indices into B.
    Returns [D, P] int8, P = sum_l R >> l.
    """
    kw = dict(fft_result_size=fft_result_size, base_idx=base_idx,
              levels=levels, size_log2=size_log2)
    if check_host_or_cuda(spec, "waterfall_rows"):
        return waterfall_rows_plain(spec, rows, **kw)
    require_cuda(spec, "spec", torch.complex64, 2)
    require_cuda(rows, "rows", torch.int32, 1)
    r = fft_result_size
    p, scratch_per_row = launch_plan(r, levels, spec.shape[1])
    d = rows.shape[0]
    out = torch.empty((d, p), dtype=torch.int8, device=spec.device)
    scratch = (torch.empty(d * scratch_per_row, dtype=torch.float32,
                           device=spec.device) if scratch_per_row else None)
    stream, dev = stream_and_device(spec)
    KERNEL.launch(
        spec.data_ptr(), spec.stride(0), rows.data_ptr(), d, r,
        base_idx % r, levels, size_log2, _L2DB, _DPO, out.data_ptr(), p,
        scratch.data_ptr() if scratch is not None else None, dev, stream)
    return out
