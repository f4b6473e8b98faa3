"""K-AGC: look-ahead AGC + round-half-up int16 (csrc/agc.cu).

Replaces the gain ``lax.scan`` and the sliding window max of
``agc_process`` (phantomsdr_tpu/ops/agc.py) and ``float_to_int16``
(phantomsdr_tpu/ops/channelizer.py).  One warp-specialised block of 512
threads per channel, everything in shared memory at any window: all
threads read the carried tail plus the step's stream once for the max
of |y| per 128-sample block and a sparse table over those; then one
thread runs the gain recursion (with the ``seen`` clamp) alone in its
warp, while the other 15 warps fill a ring of 1024-sample chunks with
its input (``desired``: the exact window max from each chunk's suffix
and prefix block maxes and the table) up to three chunks ahead of it,
and write int16 straight into the [B, C, half] audio slice of the
step's packed output buffer a chunk behind it.

``agc_float`` launches the same kernel compiled with a float32 output:
its workers store the gained stream itself into a [C, L] buffer (0
before the window fills), the input of the WBFM stages (stereo, RDS,
de-emphasis, Opus decimation), which convert to int16 after them.  It
counts its launches apart (``FLOAT_KERNEL``).

Bound on the card: the gain recursion, a dependent chain of one step's
samples per channel.  ``chain_probe`` launches that loop alone over
inputs held in registers; its time is the floor the kernel is measured
against.  The chain has no branch (it starts where the warm-up ends),
reads shared memory four samples at a time and has no lane of its warp
to reconverge with.

``agc_int16_plain`` and ``agc_process`` (ops/agc.py) are the same
functions in plain PyTorch; the wrappers take them only for CPU
tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..agc import AGCParams, AGCState, agc_process
from ..channelizer import float_to_int16
from .build import (
    F, I, P, CudaKernel, check_host_or_cuda, require_cuda, stream_and_device,
)

KERNEL = CudaKernel("agc", [P, P, P, P, I, I, I, F, F, F, I, P, P, P, P, I,
                            P],
                    probe_argtypes=[P, P, P, I, I, F, F, I, P])
FLOAT_KERNEL = CudaKernel("agc_float", [P, P, P, P, I, I, I, F, F, F, P, P,
                                        P, P, I, P], source="agc")

# The kernel's shared memory (csrc/agc.cu): the table of block maxes
# (levels x 128-sample blocks of W-1+L floats, padded to four) beside the
# ring and one chunk's stage (6,296 floats) and two int flags, within the
# 227 KB a block may take on Hopper.
_SMEM_FLOATS = (227 * 1024 - 8) // 4 - (4 * 1024 + 4 * 6 + 1024 + 9 * 128)
_BLOCK = 128


def max_stream(window: int) -> int:
    """The longest stream (samples per channel and call) the kernel
    takes at ``window``; a longer one fails at launch.  The config
    refuses a step past it when it loads."""
    levels = max((window + _BLOCK - 2) // _BLOCK - 1, 1).bit_length()
    return (_SMEM_FLOATS & ~3) // levels * _BLOCK - (window - 1)


@functools.lru_cache(maxsize=16)
def _coeffs(params: AGCParams) -> tuple[float, float, float]:
    """attack, release and level as the float32 values the kernel takes."""
    return (float(np.float32(params.attack_coeff)),
            float(np.float32(params.release_coeff)),
            float(np.float32(params.desired_level)))


def agc_int16_plain(state: AGCState, x: torch.Tensor, params: AGCParams,
                    out16: torch.Tensor) -> AGCState:
    """See ``agc_int16``."""
    new_state, y = agc_process(state, x, params)
    b, c, half = out16.shape
    out16.copy_(float_to_int16(y).reshape(c, b, half).permute(1, 0, 2))
    return new_state


def _check_state(state: AGCState, x: torch.Tensor, params: AGCParams,
                 name: str) -> None:
    require_cuda(x, "x", torch.float32, 2)
    require_cuda(state.tail, "tail", torch.float32, 2)
    require_cuda(state.gain, "gain", torch.float32, 1)
    require_cuda(state.seen, "seen", torch.int32, 1)
    c = x.shape[0]
    if (state.tail.shape != (c, params.window - 1)
            or state.gain.shape[0] != c or state.seen.shape[0] != c):
        raise ValueError(f"{name}: mismatched shapes x {tuple(x.shape)} "
                         f"tail {tuple(state.tail.shape)} window "
                         f"{params.window}")


def _launch(kernel: CudaKernel, state: AGCState, x: torch.Tensor,
            params: AGCParams, *out) -> AGCState:
    """Launch ``kernel`` with the output argument(s) ``out``; returns
    the new state."""
    c, n = x.shape
    w = params.window
    tail = torch.empty_like(state.tail)
    gain = torch.empty_like(state.gain)
    seen = torch.empty_like(state.seen)
    stream, dev = stream_and_device(x)
    kernel.launch(
        x.data_ptr(), state.tail.data_ptr(), state.gain.data_ptr(),
        state.seen.data_ptr(), c, n, w, *_coeffs(params), *out,
        tail.data_ptr(), gain.data_ptr(), seen.data_ptr(), dev, stream)
    return AGCState(tail=tail, gain=gain, seen=seen)


def agc_int16(state: AGCState, x: torch.Tensor, params: AGCParams,
              out16: torch.Tensor) -> AGCState:
    """AGC the per-channel streams x: [C, L] and write them as int16
    into out16: [B, C, half] (sample t = b*half + s), L = B*half.
    Returns the new AGCState."""
    if check_host_or_cuda(x, "agc_int16"):
        return agc_int16_plain(state, x, params, out16)
    _check_state(state, x, params, "agc_int16")
    require_cuda(out16, "out16", torch.int16, 3)
    c, n = x.shape
    b, oc, half = out16.shape
    if oc != c or b * half != n:
        raise ValueError(f"agc_int16: out16 {tuple(out16.shape)} for x "
                         f"{tuple(x.shape)}")
    return _launch(KERNEL, state, x, params, half, out16.data_ptr())


def agc_float(state: AGCState, x: torch.Tensor, params: AGCParams
              ) -> tuple[AGCState, torch.Tensor]:
    """AGC the per-channel streams x: [C, L] -> (new AGCState, gained
    stream [C, L] float32), ``agc_process``'s function."""
    if check_host_or_cuda(x, "agc_float"):
        return agc_process(state, x, params)
    _check_state(state, x, params, "agc_float")
    out = torch.empty_like(x)
    return _launch(FLOAT_KERNEL, state, x, params, out.data_ptr()), out


def chain_probe(x: torch.Tensor, gain0: torch.Tensor,
                params: AGCParams) -> torch.Tensor:
    """The kernel's gain chain alone, for timing: the same loop over L
    samples per channel on |x[:, :4]| held in registers, no loads or
    stores inside it.  Returns its final gain; not counted as a launch
    of the kernel.  CUDA tensors only."""
    require_cuda(x, "x", torch.float32, 2)
    require_cuda(gain0, "gain", torch.float32, 1)
    c, n = x.shape
    if gain0.shape[0] != c:
        raise ValueError(f"chain_probe: mismatched shapes {tuple(x.shape)} "
                         f"{tuple(gain0.shape)}")
    gain = torch.empty_like(gain0)
    stream, dev = stream_and_device(x)
    KERNEL.probe(x.data_ptr(), gain0.data_ptr(), gain.data_ptr(), c, n,
                 *_coeffs(params)[:2], dev, stream)
    return gain
