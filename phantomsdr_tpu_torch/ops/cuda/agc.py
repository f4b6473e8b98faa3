"""K-AGC: look-ahead AGC + round-half-up int16 (csrc/agc.cu).

Replaces the gain ``lax.scan`` and the sliding window max of
``agc_process`` (phantomsdr_tpu/ops/agc.py) and ``float_to_int16``
(phantomsdr_tpu/ops/channelizer.py).  Per channel one block loads the
carried tail plus the step's stream, takes the exact window max by
doubling in shared memory, runs the gain recursion (with the ``seen``
clamp) and writes int16 straight into the [B, C, half] audio slice of
the step's packed output buffer.

Bound on the card: the gain recursion, a dependent chain of one step's
samples per channel; the kernel precomputes every input of the chain
in parallel so the serial thread only reads shared memory, and runs
all channels at once.

``agc_int16_plain`` is the same function in plain PyTorch; the wrapper
takes it only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..agc import AGCParams, AGCState, agc_process
from ..channelizer import float_to_int16
from .build import (
    F, I, P, CudaKernel, check_host_or_cuda, require_cuda, stream_and_device,
)

KERNEL = CudaKernel("agc", [P, P, P, P, I, I, I, F, F, F, I, P, P, P, P, P,
                            I, P])
# shared memory one block may opt in to on sm_90 (bytes); above it the
# kernel's two window-max buffers go to a device scratch buffer
SMEM_LIMIT = 232448


def agc_int16_plain(state: AGCState, x: torch.Tensor, params: AGCParams,
                    out16: torch.Tensor) -> AGCState:
    """See ``agc_int16``."""
    new_state, y = agc_process(state, x, params)
    b, c, half = out16.shape
    out16.copy_(float_to_int16(y).reshape(c, b, half).permute(1, 0, 2))
    return new_state


def agc_int16(state: AGCState, x: torch.Tensor, params: AGCParams,
              out16: torch.Tensor) -> AGCState:
    """AGC the per-channel streams x: [C, L] and write them as int16
    into out16: [B, C, half] (sample t = b*half + s), L = B*half.
    Returns the new AGCState."""
    if check_host_or_cuda(x, "agc_int16"):
        return agc_int16_plain(state, x, params, out16)
    require_cuda(x, "x", torch.float32, 2)
    require_cuda(state.tail, "tail", torch.float32, 2)
    require_cuda(state.gain, "gain", torch.float32, 1)
    require_cuda(state.seen, "seen", torch.int32, 1)
    require_cuda(out16, "out16", torch.int16, 3)
    c, n = x.shape
    w = params.window
    b, oc, half = out16.shape
    if (state.tail.shape != (c, w - 1) or state.gain.shape[0] != c
            or state.seen.shape[0] != c or oc != c or b * half != n):
        raise ValueError("agc_int16: mismatched shapes "
                         f"x {tuple(x.shape)} tail {tuple(state.tail.shape)} "
                         f"out16 {tuple(out16.shape)} window {w}")
    tail = torch.empty_like(state.tail)
    gain = torch.empty_like(state.gain)
    seen = torch.empty_like(state.seen)
    m = w - 1 + n
    scratch = (torch.empty(2 * m * c, dtype=torch.float32, device=x.device)
               if 2 * 4 * m > SMEM_LIMIT else None)
    stream, dev = stream_and_device(x)
    KERNEL.launch(
        x.data_ptr(), state.tail.data_ptr(), state.gain.data_ptr(),
        state.seen.data_ptr(), c, n, w,
        float(np.float32(params.attack_coeff)),
        float(np.float32(params.release_coeff)),
        float(np.float32(params.desired_level)), half, out16.data_ptr(),
        tail.data_ptr(), gain.data_ptr(), seen.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, dev, stream)
    return AGCState(tail=tail, gain=gain, seen=seen)
