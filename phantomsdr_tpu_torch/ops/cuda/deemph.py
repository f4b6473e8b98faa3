"""K-DEEMPH: FM de-emphasis, a one-pole IIR per stream row
(csrc/deemph.cu).

Replaces the ``lax.associative_scan`` of ``deemph_process``
(phantomsdr_tpu/ops/deemph.py).  Bound on the card: bytes, the rows read
once and written once.  One block per row walks it in tiles staged in
shared memory: every thread runs its chunk of 32 samples from a zero
carry, the block scans the chunks' affine maps (the JAX combine), and
every thread runs its chunk again from its true carry.

``deemph_process_plain`` is the recurrence in plain PyTorch (a Python
loop over samples, vectorized over rows); the wrapper takes it only for
CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import (
    F, I, P, CudaKernel, check_host_or_cuda, require_cuda, stream_and_device,
)

KERNEL = CudaKernel("deemph", [P, P, P, P, P, I, I, F, F, I, P])


def _coeffs(alpha: float) -> tuple[float, float]:
    """a and 1 - a as the float32 values the recurrence uses."""
    a = np.float32(alpha)
    return float(a), float(np.float32(1.0) - a)


def deemph_process_plain(y_prev: torch.Tensor, alpha: float,
                         x: torch.Tensor, mask: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """See ``deemph_process``."""
    a, oma = _coeffs(alpha)
    b = (oma * x).T.contiguous()                       # [T, R]
    y = torch.empty_like(b)
    cur = y_prev.clone()
    for t in range(b.shape[0]):
        cur = a * cur + b[t]
        y[t] = cur
    y = torch.where(mask[:, None], y.T, x)
    last = y[:, -1] if x.shape[1] else y_prev
    return torch.where(mask, last, y_prev), y


def deemph_process(y_prev: torch.Tensor, alpha: float, x: torch.Tensor,
                   mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One block of streaming de-emphasis, y[n] = a*y[n-1] + (1-a)*x[n].

    y_prev: [R] carried output sample (per stream row), x: [R, T] f32,
    mask: [R] bool (True rows filtered, False rows passed through with
    their carry kept).  Returns (new y_prev, y [R, T]).
    """
    if check_host_or_cuda(x, "deemph_process"):
        return deemph_process_plain(y_prev, alpha, x, mask)
    require_cuda(x, "x", torch.float32, 2)
    require_cuda(y_prev, "y_prev", torch.float32, 1)
    require_cuda(mask, "mask", torch.bool, 1)
    rows, n = x.shape
    if y_prev.shape[0] != rows or mask.shape[0] != rows:
        raise ValueError("deemph_process: mismatched shapes "
                         f"{tuple(x.shape)} {tuple(y_prev.shape)} "
                         f"{tuple(mask.shape)}")
    y = torch.empty_like(x)
    y_out = torch.empty_like(y_prev)
    stream, dev = stream_and_device(x)
    KERNEL.launch(x.data_ptr(), y_prev.data_ptr(), mask.data_ptr(),
                  y.data_ptr(), y_out.data_ptr(), rows, n, *_coeffs(alpha),
                  dev, stream)
    return y_out, y
