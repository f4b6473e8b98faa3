"""K-ANR: the block-LMS chain of the LMS noise reduction and auto-notch
(csrc/anr.cu).

Replaces the ``lax.scan`` over ``_block_body`` in ``anr_process``
(phantomsdr_tpu/ops/anr.py): the step's samples in blocks of B (the
last block shorter), each predicted with the block-start weights from
``taps`` samples ``delay`` samples old, the leak automaton advanced once
per block, and the weights updated by lam^B * w + sum_n c1_n * win_n.

Bound on the card: operations, three ``taps``-long products a sample
(prediction, its window power, the weight update).  The blocks of a
channel form a dependent chain (each needs the weights of the one
before), so one thread block per channel runs them in order.  The
stream is staged by cp.async in segments of about ``SEGMENT`` samples
(whole blocks) into a shared-memory ring of the history and two
segments, each sample stored twice so that a segment's span is
contiguous; the window powers, which depend on the stream alone, come
from a parallel pass over each segment before its blocks; the chain's
taps-long sums wait on FMA latency, their loads issued a group ahead.
``segment_len`` mirrors the kernel's segmenting (the CPU tests hold
that index arithmetic against the JAX package).  ``chain_probe`` runs
the chain of blocks over the first segment's data, without output
stores, as the floor.

``lms_blocks_plain`` is the same in plain PyTorch (a Python loop over
blocks, vectorised over channels, in the JAX package's operation
order); the wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import (
    F, I, P, CudaKernel, check_host_or_cuda, require_cuda, stream_and_device,
)

# ANR.c's leak constants; the reference's leak-index quirk sets the
# index to LIDX_MIN on any trigger (anr.py:30-42), so its step sizes
# and ceiling never enter the block form
LIDX_INIT = 120.0
LIDX_MIN = 120.0
NGAMMA_INIT = 0.001
DEN_MULT = 6.25e-10

KERNEL = CudaKernel("anr", [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                            F, F, I, P],
                    probe_argtypes=[P, P, P, P, P, P, P, P, P, P, I, I, I,
                                    I, I, I, F, F, I, P])
# samples of one LMS block the kernel takes
MAX_BLOCK = 4096
# samples per staged segment, rounded down to whole blocks (csrc/anr.cu
# kSegTarget)
SEGMENT = 2048


def segment_len(bsz: int) -> int:
    """Samples of one staged segment of the kernel: whole blocks of bsz,
    about ``SEGMENT`` (one block where bsz is larger)."""
    return SEGMENT // bsz * bsz if bsz < SEGMENT else bsz


def int_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for a Python int n >= 1 by binary exponentiation, the
    products in the order of JAX's ``integer_pow`` lowering (which is
    what ``lam ** bsz`` becomes in the JAX package)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _block(taps, delay, two_mu, gamma, notch, hist, w, lidx, ngamma, xb):
    """One frozen-weight block (anr.py:193-225); xb [C, bsz]."""
    bsz = xb.shape[1]
    lkeep = taps + delay - 1
    tail = hist[:, :lkeep].flip(1)                       # oldest first
    seg = torch.cat([tail, xb], dim=1)                   # [C, lkeep+bsz]
    win = torch.stack([seg[:, taps - 1 - j: taps - 1 - j + bsz]
                       for j in range(taps)], dim=2)     # [C, bsz, taps]
    y = (win * w[:, None, :]).sum(2)
    sigma = (win * win).sum(2)
    inv_sigp = 1.0 / (sigma + 1e-10)
    error = xb - y
    out = error if notch else 4.0 * y
    nel = torch.abs(error * (1.0 - two_mu * sigma * inv_sigp))
    nev = torch.abs(xb - (1.0 - two_mu * ngamma)[:, None] * y
                    - two_mu * error * sigma * inv_sigp)
    lidx = torch.where((nev < nel).any(1), LIDX_MIN, lidx)
    ngamma = gamma * (lidx * lidx) * (lidx * lidx) * DEN_MULT
    lam = 1.0 - two_mu * ngamma
    g = ((two_mu * error * inv_sigp)[:, :, None] * win).sum(1)
    w = int_pow(lam, bsz)[:, None] * w + g
    hist = seg[:, seg.shape[1] - (taps + delay):].flip(1)  # newest first
    return hist, w, lidx, ngamma, out


def lms_blocks_plain(hist, w, lidx, ngamma, x, taps, delay, two_mu, gamma,
                     notch, bsz):
    """See ``lms_blocks``."""
    two_mu, gamma = float(np.float32(two_mu)), float(np.float32(gamma))
    outs = []
    for s in range(0, x.shape[1], bsz):
        hist, w, lidx, ngamma, o = _block(taps, delay, two_mu, gamma, notch,
                                          hist, w, lidx, ngamma,
                                          x[:, s:s + bsz])
        outs.append(o)
    return (hist, w, lidx, ngamma), torch.cat(outs, dim=1)


def _run(call, hist, w, lidx, ngamma, x, taps, delay, two_mu, gamma,
         notch, bsz):
    """Check the CUDA tensors and call the launcher ``call``: (new
    carries, out)."""
    for name, v, nd in (("x", x, 2), ("hist", hist, 2), ("w", w, 2),
                        ("lidx", lidx, 1), ("ngamma", ngamma, 1)):
        require_cuda(v, name, torch.float32, nd)
    c, t = x.shape
    if (hist.shape != (c, taps + delay) or w.shape != (c, taps)
            or lidx.shape[0] != c or ngamma.shape[0] != c):
        raise ValueError(f"lms_blocks: carries {tuple(hist.shape)} "
                         f"{tuple(w.shape)} {tuple(lidx.shape)} "
                         f"{tuple(ngamma.shape)} for x {tuple(x.shape)}, "
                         f"taps {taps}, delay {delay}")
    if not 1 <= bsz <= MAX_BLOCK:
        raise ValueError(f"lms_blocks: block of {bsz} samples, the kernel "
                         f"takes 1..{MAX_BLOCK}")
    out = torch.empty_like(x)
    new = tuple(torch.empty_like(v) for v in (hist, w, lidx, ngamma))
    stream, dev = stream_and_device(x)
    call(x.data_ptr(), hist.data_ptr(), w.data_ptr(), lidx.data_ptr(),
         ngamma.data_ptr(), out.data_ptr(), *(v.data_ptr() for v in new), c,
         t, taps, delay, bsz, int(notch), float(np.float32(two_mu)),
         float(np.float32(gamma)), dev, stream)
    return new, out


def lms_blocks(hist, w, lidx, ngamma, x, taps: int, delay: int,
               two_mu: float, gamma: float, notch: bool, bsz: int):
    """Block LMS over x [C, T] in blocks of bsz samples (the last one
    T mod bsz when that is not 0).

    hist [C, taps+delay] newest-first delay line, w [C, taps], lidx and
    ngamma [C]: the ``ANRState`` carries.  Returns ((hist, w, lidx,
    ngamma), out [C, T]): the prediction error (notch) or 4x the
    prediction (NR).
    """
    if check_host_or_cuda(x, "lms_blocks"):
        return lms_blocks_plain(hist, w, lidx, ngamma, x, taps, delay,
                                two_mu, gamma, notch, bsz)
    return _run(KERNEL.launch, hist, w, lidx, ngamma, x, taps, delay,
                two_mu, gamma, notch, bsz)


def chain_probe(hist, w, lidx, ngamma, x, taps: int, delay: int,
                two_mu: float, gamma: float, notch: bool, bsz: int):
    """The kernel's chain of blocks alone, for timing: x's first segment
    staged and its window powers formed once, then all the blocks of x
    over that segment's data (its last block standing in for later
    ones), with no output stores.  Returns its carries; not counted as a
    launch of the kernel.  CUDA tensors only."""
    return _run(KERNEL.probe, hist, w, lidx, ngamma, x, taps, delay,
                two_mu, gamma, notch, bsz)[0]
