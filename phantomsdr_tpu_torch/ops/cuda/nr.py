"""K-NR: the frame recursion of spectral noise reduction (csrc/nr.cu).

Replaces the ``lax.scan`` over ``_gain_frame`` in ``nr_process``
(phantomsdr_tpu/ops/nr.py): per (channel, bin) and frame, the startup
noise accumulation, the MMSE speech-presence probability and noise-floor
track, the decision-directed a-priori SNR and the unsmoothed gain.  The
frame FFTs, the gain smoothing, the weighting, the IFFTs and the
overlap-add around it stay batched PyTorch (ops/nr.py).

Bound on the card: bytes (x_pow in, g_run out, the carries in and out).
Each bin's recursion is independent of every other bin's, so one thread
per (channel, bin) walks the step's frames with its five carries in
registers, its divisions and square root written out branch-free
(``fast_check`` holds them to the IEEE ones on the card) and a group
redone with the IEEE ones where a range test fails; ``chain_probe``
runs that loop over a power held in a register, without the loads and
stores, as the floor.

``gain_frames_plain`` is the recursion in plain PyTorch (a Python loop
over frames, vectorised over channels and bins, in the JAX package's
operation order); the wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import (
    F, I, P, CudaKernel, check_host_or_cuda, require_cuda, stream_and_device,
)

# constants of NR_spectral.c:32-35 and the collapsed smoothing factors
PSTHR = 0.99
PNSAF = 0.01
PSINI = 0.5
PSPRI = 0.5
AX = 0.8          # noise-track smoothing, exp(ln 0.8)
AP = 0.9          # speech-prob smoothing, exp(ln 0.9)
SNR_PRIO_MIN = 10.0 ** (-30.0 / 10.0)
GAIN_LIMIT = 0.001
INIT_FRAMES = 20  # noise-estimate accumulation frames at startup

KERNEL = CudaKernel("nr", [P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                           F, F, F, F, I, P],
                    probe_argtypes=[P, P, P, P, P, P, P, P, P, P, I, I, I, F,
                                    F, F, F, I, P])


@functools.lru_cache(maxsize=16)
def _consts(alpha: float, xih1r: float, pfac: float
            ) -> tuple[float, float, float, float]:
    """alpha, 1 - alpha, xih1r and pfac as the float32 values the
    recursion uses (1 - alpha is formed in double, as in JAX)."""
    f32 = np.float32
    return (float(f32(alpha)), float(f32(1.0 - alpha)), float(f32(xih1r)),
            float(f32(pfac)))


def _gain_frame(alpha, xih1r, pfac, stage, nest, xt, pslp, hk_old, x_pow):
    """One frame of the recursion (nr.py:120-175); x_pow [C, F]."""
    fresh = (stage == 0)[:, None]
    pslp = torch.where(fresh, PSINI, pslp)
    hk_old = torch.where(fresh, 1.0, hk_old)
    nest = torch.where(fresh, 0.0, nest)
    stage = torch.clamp(stage + 1, max=INIT_FRAMES + 1)
    accum = (stage <= INIT_FRAMES)[:, None]
    running = (stage >= INIT_FRAMES)[:, None]
    nest_a = torch.where(accum, nest + 0.05 * x_pow, nest)
    xt_in = torch.where(accum, PSINI * nest_a, xt)
    xt_safe = xt_in + 1e-30
    ph1y = 1.0 / (1.0 + pfac * torch.exp(xih1r * x_pow / xt_safe))
    pslp_r = AP * pslp + (1 - AP) * ph1y
    ph1y = torch.where(pslp_r > PSTHR, 1.0 - PNSAF,
                       torch.clamp(ph1y, max=1.0))
    xtr = (1.0 - ph1y) * x_pow + ph1y * xt_in
    xt_r = AX * xt_in + (1 - AX) * xtr
    snr_post = torch.clamp(x_pow / (xt_r + 1e-30), SNR_PRIO_MIN, 1000.0)
    snr_prio = torch.clamp(alpha * hk_old + (1.0 - alpha)
                           * torch.clamp(snr_post - 1.0, min=0.0), min=0.0)
    v = snr_prio * snr_post / (1.0 + snr_prio)
    g_run = torch.clamp(torch.sqrt(0.7212 * v + v * v) / snr_post,
                        min=GAIN_LIMIT)
    hk_new = snr_post * g_run * g_run
    carries = (stage, nest_a, torch.where(running, xt_r, xt_in),
               torch.where(running, pslp_r, pslp),
               torch.where(running, hk_new, hk_old))
    return carries, g_run, running[:, 0]


def _check_index_range(n: int, c: int, f: int) -> None:
    """The kernel indexes x_pow and g_run with 32-bit integers, one frame
    past the last included."""
    if (n + 1) * c * f >= 1 << 31:
        raise ValueError(f"gain_frames: x_pow [{n}, {c}, {f}] has too many "
                         f"elements for the kernel's 32-bit indices")


def gain_frames_plain(carries, alpha: float, xih1r: float, pfac: float,
                      x_pow: torch.Tensor):
    """See ``gain_frames``."""
    g_run = torch.empty_like(x_pow)
    running = torch.empty(x_pow.shape[:2], dtype=torch.bool,
                          device=x_pow.device)
    for i in range(x_pow.shape[0]):
        carries, g_run[i], running[i] = _gain_frame(alpha, xih1r, pfac,
                                                    *carries, x_pow[i])
    return carries, g_run, running


def gain_frames(carries, alpha: float, xih1r: float, pfac: float,
                x_pow: torch.Tensor):
    """The noise/SNR/gain recursion over the N frames of a step.

    carries: (stage [C] int32, nest, xt, pslp, hk_old [C, F] f32), the
    gain side of ``NRState``; x_pow [N, C, F] f32 squared magnitudes.
    Returns (new carries, g_run [N, C, F] unsmoothed gains, running
    [N, C] bool: the frame ran the reducer).
    """
    if check_host_or_cuda(x_pow, "gain_frames"):
        return gain_frames_plain(carries, alpha, xih1r, pfac, x_pow)
    require_cuda(x_pow, "x_pow", torch.float32, 3)
    stage, nest, xt, pslp, hk_old = carries
    n, c, f = x_pow.shape
    require_cuda(stage, "stage", torch.int32, 1)
    for name, t in (("nest", nest), ("xt", xt), ("pslp", pslp),
                    ("hk_old", hk_old)):
        require_cuda(t, name, torch.float32, 2)
        if t.shape != (c, f):
            raise ValueError(f"gain_frames: {name} {tuple(t.shape)} for "
                             f"x_pow {tuple(x_pow.shape)}")
    if stage.shape[0] != c:
        raise ValueError(f"gain_frames: stage {tuple(stage.shape)} for "
                         f"x_pow {tuple(x_pow.shape)}")
    _check_index_range(n, c, f)
    g_run = torch.empty_like(x_pow)
    running = x_pow.new_empty((n, c), dtype=torch.bool)
    # the four float carries out as views of one buffer
    floats = x_pow.new_empty((4, c, f))
    stage1 = torch.empty_like(stage)
    stream, dev = stream_and_device(x_pow)
    p = floats.data_ptr()
    KERNEL.launch(x_pow.data_ptr(), stage.data_ptr(), nest.data_ptr(),
                  xt.data_ptr(), pslp.data_ptr(), hk_old.data_ptr(),
                  g_run.data_ptr(), running.data_ptr(), stage1.data_ptr(),
                  p, p + 4 * c * f, p + 8 * c * f, p + 12 * c * f, n, c, f,
                  *_consts(alpha, xih1r, pfac), dev, stream)
    return (stage1, *floats.unbind()), g_run, running


def chain_probe(carries, alpha: float, xih1r: float, pfac: float,
                x_pow: torch.Tensor):
    """The kernel's frame loop alone, for timing: each thread runs the
    N frames of its bin on the first frame's power held in a register
    (no loads or stores inside the loop) and writes its carries.
    Returns (nest, xt, pslp, hk_old); not counted as a launch of the
    kernel.  CUDA tensors only."""
    require_cuda(x_pow, "x_pow", torch.float32, 3)
    stage, nest, xt, pslp, hk_old = carries
    n, c, f = x_pow.shape
    _check_index_range(n, c, f)
    out = tuple(torch.empty_like(t) for t in (nest, xt, pslp, hk_old))
    stream, dev = stream_and_device(x_pow)
    KERNEL.probe(x_pow.data_ptr(), *(t.data_ptr() for t in carries),
                 *(t.data_ptr() for t in out), n, c, f,
                 *_consts(alpha, xih1r, pfac), dev, stream)
    return out


def fast_check(per: int = 1 << 16, device: int | str = "cuda"
               ) -> dict[str, tuple[int, int, int]]:
    """The kernel's written-out division and square root against
    ``__fdiv_rn`` and ``__fsqrt_rn`` on the card: ``div`` over every pair
    of exponent fields with ``per`` operand pairs each (edge mantissas,
    hashed ones, zero numerators); ``sqrt_rcp``, the square root and the
    reciprocal, over every float32.  Each: (values checked, values the
    written-out path accepted, accepted values whose bits differ).  CUDA
    only."""
    count = torch.zeros(6, dtype=torch.int64, device=device)
    require_cuda(count, "count", torch.int64, 1)
    stream, dev = stream_and_device(count)
    fn = KERNEL.lib().nr_fast_check_launch
    fn.argtypes, fn.restype = [P, ctypes.c_uint, I, P], I
    KERNEL.call("nr_fast_check_launch", count.data_ptr(), per, dev, stream)
    c = count.tolist()
    return {"div": tuple(c[:3]), "sqrt_rcp": tuple(c[3:])}
