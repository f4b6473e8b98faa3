"""K-PILOT: the 19 kHz pilot PLL of WBFM stereo and RDS and the
subcarrier mixes that use its phase (csrc/pilot.cu).

Replaces the per-sample ``lax.scan`` of ``pilot_track``
(phantomsdr_tpu/ops/stereo.py, unrolled by ops/unroll.py) and the
arithmetic that reads its phase: ``stereo_demix`` there and the 57 kHz
downmix of ``rds_from_pilot`` (phantomsdr_tpu/ops/rds.py).

Bound on the card: the per-channel dependent chain of one step's
samples (sin, the loop update and the wrap, sample after sample), not
its bytes.  ``chain_probe`` launches that loop alone over a pilot held in
registers; its time is the floor the kernel is measured against (with
``BODY_EARLIER``, the earlier design's loop: libdevice ``sinf`` at each
step's start and the wrap as a branch).  One thread per channel runs
the chain alone in its block, reading the pilot through a ring of
registers loaded ahead of it, and stores each sample's phase; its sine is libdevice ``sinf``'s fast path
for the wrapped phase's range [0, 2*pi] (csrc/wrapped_sin.cuh), equal to
``sinf`` there bit for bit, which ``sin_check`` verifies over every
float32 of the range.  A fully parallel kernel then forms the stereo L/R
and the RDS I/Q rows from the phase.

``pilot_mix_plain`` is the same function in plain PyTorch (a Python loop
over samples, vectorized over channels); the wrapper takes it only for
CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import (
    F, I, P, CudaKernel, check_host_or_cuda, require_cuda, stream_and_device,
)
from .pll import PLL_ALPHA, PLL_BETA, TWO_PI, _GAINS

KERNEL = CudaKernel("pilot", [P, P, P, P, P, P, P, P, P, P, P, I, I, F, F, F,
                              F, I, P],
                    probe_argtypes=[P, P, P, P, P, I, I, F, F, F, F, I, I, P])
# chain_probe's loop bodies (csrc/pilot.cu enum Body)
BODY_KERNEL, BODY_EARLIER = 0, 1


def _loop_args(f_nom: float) -> tuple[float, float, float, float]:
    """alpha, beta, f_nom and 2*pi as the float32 values the kernel takes."""
    return _GAINS[0], _GAINS[1], float(np.float32(f_nom)), _GAINS[2]


def pilot_track_plain(phase0: torch.Tensor, freq0: torch.Tensor,
                      f_nom: float, y: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pilot PLL alone: (phase, freq, ph [C, T]); see ``pilot_mix``."""
    f_nom = float(np.float32(f_nom))
    yt = y.T.contiguous()                               # [T, C]
    ph = torch.empty_like(yt)
    phase, freq = phase0.clone(), freq0.clone()
    for t in range(yt.shape[0]):
        e = (-2.0 * yt[t]) * torch.sin(phase)
        freq = freq + PLL_ALPHA * e
        ph_m = phase + PLL_BETA * e
        # jnp.mod: fmod, then + 2*pi where negative
        phase = torch.fmod((ph_m + f_nom) + freq, TWO_PI)
        phase = torch.where(phase < 0, phase + TWO_PI, phase)
        ph[t] = ph_m
    return phase, freq, ph.T.contiguous()


def stereo_mix_plain(xs: torch.Tensor, ph: torch.Tensor,
                     fm_mask: torch.Tensor) -> torch.Tensor:
    """Demix the delayed MPX xs [C, T] by twice the pilot phase ->
    [2C, T] rows L0, R0, L1, R1, ...  Gain 2 makes the demixed DSB term
    unity; rows with fm_mask False pass mono to both ears."""
    d = 2.0 * xs * torch.cos(2.0 * ph)
    d = d * torch.where(fm_mask, 1.0, 0.0)[:, None]
    return torch.stack([xs + d, xs - d], dim=1).reshape(-1, xs.shape[1])


def rds_mix_plain(xr: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """57 kHz complex downmix 2 * xr * exp(-3j * ph) of the delayed MPX
    xr [C, T] -> [2C, T] rows I0, Q0, I1, Q1, ..."""
    zi = 2.0 * xr * torch.cos(3.0 * ph)
    zq = -2.0 * xr * torch.sin(3.0 * ph)
    return torch.stack([zi, zq], dim=1).reshape(-1, xr.shape[1])


def pilot_mix_plain(phase0, freq0, f_nom, y, xs=None, fm_mask=None, xr=None):
    """See ``pilot_mix``."""
    phase, freq, ph = pilot_track_plain(phase0, freq0, f_nom, y)
    lr = stereo_mix_plain(xs, ph, fm_mask) if xs is not None else None
    iq = rds_mix_plain(xr, ph) if xr is not None else None
    return phase, freq, ph, lr, iq


def pilot_mix(phase0: torch.Tensor, freq0: torch.Tensor, f_nom: float,
              y: torch.Tensor, xs: torch.Tensor | None = None,
              fm_mask: torch.Tensor | None = None,
              xr: torch.Tensor | None = None):
    """Track the pilot y [C, T] (the bandpassed MPX) and mix against it.

    Per sample: e = -2*y*sin(phase), freq += alpha*e, ph = phase +
    beta*e, phase = mod(ph + f_nom + freq, 2*pi).  ph is the phase the
    mixers use.  With xs (the group-delayed MPX, [C, T]) and fm_mask
    ([C] bool) it also demixes stereo (``stereo_mix_plain``); with xr
    ([C, T]) it also mixes the 57 kHz RDS subcarrier to complex baseband
    (``rds_mix_plain``).  Returns (phase [C], freq [C], ph [C, T],
    L/R rows [2C, T] or None, I/Q rows [2C, T] or None).
    """
    if check_host_or_cuda(y, "pilot_mix"):
        return pilot_mix_plain(phase0, freq0, f_nom, y, xs, fm_mask, xr)
    require_cuda(y, "y", torch.float32, 2)
    require_cuda(phase0, "phase0", torch.float32, 1)
    require_cuda(freq0, "freq0", torch.float32, 1)
    c, n = y.shape
    if phase0.shape[0] != c or freq0.shape[0] != c:
        raise ValueError("pilot_mix: mismatched shapes "
                         f"{tuple(y.shape)} {tuple(phase0.shape)} "
                         f"{tuple(freq0.shape)}")
    lr = iq = None
    if xs is not None:
        require_cuda(xs, "xs", torch.float32, 2)
        require_cuda(fm_mask, "fm_mask", torch.bool, 1)
        if xs.shape != y.shape or fm_mask.shape[0] != c:
            raise ValueError(f"pilot_mix: xs {tuple(xs.shape)} / fm_mask "
                             f"{tuple(fm_mask.shape)} for y {tuple(y.shape)}")
        lr = y.new_empty((2 * c, n))
    if xr is not None:
        require_cuda(xr, "xr", torch.float32, 2)
        if xr.shape != y.shape:
            raise ValueError(f"pilot_mix: xr {tuple(xr.shape)} for y "
                             f"{tuple(y.shape)}")
        iq = y.new_empty((2 * c, n))
    ph = torch.empty_like(y)
    phase = torch.empty_like(phase0)
    freq = torch.empty_like(freq0)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    stream, dev = stream_and_device(y)
    KERNEL.launch(y.data_ptr(), phase0.data_ptr(), freq0.data_ptr(),
                  ph.data_ptr(), phase.data_ptr(), freq.data_ptr(), ptr(xs),
                  ptr(fm_mask), ptr(lr), ptr(xr), ptr(iq), c, n,
                  *_loop_args(f_nom), dev, stream)
    return phase, freq, ph, lr, iq


def chain_probe(y: torch.Tensor, phase0: torch.Tensor, freq0: torch.Tensor,
                f_nom: float, body: int = BODY_KERNEL
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chain alone, for timing: the same loop over T
    samples per channel on four pilot samples held in registers, no
    loads or stores inside it.  ``body`` picks the loop: the kernel's,
    or the earlier design's (libdevice ``sinf`` at each step's start, the
    wrap as a branch).  Returns its (phase, freq); not counted as a launch of
    the kernel.  CUDA tensors only."""
    require_cuda(y, "y", torch.float32, 2)
    require_cuda(phase0, "phase0", torch.float32, 1)
    require_cuda(freq0, "freq0", torch.float32, 1)
    c, n = y.shape
    if phase0.shape[0] != c or freq0.shape[0] != c:
        raise ValueError("chain_probe: mismatched shapes "
                         f"{tuple(y.shape)} {tuple(phase0.shape)} "
                         f"{tuple(freq0.shape)}")
    phase = torch.empty_like(phase0)
    freq = torch.empty_like(freq0)
    stream, dev = stream_and_device(y)
    KERNEL.probe(y.data_ptr(), phase0.data_ptr(), freq0.data_ptr(),
                 phase.data_ptr(), freq.data_ptr(), c, n, *_loop_args(f_nom),
                 body, dev, stream)
    return phase, freq


def sin_check(device: int | str = "cuda") -> tuple[int, int]:
    """The kernel's sine against libdevice ``sinf`` on the card over
    every float32 in [-0, 2*pi] (2*pi as the kernel's float32):
    (values checked, values whose bits differ).  CUDA only."""
    count = torch.zeros(2, dtype=torch.int64, device=device)
    require_cuda(count, "count", torch.int64, 1)
    stream, dev = stream_and_device(count)
    fn = KERNEL.lib().pilot_sin_check_launch
    fn.argtypes, fn.restype = [P, F, I, P], I
    KERNEL.call("pilot_sin_check_launch", count.data_ptr(), _GAINS[2], dev,
                stream)
    checked, differ = count.tolist()
    return checked, differ
