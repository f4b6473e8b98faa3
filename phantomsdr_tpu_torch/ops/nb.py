"""The Wild noise blanker (impulse localisation + LPC repair) on the
device.

The reference runs this in the browser (jsdsp/lib/NB.c, the
Teensy-ConvolutionSDR "Wild" blanker): per frame it fits an LPC model of
the voice (Levinson-Durbin on the frame's autocorrelation), whitens the
frame with the inverse filter, sharpens impulses with the matched
filter, thresholds the residual against its variance to locate up to 20
impulses, and replaces +-PL samples around each with a linear crossfade
of forward and backward LPC predictions.  Here it runs for every
listener at once, batched [C, T], as an opt-in (``[input] nr = true``
with ``nr_algo = "nb"``); one frame is one hop-batch stream, and the
2*order + 2*PL samples before it are carried.

The LPC fit and the prediction matrices (launch 1), and the threshold,
impulse search, repairs and writeback (launch 2) are kernel K-NB on the
card (ops/cuda/nb.py); the two FIR passes between them are grouped
``conv1d``s with per-channel coefficients, in full float32 (cuDNN's TF32
off, as in ``ops.polyphase.fir``): detection is a threshold, and a
rounding difference there could move an impulse.

Quirks of NB.c reproduced, as in the JAX package: the R[0] * (1+1e-9)
inflation, lpc_power summing only lpcs[0..order-1], the unbiased
variance, arm_fir's zero state per call (zero left padding).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.nb import half_len, lpc_coeffs, repair
from .polyphase import _no_tf32


class NBParams(NamedTuple):
    thresh: float     # detection level in residual sigmas (~3..10)
    taps: int         # LPC order (<= 40, NB.c:19)
    impulse_len: int  # samples replaced around an impulse (odd)


class NBState(NamedTuple):
    tail: torch.Tensor   # [C, 2*order + 2*PL] previous frame's tail


def make_nb_params(thresh: float = 5.0, taps: int = 32,
                   samples: int = 11) -> NBParams:
    il = int(samples) | 1
    return NBParams(thresh=float(thresh), taps=int(taps), impulse_len=il)


def init_nb_state(num_channels: int, params: NBParams | None,
                  device="cpu") -> NBState:
    order = params.taps if params is not None else 0
    pl = half_len(params.impulse_len) if params is not None else 0
    return NBState(tail=torch.zeros((num_channels, 2 * order + 2 * pl),
                                    dtype=torch.float32, device=device))


def fir_fresh(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """arm_fir_f32 with zero state, per-channel coefficients [C, NT] in
    CMSIS order: y[n] = sum_k coeffs[NT-1-k] * x[n-k].  x [C, T]."""
    c, nt = coeffs.shape
    xp = torch.nn.functional.pad(x, (nt - 1, 0))
    with _no_tf32():
        return torch.nn.functional.conv1d(xp[None], coeffs[:, None, :],
                                          groups=c)[0]


def nb_process(state: NBState, params: NBParams, x: torch.Tensor,
               ) -> tuple[NBState, torch.Tensor]:
    """Blank impulses in the stream x [C, T] -> same shape (streaming:
    the 2*order + 2*PL tail is carried across calls)."""
    return nb_process_detail(state, params, x)[:2]


def nb_process_detail(state: NBState, params: NBParams, x: torch.Tensor):
    """``nb_process`` plus what the search found: (state, out, count [C]
    int32, positions [C, 20] int32, thr [C], temp [C, T] residual)."""
    t = x.shape[1]
    order, il = params.taps, params.impulse_len
    lo = order + half_len(il)
    wb = torch.cat([state.tail, x], dim=1).contiguous()   # [C, T+2o+2PL]
    lpcs, coef_f, coef_b_rev = lpc_coeffs(wb, t, order, il)
    # whiten + matched filter (fresh state per frame)
    temp = fir_fresh(lpcs.flip(1), wb[:, lo:lo + t])
    temp = fir_fresh(lpcs, temp).contiguous()
    wbf, count, positions, thr = repair(wb, temp, lpcs, coef_f, coef_b_rev,
                                        params.thresh, order, il)
    new = NBState(tail=wbf[:, t:].contiguous())
    return new, wbf[:, lo:lo + t], count, positions, thr, temp
