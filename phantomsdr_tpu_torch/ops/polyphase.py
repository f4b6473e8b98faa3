"""Polyphase decimating FIR, batched over the channel population.

The reference reaches baseband by frequency-domain bin slicing
(src/signal.cpp:126-214) and never low-pass-decimates in the time
domain; this op covers the rate conversions it leaves rough -- WBFM at
audio_sps=192000 feeding Opus, which is capped at 48 kHz
(src/audio.cpp:59, a rate clamp without resampling): here the stream is
filtered and decimated 4:1 on the device first.  The RDS subcarrier
lowpass (ops/rds.py) and the stereo pilot bandpass (ops/stereo.py) use
the same streaming FIR.

The filter is a strided ``conv1d`` over [C, L] with the prototype
lowpass reversed (a convolution written as a cross-correlation), batched
across all channels; the filter tail is carried across steps.  The JAX
package computes it with XLA's ``conv_general_dilated``, outside any
Pallas kernel, so it stays a PyTorch call here.  On the card it runs in
full float32: cuDNN convolutions default to TF32 (a 10-bit mantissa),
which would wreck the 60 dB pilot bandpass and the RDS lowpass, so
``fir`` turns TF32 off around its call.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch


def design_lowpass(num_taps: int, cutoff: float, dtype=np.float32) -> np.ndarray:
    """Windowed-sinc prototype lowpass.

    cutoff: normalized to Nyquist (1.0 = fs/2).  Hamming window; unity
    DC gain (scipy.signal.firwin equivalent).
    """
    n = np.arange(num_taps, dtype=np.float64)
    m = (num_taps - 1) / 2.0
    h = np.sinc(cutoff * (n - m))
    h *= np.hamming(num_taps)
    h /= h.sum()
    return h.astype(dtype)


def decimator_taps(factor: int, taps_per_phase: int = 8) -> np.ndarray:
    """Anti-alias prototype for decimation by `factor`:
    cutoff at 0.8 of the output Nyquist, factor*taps_per_phase taps."""
    return design_lowpass(factor * taps_per_phase, 0.8 / factor)


class DecimatorState(NamedTuple):
    tail: torch.Tensor  # [C, num_taps - 1] input history


def init_decimator_state(num_channels: int, num_taps: int,
                         device="cpu") -> DecimatorState:
    return DecimatorState(tail=torch.zeros((num_channels, num_taps - 1),
                                           dtype=torch.float32,
                                           device=device))


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full float32 inside the block (its TF32
    default restored after)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@functools.lru_cache(maxsize=32)
def _conv_weight(taps: bytes, device: torch.device) -> torch.Tensor:
    """float32 taps (as bytes) reversed, as a [1, 1, nt] conv1d weight on
    device (copied there once)."""
    w = np.frombuffer(taps, np.float32)[::-1].copy()
    return torch.from_numpy(w).to(device)[None, None, :]


def fir(x: torch.Tensor, taps: np.ndarray, stride: int = 1) -> torch.Tensor:
    """VALID strided FIR of the rows of x [C, M]: out[c, k] =
    sum_t taps[t] * x[c, k*stride + nt - 1 - t], in full float32."""
    rhs = _conv_weight(np.asarray(taps, np.float32).tobytes(), x.device)
    with _no_tf32():
        return torch.nn.functional.conv1d(x[:, None, :], rhs,
                                          stride=stride)[:, 0, :]


def polyphase_decimate(state: DecimatorState, x: torch.Tensor,
                       taps: np.ndarray, factor: int
                       ) -> tuple[DecimatorState, torch.Tensor]:
    """Filter + decimate a block: [C, L] -> [C, L // factor].

    Streaming-continuous: y[c, k] = sum_t taps[t] * x_full[c, k*factor - t]
    with x_full the concatenation of all blocks (history carried in
    state); a pure (nt-1)-sample group delay.  L must be a multiple of
    factor.
    """
    length = x.shape[1]
    if length % factor:
        raise ValueError("block length must be a multiple of the factor")
    nt = taps.shape[0]
    y_in = torch.cat([state.tail, x], dim=1)             # [C, nt-1+L]
    out = fir(y_in, taps, factor)
    return (DecimatorState(tail=y_in[:, y_in.shape[1] - (nt - 1):]),
            out[:, :length // factor])
