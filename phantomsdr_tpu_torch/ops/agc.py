"""DC blocker and look-ahead AGC with explicit per-channel carries.

Reference semantics:

- DC blocker (src/utils.h:139-169): two cascaded length-D moving
  averages; ``out[t] = x[t-D+1] - MA_D(MA_D(x))[t]`` where
  ``D = audio_max_sps / 750 * 2`` (integer division, src/signal.cpp:54).
  The double moving average is a triangular FIR; it is computed with
  cumulative sums over [carry_tail, block] instead of a per-sample
  circular buffer -- same numbers, vectorized.

- Look-ahead AGC (src/utils/audioprocessing.cpp:5-73, constructed with
  (0.2, 50ms, 300ms, 200ms, audio_max_sps) at src/signal.cpp:55):
  window W = lookahead_ms * sr / 1000 samples; once W samples have been
  pushed, ``out[t] = x[t-W+1] * gain[t]`` where
  ``peak[t] = max |x[t-W+1 .. t]|``, ``desired = 0.2 / (peak + 1e-10)``
  and gain follows attack/release first-order smoothing
  (attack when desired < gain).  Before W samples: output 0.

``agc_process`` here is the plain version (a Python loop over samples
for the gain recursion); on the card the main path runs the AGC and
the int16 conversion as one kernel (ops/cuda/agc.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


# ---------------------------------------------------------------- DC blocker

class DCBlockerState(NamedTuple):
    tail: torch.Tensor  # [C, 2D-2] last inputs (zeros-initialized like the
    #                     reference's zero-filled circular buffers)


def dc_blocker_delay(audio_max_sps: int) -> int:
    """D = audio_max_sps / 750 * 2 with C++ integer division (signal.cpp:54)."""
    return (audio_max_sps // 750) * 2


def init_dc_state(num_channels: int, delay: int,
                  device="cpu") -> DCBlockerState:
    return DCBlockerState(tail=torch.zeros((num_channels, 2 * delay - 2),
                                           dtype=torch.float32,
                                           device=device))


def _sliding_mean(y: torch.Tensor, d: int) -> torch.Tensor:
    """Mean over trailing window of d along last axis; output[i] is the
    mean of y[..., i-d+1 : i+1], defined for i >= d-1 (length L-d+1)."""
    c = torch.nn.functional.pad(torch.cumsum(y, dim=-1), (1, 0))
    return (c[..., d:] - c[..., :-d]) * (1.0 / d)


def dc_blocker(state: DCBlockerState, x: torch.Tensor, delay: int
               ) -> tuple[DCBlockerState, torch.Tensor]:
    """Apply the cascaded-MA DC blocker to a block x: [C, L]."""
    d = delay
    y = torch.cat([state.tail, x], dim=-1)              # [C, 2D-2+L]
    ma1 = _sliding_mean(y, d)                            # [C, D-1+L]
    ma2 = _sliding_mean(ma1, d)                          # [C, L]
    # out[t] = oldest element of MA1 buffer = x[t - D + 1]  (utils.h:148)
    out = y[..., d - 1:d - 1 + x.shape[-1]] - ma2
    return DCBlockerState(tail=y[..., -(2 * d - 2):]), out


# ----------------------------------------------------------------------- AGC

class AGCState(NamedTuple):
    tail: torch.Tensor  # [C, W-1] last raw inputs
    gain: torch.Tensor  # [C] smoothed gain (reset/init 0, audioprocessing.cpp:70)
    seen: torch.Tensor  # [C] int32 samples pushed so far (clamped at W)


class AGCParams(NamedTuple):
    window: int          # look-ahead samples
    attack_coeff: float
    release_coeff: float
    desired_level: float


def make_agc_params(sample_rate: int, desired_level: float = 0.2,
                    attack_ms: float = 50.0, release_ms: float = 300.0,
                    lookahead_ms: float = 200.0) -> AGCParams:
    """Coefficients per src/utils/audioprocessing.cpp:10-15."""
    w = int(lookahead_ms * sample_rate / 1000.0)
    att = 1.0 - np.exp(-1.0 / (attack_ms * 0.001 * sample_rate))
    rel = 1.0 - np.exp(-1.0 / (release_ms * 0.001 * sample_rate))
    return AGCParams(window=w, attack_coeff=float(att),
                     release_coeff=float(rel), desired_level=desired_level)


def init_agc_state(num_channels: int, window: int, device="cpu") -> AGCState:
    return AGCState(
        tail=torch.zeros((num_channels, window - 1), dtype=torch.float32,
                         device=device),
        gain=torch.zeros((num_channels,), dtype=torch.float32, device=device),
        seen=torch.zeros((num_channels,), dtype=torch.int32, device=device),
    )


def sliding_max_abs(y: torch.Tensor, w: int, out_len: int) -> torch.Tensor:
    """max |y[..., i : i+w]| for i in [0, out_len), exactly.

    Doubling: after k rounds m[i] = max |y[i .. i+2^k-1]|, and with
    2^k <= w < 2^(k+1) the window is the union of the two spans
    starting at i and at i + w - 2^k.  O(M log w); the AGC kernel
    computes it the same way in shared memory.
    """
    m = y.abs()
    span = 1
    while 2 * span <= w:
        m = torch.maximum(m[..., :-span], m[..., span:])
        span *= 2
    return torch.maximum(m[..., :out_len], m[..., w - span:w - span + out_len])


def agc_process(state: AGCState, x: torch.Tensor, params: AGCParams
                ) -> tuple[AGCState, torch.Tensor]:
    """Apply the look-ahead AGC to block x: [C, L] -> [C, L] output."""
    w = params.window
    length = x.shape[-1]
    y = torch.cat([state.tail, x], dim=-1)               # [C, W-1+L]
    peaks = sliding_max_abs(y, w, length)                # [C, L]
    # a true division (``scalar / tensor`` would multiply by a rounded
    # reciprocal)
    level = peaks.new_tensor(params.desired_level)
    desired = (level / (peaks + 1e-10)).T.contiguous()
    steps = torch.arange(1, length + 1, device=x.device, dtype=torch.int32)
    full = (state.seen[:, None] + steps[None, :]) >= w  # [C, L]
    full_t = full.T.contiguous()
    gain = state.gain
    gains = torch.empty_like(desired)                    # [L, C]
    for t in range(length):
        d = desired[t]
        attack = gain - params.attack_coeff * (gain - d)
        release = gain + params.release_coeff * (d - gain)
        gain = torch.where(full_t[t], torch.where(d < gain, attack, release),
                           gain)
        gains[t] = gain
    out = torch.where(full, y[..., :length] * gains.T, 0.0)
    new_state = AGCState(
        tail=y[..., y.shape[-1] - (w - 1):],
        gain=gain,
        # clamp at the window: only "have we filled the look-ahead yet"
        # matters, and an unbounded int32 would wrap negative after
        # ~2^31 samples (~50 h at 12 kHz) and silence the channel
        seen=torch.clamp_max(state.seen + length, w),
    )
    return new_state, out
