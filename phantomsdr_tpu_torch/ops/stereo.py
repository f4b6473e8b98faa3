"""WBFM stereo decoder (19 kHz pilot PLL + L-R demix), batched over
the channel population.

The reference sends the FM multiplex (MPX) as mono audio and leaves
stereo to the browser (jsdsp/src/wbfmpll.cpp): an 18-20 kHz bandpass
isolates the pilot, a PLL (VCO at 19 kHz, loop bandwidth 0.001) locks to
it, the MPX is mixed down by twice the pilot phase to bring the 38 kHz
DSB L-R subcarrier to baseband, the mono path is delayed by the bandpass
group delay, and L/R = mono +- (L-R).  Here it runs on the device for
every listener at once, as an opt-in (``[input] stereo = true``):

- the bandpass is a streaming FIR with its tail carried across steps
  (ops/polyphase.fir),
- the per-sample PLL and the demix are kernel K-PILOT on the card
  (ops/cuda/pilot.py),
- the mono delay line is a carried tail.

Two deviations from wbfmpll.cpp:60-80, as in the JAX package: the
DELAYED sample feeds the mixer (the PLL phase at sample i tracks the
pilot at i-D, D the bandpass group delay, so mono and L-R stay aligned),
and the phase detector is -2*y*sin(theta) (odd around lock, so the VCO
locks in phase with the pilot; the reference's 2*y*cos(theta) locks in
quadrature and decodes swapped channels at 9.5 dB separation).  The
demixed L-R keeps its 38/76 kHz image terms unfiltered, as the
reference does; they die in the Opus decimation lowpass when that is on.
Non-FM rows pass mono through both ears.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cuda.pilot import pilot_mix
# stereo_demix(xd, ph, fm_mask) -> [2C, T] rows L0, R0, L1, R1, ... (the
# JAX function returns the L and R rows apart); the main path forms it
# inside K-PILOT
from .cuda.pilot import stereo_mix_plain as stereo_demix  # noqa: F401
from .polyphase import design_lowpass, fir

PILOT_HZ = 19000.0
# stereo needs the 38 kHz DSB subcarrier (+15 kHz audio) inside Nyquist
MIN_STEREO_SPS = 106000


class StereoParams(NamedTuple):
    taps: np.ndarray   # [N] 18-20 kHz bandpass FIR
    delay: int         # bandpass group delay (N-1)/2, mono-path delay
    f_nom: float       # nominal pilot phase increment 2*pi*19k/fs


class StereoState(NamedTuple):
    bp_tail: torch.Tensor    # [C, N-1] bandpass input history
    mono_tail: torch.Tensor  # [C, delay] mono delay-line history
    phase: torch.Tensor      # [C] PLL phase (rad)
    freq: torch.Tensor       # [C] PLL frequency OFFSET from f_nom (so
    #                          that an all-zeros reset re-arms the PLL at
    #                          the nominal 19 kHz)


def make_stereo_params(audio_sps: int) -> StereoParams:
    """Filter/PLL constants for an audio rate.  The tap count follows
    the reference's estimate_req_filter_len(2000/fs, 60) | 1
    (jsdsp/src/wbfmpll.cpp:22: 2 kHz transition, 60 dB); the response
    is a windowed-sinc lowpass difference passing 18-20 kHz."""
    fs = float(audio_sps)
    df = 2000.0 / fs
    n = int(60.0 / (22.0 * df)) | 1
    hi = design_lowpass(n, 2 * 20000.0 / fs)
    lo = design_lowpass(n, 2 * 18000.0 / fs)
    return StereoParams(taps=(hi - lo).astype(np.float32),
                        delay=(n - 1) // 2,
                        f_nom=float(2.0 * np.pi * PILOT_HZ / fs))


def init_stereo_state(num_channels: int, params: StereoParams | None,
                      device="cpu") -> StereoState:
    """All-zero carries; with ``params=None`` (stereo off) the tails
    are zero-width."""
    nt = params.taps.shape[0] if params is not None else 1
    d = params.delay if params is not None else 0

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    c = num_channels
    return StereoState(bp_tail=z(c, nt - 1), mono_tail=z(c, d),
                       phase=z(c), freq=z(c))


def pilot_bandpass(bp_tail: torch.Tensor, taps: np.ndarray, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """18-20 kHz pilot isolation with the filter tail carried across
    steps.  Returns (new_bp_tail, y [C, T])."""
    t = x.shape[1]
    xin = torch.cat([bp_tail, x], dim=1)                 # [C, nt-1+T]
    return xin[:, t:], fir(xin, taps)


def delay_stream(tail: torch.Tensor, x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-delay x by tail.shape[1] samples (history carried).
    Returns (new_tail, x_delayed [C, T])."""
    t = x.shape[1]
    full = torch.cat([tail, x], dim=1)
    return full[:, t:], full[:, :t].contiguous()


def pilot_front_end(bp_tail: torch.Tensor, delay_tail: torch.Tensor,
                    taps: np.ndarray, x: torch.Tensor):
    """Shared pilot front end (stereo and RDS): bandpass the pilot and
    group-delay the MPX so the mix is phase-aligned with the PLL's
    pilot estimate.  Returns (new_bp_tail, new_delay_tail, y [C, T],
    x_delayed [C, T])."""
    new_bp, y = pilot_bandpass(bp_tail, taps, x)
    new_d, xd = delay_stream(delay_tail, x)
    return new_bp, new_d, y, xd


def pilot_track(phase: torch.Tensor, freq: torch.Tensor, f_nom: float,
                y: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample pilot PLL over the bandpassed pilot y [C, T] (K-PILOT
    without its mixes).  Returns (new_phase, new_freq, ph [C, T]) where
    ph[:, i] is the loop-updated phase the mixers use at sample i."""
    phase, freq, ph, _, _ = pilot_mix(phase, freq, f_nom, y)
    return phase, freq, ph


def stereo_decode(state: StereoState, params: StereoParams,
                  x: torch.Tensor, fm_mask: torch.Tensor
                  ) -> tuple[StereoState, torch.Tensor]:
    """MPX stream [C, T] -> (state, [2C, T] rows L0, R0, L1, R1, ...):
    the bandpass, the delay line, and K-PILOT's PLL and demix in one
    launch.  Streaming-continuous across steps; T must be >= the
    bandpass group delay."""
    new_bp, new_mono, y, xd = pilot_front_end(
        state.bp_tail, state.mono_tail, params.taps, x)
    phase, freq, _, lr, _ = pilot_mix(state.phase, state.freq, params.f_nom,
                                      y, xs=xd, fm_mask=fm_mask)
    return StereoState(bp_tail=new_bp, mono_tail=new_mono, phase=phase,
                       freq=freq), lr
