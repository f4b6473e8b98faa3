"""RDS subcarrier demodulation (57 kHz -> complex baseband), batched
over the channel population.

The reference decodes FM-RDS in the browser (jsdsp/redsea.js, a WASM
build of redsea): the server sends the 192 k MPX and the client recovers
the 1187.5 bps stream.  Here the per-sample subcarrier work runs on the
device for every listener that sent {"cmd":"rds"}, as an opt-in
(``[input] rds = true``):

- the 19 kHz pilot is bandpassed and tracked by the same PLL as the
  stereo decoder (ops/stereo.py; 57 kHz = 3x the pilot at the
  transmitter), kernel K-PILOT on the card, which also mixes the
  group-delayed MPX down by 3x the pilot phase to complex baseband (the
  standard lets the 57 kHz carrier ride in phase or in quadrature with
  the pilot's third harmonic; the host resolves the constant phase),
- a ~2.4 kHz lowpass + decimate (ops/polyphase.py) brings the stream
  down to a few kS/s; the mixed-down 38 kHz stereo subcarrier reaching
  down to ~4 kHz sets the stopband edge,
- per-channel block normalization + int8 quantization keep the
  device->host bytes at 2 bytes per baseband sample.

The protocol half (symbol timing, differential decode, block sync,
groups) is host work (runtime/rds.py).  Stations that send RDS without
a stereo pilot never lock: the 57 kHz carrier is derived from the pilot.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cuda.pilot import pilot_mix, rds_mix_plain
from .polyphase import DecimatorState, design_lowpass, polyphase_decimate
from .stereo import make_stereo_params, pilot_front_end

# the baseband rate fs/decim must stay >= 2 samples per 2375 Hz biphase
# symbol for the host decoder's timing
MIN_BASEBAND_SPS = 4750.0
# and a ceiling, so a config with an indivisible audio block cannot ship
# near-raw-rate baseband over the link
MAX_BASEBAND_SPS = 24000.0
# target RMS of the int8 baseband after per-block normalization
INT8_TARGET_RMS = 24.0


class RDSParams(NamedTuple):
    bp_taps: np.ndarray   # [Nb] 18-20 kHz pilot bandpass
    delay: int            # bandpass group delay = MPX delay-line length
    f_nom: float          # nominal pilot increment 2*pi*19k/fs
    lp_taps: np.ndarray   # [Nl] post-mix lowpass (pass 2.4k, stop ~4k)
    decim: int            # baseband decimation factor (divides half)


class RDSState(NamedTuple):
    """Every tensor has leading dim C, so the per-channel reset and
    resize apply row-wise; the I/Q lowpass tail is stored folded
    [C, 2*(Nl-1)] and seen as the decimator's [2C, Nl-1] rows."""

    bp_tail: torch.Tensor    # [C, Nb-1] bandpass input history
    mpx_tail: torch.Tensor   # [C, delay] MPX delay-line history
    phase: torch.Tensor      # [C] PLL phase (rad)
    freq: torch.Tensor       # [C] PLL frequency offset from f_nom
    dec_tail: torch.Tensor   # [C, 2*(Nl-1)] folded I/Q lowpass history


def rds_decim_for(audio_sps: int, half: int) -> int:
    """Largest power-of-two decimation that divides the per-hop audio
    block and keeps the baseband rate >= MIN_BASEBAND_SPS."""
    d = 1
    while (d * 2 <= half and half % (d * 2) == 0
           and audio_sps / (d * 2) >= MIN_BASEBAND_SPS):
        d *= 2
    return d


def make_rds_params(audio_sps: int, half: int) -> RDSParams:
    """Constants for an audio rate and per-hop block size.  The pilot
    constants are the stereo decoder's; the post-mix lowpass is a
    Hamming windowed-sinc with a 1.6 kHz transition (~3.3*fs/1600
    taps), ~40+ dB down by 4 kHz."""
    sp = make_stereo_params(audio_sps)
    fs = float(audio_sps)
    n = (int(3.3 * fs / 1600.0)) | 1
    return RDSParams(bp_taps=sp.taps, delay=sp.delay, f_nom=sp.f_nom,
                     lp_taps=design_lowpass(n, 2.0 * 3200.0 / fs),
                     decim=rds_decim_for(audio_sps, half))


def init_rds_state(num_channels: int, params: RDSParams | None,
                   device="cpu") -> RDSState:
    """All-zero carries; with ``params=None`` (rds off) every tail is
    zero-width."""
    nb = params.bp_taps.shape[0] if params is not None else 1
    d = params.delay if params is not None else 0
    nl = params.lp_taps.shape[0] if params is not None else 1

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    c = num_channels
    return RDSState(bp_tail=z(c, nb - 1), mpx_tail=z(c, d), phase=z(c),
                    freq=z(c), dec_tail=z(c, 2 * (nl - 1)))


def rds_baseband(dec_tail: torch.Tensor, params: RDSParams,
                 iq: torch.Tensor, fm_mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 57 kHz downmix [2C, T] (rows I0, Q0, I1, ...) -> (new folded
    dec_tail [C, 2*(Nl-1)], int8 baseband [C, 2, T/decim]): lowpass,
    decimate, zero the rows with fm_mask False, normalize each channel's
    block to INT8_TARGET_RMS and round half to even (``jnp.round``)."""
    c = fm_mask.shape[0]
    nl = params.lp_taps.shape[0]
    dec_in = DecimatorState(tail=dec_tail.reshape(2 * c, nl - 1))
    dec_st, bb = polyphase_decimate(dec_in, iq, params.lp_taps, params.decim)
    bb = bb.reshape(c, 2, -1) * torch.where(fm_mask, 1.0, 0.0)[:, None, None]
    rms = torch.sqrt(torch.mean(bb * bb, dim=(1, 2), keepdim=True))
    # a true division (``scalar / tensor`` would multiply by a rounded
    # reciprocal); the numerator filled on the device, since a tensor
    # made from a Python number is copied from the host, which a CUDA
    # graph's capture refuses
    scale = torch.full((), INT8_TARGET_RMS, dtype=rms.dtype,
                       device=rms.device) / (rms + 1e-9)
    q = torch.clamp(torch.round(bb * scale), -127.0, 127.0).to(torch.int8)
    return dec_st.tail.reshape(c, 2 * (nl - 1)), q


def rds_from_pilot(dec_tail: torch.Tensor, params: RDSParams,
                   xd: torch.Tensor, ph: torch.Tensor, fm_mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Delayed MPX [C, T] + tracked pilot phase [C, T] -> (new folded
    dec_tail, int8 baseband [C, 2, T/decim]): the 57 kHz complex downmix
    z = 2 * xd * exp(-3j * ph) in plain PyTorch, then ``rds_baseband``.
    (The main path forms the downmix inside K-PILOT instead.)"""
    return rds_baseband(dec_tail, params, rds_mix_plain(xd, ph), fm_mask)


def rds_process(state: RDSState, params: RDSParams, x: torch.Tensor,
                fm_mask: torch.Tensor) -> tuple[RDSState, torch.Tensor]:
    """MPX stream [C, T] -> (state, int8 baseband [C, 2, T/decim]):
    the pilot front end, K-PILOT's PLL and 57 kHz downmix in one launch,
    then ``rds_baseband``.  Streaming-continuous across steps; rows with
    fm_mask False come out as zeros."""
    new_bp, new_mpx, y, xd = pilot_front_end(
        state.bp_tail, state.mpx_tail, params.bp_taps, x)
    phase, freq, _, _, iq = pilot_mix(state.phase, state.freq, params.f_nom,
                                      y, xr=xd)
    dec_tail, q = rds_baseband(state.dec_tail, params, iq, fm_mask)
    return RDSState(bp_tail=new_bp, mpx_tail=new_mpx, phase=phase,
                    freq=freq, dec_tail=dec_tail), q
