"""Batched frequency-domain channelizer + demodulators (USB/LSB/AM/FM).

The reference runs one demod job per client per frame
(src/signal.cpp:102-298, dispatched from src/websocket.cpp:156-185).
Here every listener is a row of a dense channel table and one batched
computation serves all of them; inactive rows are masked.

Exact reference semantics implemented (with file:line cites):

- Channel slice: client sees ``buf = &spectrum[(l + base_idx) % R]``
  and indexes up to audio_fft_size bins beyond it, relying on the
  DC-wrap tail copy for IQ (src/fft.cpp:91-98, src/websocket.cpp:156-185).
  Here the wrap is done by index: bins past R read ``spectrum[i - R]``
  for IQ and zero for real input, so the spectrum is never extended.
- USB: spectrum bins [m, m+A) -> c2r IFFT input bins from 0
  (src/signal.cpp:126-138).  FFTW c2r of size A only reads bins
  [0, A/2], so only A/2+1 bins matter.
- LSB: reversed bins (m - k -> k), c2r IFFT, then time reversal
  (src/signal.cpp:139-156).
- AM/FM: positive bins [m, m+A/2) -> [0, A/2), negative bins
  (m - j -> A - j) -> c2c IFFT (src/signal.cpp:173-214).
- Parity fix-up: on odd frames the waveform is negated when
  (m even and IQ input) or (m odd and real input)
  (src/signal.cpp:160-168, 223-234).
- Overlap-add of the first half with the saved second half of the
  previous frame (src/signal.cpp:170-172, 235-241, 274-275).
- AM: PLL carrier-synchronous detection (src/signal.cpp:242-252) with
  the envelope sqrt(re^2+im^2) fallback (src/signal.cpp:253-257,
  src/utils/dsp.cpp:116-126) available per client via ``am_env``.
  The PLL is a per-sample recursion: kernel K-PLL on the card
  (ops/cuda/pll.py).
- FM: polar discriminator arg(x[i] * conj(x[i-1])) seeded with the last
  output sample of the previous frame (src/signal.cpp:259-263,
  src/utils/dsp.cpp:27-35).
- Average slice power: sum |bin|^2 over [l, r) (src/signal.cpp:117-119).

All IFFTs follow FFTW's unnormalized backward convention.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.pll import am_sync_detect  # noqa: F401  (re-exported)

# Demodulation mode codes (reference src/client.h:43 enum demodulation_mode)
MODE_USB = 0
MODE_LSB = 1
MODE_AM = 2
MODE_FM = 3


class ChannelTable(NamedTuple):
    """Dense per-channel tuning state; one row per (possible) listener.

    l, r: slice bounds in display-order bins (0 <= l <= r < R),
    m_idx: floor(mid) in display-order bins, mode: MODE_*, active: row
    is a live listener, am_env: AM envelope opt-out of the PLL, rds: the
    listener's {"cmd":"rds"} opt-in, nr: its {"cmd":"nr"} opt-in.
    ``need_pll``, ``need_rds`` and ``need_nr`` are decided on the host
    from the same table (some active AM row wants the PLL; some active
    FM row wants RDS; some active row wants noise reduction), so the
    step never waits on the device to choose whether to run those
    stages.  A skipped stage leaves its carries stale, as the JAX
    package's lax.cond does.
    """

    l: torch.Tensor       # [C] int32
    r: torch.Tensor       # [C] int32
    m_idx: torch.Tensor   # [C] int32
    mode: torch.Tensor    # [C] int32
    active: torch.Tensor  # [C] bool
    am_env: torch.Tensor  # [C] bool
    rds: torch.Tensor     # [C] bool
    nr: torch.Tensor      # [C] bool
    need_pll: bool
    need_rds: bool
    need_nr: bool


class ChannelState(NamedTuple):
    """Per-channel demod carry (the reference's per-client scratch).

    Frame parity is global, not per client (src/websocket.cpp:180-182),
    so there is no per-channel frame counter here.
    """

    ssb_prev: torch.Tensor      # [C, A/2] f32 (audio_real_prev, signal.cpp:274)
    cplx_prev: torch.Tensor     # [C, A/2] c64 (audio_complex_baseband_prev)
    fm_prev: torch.Tensor       # [C] c64      (prev sample for discriminator)
    carrier_prev: torch.Tensor  # [C, A/2] c64 (carrier overlap, AM sync path)
    pll_phase: torch.Tensor     # [C] f32      (NCO phase, AM sync path)
    pll_freq: torch.Tensor      # [C] f32      (NCO frequency, AM sync path)


def init_channel_state(num_channels: int, audio_fft_size: int,
                       device="cpu") -> ChannelState:
    c, h = num_channels, audio_fft_size // 2

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ChannelState(
        ssb_prev=z((c, h), torch.float32),
        cplx_prev=z((c, h), torch.complex64),
        fm_prev=z((c,), torch.complex64),
        carrier_prev=z((c, h), torch.complex64),
        pll_phase=z((c,), torch.float32),
        pll_freq=z((c,), torch.float32),
    )


def extend_spectrum(spec: torch.Tensor, is_real: bool, fft_result_size: int,
                    audio_max_fft_size: int) -> torch.Tensor:
    """Append the DC-wrap tail: ext[R:R+A] = spec[0:A] for IQ, zeros for
    real input (src/fft.cpp:91-98).  The main path wraps by index
    instead (``gather_channel_bins``); this form is kept for tests."""
    r, a = fft_result_size, audio_max_fft_size
    spec = spec[..., :r]
    if is_real:
        tail = torch.zeros(spec.shape[:-1] + (a,), dtype=spec.dtype,
                           device=spec.device)
    else:
        tail = spec[..., :a]
    return torch.cat([spec, tail], dim=-1)


def gather_channel_bins(
    spec: torch.Tensor,
    chans: ChannelTable,
    *,
    audio_fft_size: int,
    fft_result_size: int,
    base_idx: int,
    is_real: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three dense bin gathers, straight from the spectrum.

    spec: [B, R'] natural-order normalized spectra (not extended).
    Returns (ssb_bins [B, C, A/2+1], cplx_bins [B, C, A],
    avg_power [B, C]) -- the values the JAX package gathers from the
    extended spectrum, index for index (including its clamp to the
    extended length).
    """
    a = audio_fft_size
    half = a // 2
    r = fft_result_size
    dev = spec.device
    start = (chans.l + base_idx) % r
    audio_r = chans.r - chans.l
    m_rel = chans.m_idx - chans.l

    def gather(rel_idx, valid):
        """[C, K] slice-relative bins -> [B, C, K] values (one gather)."""
        idx = (start[:, None] + rel_idx).clamp(0, r + a - 1)
        if is_real:
            valid = valid & (idx < r)          # the zero tail
            idx = idx.clamp_max(r - 1)
        else:
            idx = idx % r                      # the DC wrap
        vals = spec[:, idx]                    # [B, C, K]
        return torch.where(valid[None], vals, 0)

    # ---- average slice power (signal.cpp:117-119) ----
    k_a = torch.arange(a, dtype=torch.int32, device=dev)
    slice_vals = gather(k_a[None, :].expand(chans.l.shape[0], a),
                        k_a[None, :] < audio_r[:, None])
    avg_power = torch.sum(slice_vals.real * slice_vals.real
                          + slice_vals.imag * slice_vals.imag, dim=-1)

    # ---- SSB bins (signal.cpp:126-156) ----
    k_r = torch.arange(half + 1, dtype=torch.int32, device=dev)
    is_lsb = (chans.mode == MODE_LSB)[:, None]
    ssb_rel = torch.where(is_lsb, m_rel[:, None] - k_r[None, :],
                          m_rel[:, None] + k_r[None, :])
    ssb_valid = (ssb_rel >= 0) & (ssb_rel < audio_r[:, None])
    ssb_bins = gather(ssb_rel, ssb_valid)                # [B, C, A/2+1]

    # ---- AM/FM bins (signal.cpp:173-214) ----
    t = torch.arange(a, dtype=torch.int32, device=dev)
    is_pos = t[None, :] < half
    is_neg = t[None, :] > half
    cplx_rel = torch.where(is_pos, m_rel[:, None] + t[None, :],
                           m_rel[:, None] - (a - t)[None, :])
    cplx_valid = ((is_pos | is_neg) & (cplx_rel >= 0)
                  & (cplx_rel < audio_r[:, None]))
    cplx_bins = gather(cplx_rel, cplx_valid)             # [B, C, A]
    return ssb_bins, cplx_bins, avg_power


def demodulate_from_bins(
    ssb_bins: torch.Tensor,
    cplx_bins: torch.Tensor,
    chans: ChannelTable,
    state: ChannelState,
    frame0: int,
    *,
    audio_fft_size: int,
    is_real: bool,
    am_sync: bool = False,
    carrier_cutoff: int = 0,
) -> tuple[ChannelState, torch.Tensor]:
    """Batched IFFTs, parity fix-up, overlap-add and the per-mode demod
    math for all hops of a step.  Returns (state, audio [B, C, A/2]).

    The overlap-add and FM seeds are batched shifts (hop h's carry-in is
    hop h-1's second half, already in the batch); the AM PLL runs over
    each channel's continuous stream of the whole step.
    """
    a = audio_fft_size
    half = a // 2
    b = ssb_bins.shape[0]
    c = chans.l.shape[0]
    dev = ssb_bins.device
    is_lsb = (chans.mode == MODE_LSB)[None, :, None]
    t = torch.arange(a, device=dev)

    # c2r reads only the real part of the DC and Nyquist bins (as FFTW
    # and pocketfft do); zero their imaginary parts so every FFT
    # library computes the same thing
    edge = torch.ones(half + 1, device=dev)
    edge[0] = edge[half] = 0.0
    ssb_bins = torch.complex(ssb_bins.real, ssb_bins.imag * edge)
    ssb_wave = torch.fft.irfft(ssb_bins, n=a, norm="forward")   # [B, C, A]
    ssb_wave = torch.where(is_lsb, ssb_wave.flip(-1), ssb_wave)
    cplx_wave = torch.fft.ifft(cplx_bins, norm="forward")

    # ---- parity fix-up, vectorized over hops (signal.cpp:160-168) ----
    m_even = (chans.m_idx % 2) == 0
    parity_mode = ~m_even if is_real else m_even
    odd = (torch.arange(b, device=dev) + frame0) % 2 == 1
    negate = odd[:, None] & parity_mode[None, :]
    sgn = torch.where(negate, -1.0, 1.0)[:, :, None]     # [B, C, 1]
    ssb_wave = ssb_wave * sgn
    cplx_wave = cplx_wave * sgn

    # ---- overlap-add as a batched shift (signal.cpp:170-172) ----
    ssb_out = ssb_wave[:, :, :half] + torch.cat(
        [state.ssb_prev[None], ssb_wave[:-1, :, half:]])
    cplx_out = cplx_wave[:, :, :half] + torch.cat(
        [state.cplx_prev[None], cplx_wave[:-1, :, half:]])

    env_audio = torch.sqrt(cplx_out.real * cplx_out.real
                           + cplx_out.imag * cplx_out.imag)
    new_carrier_prev = state.carrier_prev
    pll_phase, pll_freq = state.pll_phase, state.pll_freq
    am_audio = env_audio
    # the PLL stage runs only when some active AM listener wants carrier
    # sync; otherwise its carries go stale (the next one re-locks or is
    # reset-zeroed), as in the JAX package's lax.cond
    if am_sync and chans.need_pll:
        keep = (t < carrier_cutoff) | (t >= a - carrier_cutoff)
        car_wave = torch.fft.ifft(torch.where(keep, cplx_bins, 0),
                                  norm="forward") * sgn
        car_out = car_wave[:, :, :half] + torch.cat(
            [state.carrier_prev[None], car_wave[:-1, :, half:]])
        # the PLL runs over each channel's continuous stream of the step
        car_flat = car_out.permute(1, 0, 2).reshape(c, b * half)
        base_flat = cplx_out.permute(1, 0, 2).reshape(c, b * half)
        am_flat, pll_phase, pll_freq = am_sync_detect(
            car_flat, base_flat, state.pll_phase, state.pll_freq)
        am = am_flat.reshape(c, b, half).permute(1, 0, 2)
        # per-client envelope opt-out of the carrier sync
        am_audio = torch.where(chans.am_env[None, :, None], env_audio, am)
        new_carrier_prev = car_wave[-1, :, half:].clone()

    # ---- FM discriminator: the cross-hop seed is in-batch too ----
    flat = cplx_out.permute(1, 0, 2).reshape(c, b * half)
    prev_flat = torch.cat([state.fm_prev[:, None], flat[:, :-1]], dim=1)
    fm_audio = (torch.angle(flat * torch.conj(prev_flat))
                .reshape(c, b, half).permute(1, 0, 2))

    mode = chans.mode[None, :, None]
    audio = torch.where(mode == MODE_AM, am_audio,
                        torch.where(mode == MODE_FM, fm_audio, ssb_out))
    # Non-finite guard (the reference drops the frame,
    # signal.cpp:266-271): isfinite, not isnan -- a surviving +-inf would
    # turn the DC blocker's cumsum into inf - inf = NaN and poison the
    # AGC gain carry for good.
    audio = torch.where(torch.isfinite(audio), audio, 0.0)

    new_state = ChannelState(
        ssb_prev=ssb_wave[-1, :, half:].clone(),
        cplx_prev=cplx_wave[-1, :, half:].clone(),
        fm_prev=flat[:, -1].clone(),
        carrier_prev=new_carrier_prev,
        pll_phase=pll_phase,
        pll_freq=pll_freq,
    )
    return new_state, audio


def demodulate_batch(
    spec: torch.Tensor,
    chans: ChannelTable,
    state: ChannelState,
    frame0: int,
    *,
    audio_fft_size: int,
    fft_result_size: int,
    base_idx: int,
    is_real: bool,
    am_sync: bool = False,
    carrier_cutoff: int = 0,
) -> tuple[ChannelState, torch.Tensor, torch.Tensor]:
    """All-hops batched demodulation: [B, R'] spectra -> (state,
    audio [B, C, A/2], avg_power [B, C])."""
    ssb_bins, cplx_bins, avg_power = gather_channel_bins(
        spec, chans, audio_fft_size=audio_fft_size,
        fft_result_size=fft_result_size, base_idx=base_idx,
        is_real=is_real)
    new_state, audio = demodulate_from_bins(
        ssb_bins, cplx_bins, chans, state, frame0,
        audio_fft_size=audio_fft_size, is_real=is_real, am_sync=am_sync,
        carrier_cutoff=carrier_cutoff)
    return new_state, audio, avg_power


def float_to_int16(audio: torch.Tensor,
                   mult: float = 65536.0 / 4.0) -> torch.Tensor:
    """Round-half-up float -> int16 (reference src/utils/dsp.cpp:152-165).

    out = clamp((int)(x*mult + 32768.5) - 32768, -32768, 32767).
    ``torch.round`` would round half to even; floor(x + 0.5) does not.
    """
    v = torch.floor(audio * mult + 32768.5) - 32768.0
    return torch.clamp(v, -32768.0, 32767.0).to(torch.int16)
