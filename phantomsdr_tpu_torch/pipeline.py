"""The hop pipeline in PyTorch: the server's DSP engine for one device.

One ``HopPipeline.step`` processes ``hop_batch`` hops:

  raw wire ints -> on-device format convert -> 50%-overlap framing ->
  Hann window -> batched forward FFT (X/N) -> waterfall power/int8
  pyramid of the cadence-due hops (kernel K-WF) -> channel bin gathers
  (DC wrap by index) -> batched IFFTs + USB/LSB/AM/FM demod (AM carrier
  PLL: kernel K-PLL) -> DC blocker -> look-ahead AGC + int16 (kernel
  K-AGC) -> one packed int8 output buffer.

With any of the WBFM broadcast options on (``[input] stereo``, ``rds``,
``deemphasis``, Opus at a rate that device decimation reaches), K-AGC
writes the gained stream as float32 instead, and it goes on through, in
the JAX package's order: the RDS tap (pilot PLL and 57 kHz downmix:
kernel K-PILOT; lowpass, decimate, int8), the stereo demix (K-PILOT,
sharing the RDS tap's pilot when both are on), de-emphasis (kernel
K-DEEMPH), Opus decimation, and only then int16.  With ``[input] nr``
the listeners' noise processor runs between the RDS tap and the stereo
demix, on the float stream too: spectral NR (its frame recursion:
kernel K-NR), LMS NR / auto-notch (kernel K-ANR) or the noise blanker
(kernel K-NB).

It replaces, in order: src/fft.cpp:10-119 (fft_task), src/fft_impl.cpp
(FFTW backend + quantize kernels), src/fft_cuda.cu,
src/signal.cpp:102-298 (send_audio for every client at once),
src/utils.h:139-169 + src/utils/audioprocessing.cpp (DC/AGC),
src/utils/dsp.cpp (demod kernels).

Input convention: the host prepends the previous half-frame (the 50%
overlap halo, hop_size wire samples) to every raw block, so a block is
``(hop_batch + 1) * hop_size`` wire samples and the device carries no
sample history.

The device is explicit: ``HopPipeline(cfg)`` runs on ``cuda`` and
raises where there is none; ``device="cpu"`` runs every kernel's plain
PyTorch version (the tests use it).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import ServerConfig
from .ops import convert
from .ops.agc import (
    AGCState, DCBlockerState, dc_blocker, dc_blocker_delay, init_agc_state,
    init_dc_state, make_agc_params,
)
from .ops.anr import ANRParams, anr_process, init_anr_state, make_anr_params
from .ops.channelizer import (
    MODE_AM, MODE_FM, ChannelState, ChannelTable, demodulate_batch,
    float_to_int16, init_channel_state,
)
from .ops.cuda.agc import agc_float, agc_int16
from .ops.cuda.pilot import pilot_mix
from .ops.cuda.waterfall import pyramid_width, waterfall_rows
from .ops.deemph import deemph_alpha, deemph_process
from .ops.fft import forward_spectrum, frame_hops
from .ops.nb import NBParams, init_nb_state, make_nb_params, nb_process
from .ops.nr import (
    NRParams, NRState, init_nr_state, make_nr_params, nr_process,
)
from .ops.polyphase import (
    DecimatorState, decimator_taps, init_decimator_state, polyphase_decimate,
)
from .ops.rds import (
    RDSParams, RDSState, init_rds_state, make_rds_params, rds_baseband,
    rds_process,
)
from .ops.stereo import (
    StereoParams, StereoState, delay_stream, init_stereo_state,
    make_stereo_params, pilot_bandpass, stereo_decode,
)
from .ops.windows import hann_window

WATERFALL_MODES = ("views", "full", "off")


class AudioState(NamedTuple):
    """All per-channel carries (one row per channel-table row; the
    decimator and de-emphasis rows are per stream: L0, R0, L1, R1, ...
    with stereo).  The carries of stages that are off are zero-width."""

    chan: ChannelState
    dc: DCBlockerState
    agc: AGCState
    dec: DecimatorState  # Opus decimation filter tail ([C*nch, 0] if off)
    st: StereoState      # WBFM stereo carries
    nr: NRState          # noise-reduction carries: NRState (spectral),
    #                      ANRState (lms/notch) or NBState (nb); an
    #                      NRState of zero-width rows when nr is off
    rds: RDSState        # RDS subcarrier carries
    de: torch.Tensor     # [C*nch] de-emphasis carry y[-1]


class HopState(NamedTuple):
    frame: int               # global hop counter (only its parity is read)
    audio: AudioState


class WaterfallViews(NamedTuple):
    """Per-waterfall-client view table (device side of the host registry).

    Client w sees pyramid_flat[start[w] : start[w] + length[w]] where
    start already folds in the pyramid level offset.  Gathering the
    client views on device ships O(W * waterfall_size) bytes per due
    hop instead of the whole pyramid.
    """

    start: torch.Tensor   # [W] int32 flat start (level offset + l)
    length: torch.Tensor  # [W] int32 view length (r - l)


class HopOutputs(NamedTuple):
    audio: torch.Tensor      # [B, C, nch*A/2] int16 (a view into packed),
    #                          or with device Opus decimation the
    #                          continuous streams [C, nch*B*A/2/decim];
    #                          nch = 2 with stereo (L/R interleaved)
    avg_power: torch.Tensor  # [B, C] f32 (a view into packed)
    wf: torch.Tensor         # [D, W, view_cap] int8 client waterfall views
    #                          (a view into packed; D = 0 unless 'views')
    pyramid: torch.Tensor    # [B, P] full int8 pyramid ('full' mode only)
    rds: torch.Tensor        # [C, 2, rds_t] int8 RDS baseband (a view into
    #                          packed; rds_t = 0 unless [input] rds)
    packed: torch.Tensor     # [X] int8: audio|avg_power|wf|rds, the one
    #                          buffer the serving loop copies to the host


def audio_shape(b: int, c: int, half: int, decim: int = 1,
                nch: int = 1) -> tuple[int, ...]:
    """Shape of a step's int16 audio: per hop [B, C, nch*half], or with
    device Opus decimation (decim > 1) each channel's continuous stream
    [C, nch*B*half/decim]; nch = 2 interleaves L/R."""
    if decim > 1:
        return (c, nch * b * half // decim)
    return (b, c, nch * half)


def alloc_packed(b: int, c: int, half: int, d: int, w: int, cap: int,
                 device, decim: int = 1, nch: int = 1,
                 rds_t: int = 0) -> tuple[torch.Tensor, ...]:
    """The step's packed output buffer and its typed views (packed,
    audio16 ``audio_shape``, pwr [B, C], wf [D, W, cap], rds [C, 2,
    rds_t]), in the JAX package's pack_outputs layout; the stages write
    straight into the views, so its concatenation has no counterpart
    here.  ``unpack_outputs`` is the host-side inverse."""
    ashape = audio_shape(b, c, half, decim, nch)
    na, npw, nwf = int(np.prod(ashape)) * 2, b * c * 4, d * w * cap
    packed = torch.empty(na + npw + nwf + c * 2 * rds_t, dtype=torch.int8,
                         device=device)
    audio16 = packed[:na].view(torch.int16).view(ashape)
    pwr = packed[na:na + npw].view(torch.float32).view(b, c)
    wf = packed[na + npw:na + npw + nwf].view(d, w, cap)
    rds = packed[na + npw + nwf:].view(c, 2, rds_t)
    return packed, audio16, pwr, wf, rds


def unpack_outputs(packed: np.ndarray, b: int, c: int, half: int,
                   d: int, w: int, cap: int, decim: int = 1, nch: int = 1,
                   rds_t: int = 0):
    """Host-side inverse of ``alloc_packed`` (zero-copy numpy views):
    (audio int16 ``audio_shape``, pwr [B, C] f32, wf [D, W, cap] int8,
    rds [C, 2, rds_t] int8 or None when rds_t is 0)."""
    ashape = audio_shape(b, c, half, decim, nch)
    na, npw, nwf = int(np.prod(ashape)) * 2, b * c * 4, d * w * cap
    audio = packed[:na].view(np.int16).reshape(ashape)
    pwr = packed[na:na + npw].view(np.float32).reshape(b, c)
    wf = packed[na + npw:na + npw + nwf].view(np.int8).reshape(d, w, cap)
    rds = (packed[na + npw + nwf:].view(np.int8).reshape(c, 2, rds_t)
           if rds_t else None)
    return audio, pwr, wf, rds


def to_device(a, dtype: torch.dtype | None, device) -> torch.Tensor:
    """Host array -> device tensor (of ``dtype``, or the array's own).
    For a CUDA device the copy goes through pinned memory without
    blocking, so it never waits for the work already queued on the
    stream."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def opus_decim_taps(cfg: ServerConfig) -> np.ndarray | None:
    """Anti-alias prototype for the device Opus decimator (None when
    decimation is off or left to the host)."""
    return (decimator_taps(cfg.opus_decim, taps_per_phase=12)
            if cfg.device_decim else None)


def stereo_params_for(cfg: ServerConfig) -> StereoParams | None:
    return make_stereo_params(cfg.audio_sps) if cfg.stereo else None


def rds_params_for(cfg: ServerConfig) -> RDSParams | None:
    return (make_rds_params(cfg.audio_sps, cfg.audio_fft_size // 2)
            if cfg.rds else None)


def deemph_alpha_for(cfg: ServerConfig) -> float | None:
    return (deemph_alpha(cfg.audio_sps, cfg.deemphasis)
            if cfg.deemphasis > 0 else None)


def nr_params_for(cfg: ServerConfig
                  ) -> NRParams | ANRParams | NBParams | None:
    """The configured noise processor's constants: NRParams (spectral,
    the default), ANRParams (LMS NR / auto-notch) or NBParams (noise
    blanker); None when nr is off."""
    if not cfg.nr:
        return None
    if cfg.nr_algo == "nb":
        return make_nb_params(thresh=cfg.nb_thresh, taps=cfg.nb_taps,
                              samples=cfg.nb_samples)
    if cfg.nr_algo in ("lms", "notch"):
        return make_anr_params(notch=cfg.nr_algo == "notch",
                               taps=cfg.nr_taps, delay=cfg.nr_delay,
                               two_mu=cfg.nr_two_mu, gamma=cfg.nr_leakage)
    return make_nr_params(cfg.audio_fft_size // 2, final_gain=cfg.nr_gain,
                          alpha=cfg.nr_alpha, asnr_db=cfg.nr_asnr_db)


def init_nr_carries(cfg: ServerConfig, num_channels: int, device):
    """The noise processor's carries for ``cfg`` (zero-width when off)."""
    params = nr_params_for(cfg)
    if isinstance(params, NBParams):
        return init_nb_state(num_channels, params, device)
    if isinstance(params, ANRParams):
        return init_anr_state(num_channels, params, device)
    return init_nr_state(num_channels,
                         cfg.audio_fft_size // 2 if cfg.nr else 0, device)


def init_audio_state(cfg: ServerConfig, num_channels: int, agc_window: int,
                     dc_delay: int, device) -> AudioState:
    taps = opus_decim_taps(cfg)
    nch = cfg.audio_channels
    return AudioState(
        chan=init_channel_state(num_channels, cfg.audio_fft_size, device),
        dc=init_dc_state(num_channels, dc_delay, device),
        agc=init_agc_state(num_channels, agc_window, device),
        dec=init_decimator_state(num_channels * nch,
                                 taps.shape[0] if taps is not None else 1,
                                 device),
        st=init_stereo_state(num_channels, stereo_params_for(cfg), device),
        nr=init_nr_carries(cfg, num_channels, device),
        rds=init_rds_state(num_channels, rds_params_for(cfg), device),
        de=torch.zeros((num_channels * nch,), dtype=torch.float32,
                       device=device),
    )


def map_rows(fn, audio: AudioState) -> AudioState:
    """Apply fn(tensor, group) to every per-channel carry, where group
    is the AudioState field it belongs to ('chan', 'dc', 'agc', 'dec',
    'st', 'nr', 'rds' or 'de')."""
    def part(x, name):
        if isinstance(x, torch.Tensor):
            return fn(x, name)
        return type(x)(*(fn(v, name) for v in x))
    return AudioState(*(part(x, name)
                        for name, x in zip(AudioState._fields, audio)))


# carries whose rows are per stream (nch per channel), not per channel
PER_STREAM = ("dec", "de")


def spectra_from_raw(cfg: ServerConfig, window: torch.Tensor,
                     raw: torch.Tensor, num_hops: int) -> torch.Tensor:
    """raw wire ints (with hop-size halo prepended) -> [B, R'] normalized
    spectra in natural FFT order."""
    x = convert.to_float(raw, cfg.input_format)
    if not cfg.is_real:
        x = convert.iq_to_complex(x)
    frames = frame_hops(x, num_hops, cfg.fft_size)
    return forward_spectrum(frames, window, cfg.is_real)


def waterfall_from_spectra(cfg: ServerConfig, spec: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """[B, R'] spectra, [D] row indices -> [D, P] flat int8 pyramids."""
    return waterfall_rows(spec, rows, fft_result_size=cfg.fft_result_size,
                          base_idx=cfg.base_idx,
                          levels=cfg.downsample_levels,
                          size_log2=cfg.size_log2)


def gather_waterfall_views(pyr_flat: torch.Tensor, views: WaterfallViews,
                           view_cap: int) -> torch.Tensor:
    """[D, P] flat pyramids + view table -> [D, W, view_cap] int8.

    Positions beyond a view's length are zero-filled; the host slices
    row[:length] before compression.
    """
    j = torch.arange(view_cap, dtype=torch.int32, device=pyr_flat.device)
    idx = views.start[:, None] + j[None, :]                   # [W, cap]
    valid = j[None, :] < views.length[:, None]
    idx = idx.clamp(0, pyr_flat.shape[-1] - 1)
    return torch.where(valid, pyr_flat[:, idx], 0)


def waterfall_due_cap(cfg: ServerConfig) -> int:
    """Static row count of the device waterfall-view gather: the max
    number of hops in one batch that can land on the skip_num cadence
    (src/fft.cpp:33-34,100-105).  ceil(B / skip), at least 1."""
    return max(1, -(-cfg.hop_batch // cfg.skip_num))


def waterfall_due_positions(cfg: ServerConfig, frame0: int = 0) -> list[int]:
    """In-batch hop positions h with (frame0 + h) % skip_num == 0.

    May be empty (skip_num > hop_batch between due frames); the driver
    then runs the step with waterfall='off'.
    """
    skip = cfg.skip_num
    return [h for h in range(cfg.hop_batch) if (frame0 + h) % skip == 0]


def pad_due_positions(due: list[int], cap: int) -> list[int]:
    """Pad a (non-empty) due list to the static gather size by repeating
    the last position; consumers slice [:len(due)] rows."""
    return due + [due[-1]] * (cap - len(due))


def audio_from_spectra(
    cfg: ServerConfig,
    agc_params,
    dc_delay: int,
    audio_state: AudioState,
    spec: torch.Tensor,          # [B, R']
    chans: ChannelTable,
    frame0: int,                 # global index of hop 0
    reset: torch.Tensor | None,  # [C] int32 RESET_* mask
    out16: torch.Tensor,         # int16 audio_shape(...), written in place
    rds_out: torch.Tensor | None = None,  # [C, 2, rds_t] int8, in place
    decim_taps: np.ndarray | None = None,      # device Opus decimation
    stereo_params: StereoParams | None = None,  # device WBFM stereo
    rds_params: RDSParams | None = None,        # device RDS subcarrier
    deemph_a: float | None = None,              # device de-emphasis pole
    nr_params=None,             # NRParams / ANRParams / NBParams
) -> tuple[AudioState, torch.Tensor]:
    """Demod + DC/AGC chain over the B hops of a step, then the opt-in
    WBFM stages and int16.

    Returns (state, avg_power [B, C]); the int16 audio goes to out16 and
    the int8 RDS baseband to rds_out.

    ``reset`` (int32 per runtime.registry.RESET_*): 1 = zero ALL of the
    slot's carries -- a slot newly (re)assigned to a listener
    (src/signal.cpp:8-79 allocates fresh per-client scratch on
    connect).  2 = zero only the AGC state -- the reference's
    agc.reset() on every demodulation command (src/signal.cpp:315-328,
    utils/audioprocessing.cpp:70-74).
    """
    a = cfg.audio_fft_size
    half = a // 2
    b = spec.shape[0]
    c = chans.l.shape[0]
    nch = 2 if stereo_params is not None else 1
    if reset is not None:
        full = reset == 1
        per_stream = full.repeat_interleave(nch) if nch > 1 else full
        masks = {"chan": full, "dc": full, "agc": reset >= 1, "st": full,
                 "nr": full, "rds": full, "dec": per_stream,
                 "de": per_stream}

        def zero_rows(x, group):
            m = masks[group].reshape((-1,) + (1,) * (x.dim() - 1))
            return torch.where(m, torch.zeros((), dtype=x.dtype,
                                              device=x.device), x)
        audio_state = map_rows(zero_rows, audio_state)

    chan_st, audio_f, pwr = demodulate_batch(
        spec, chans, audio_state.chan, frame0,
        audio_fft_size=a, fft_result_size=cfg.fft_result_size,
        base_idx=cfg.base_idx, is_real=cfg.is_real, am_sync=cfg.am_sync,
        carrier_cutoff=500 * a // cfg.audio_sps,  # signal.cpp:217
    )
    # DC blocker + AGC over each channel's CONTINUOUS stream of the step
    # (both carry state across arbitrary block boundaries)
    stream = audio_f.permute(1, 0, 2).reshape(c, b * half)
    dc_st, stream = dc_blocker(audio_state.dc, stream, dc_delay)
    if (decim_taps is None and stereo_params is None and rds_params is None
            and deemph_a is None and nr_params is None):
        agc_st = agc_int16(audio_state.agc, stream.contiguous(), agc_params,
                           out16)
        return audio_state._replace(chan=chan_st, dc=dc_st, agc=agc_st), pwr

    agc_st, stream = agc_float(audio_state.agc, stream.contiguous(),
                               agc_params)
    fm_mask = chans.mode == MODE_FM
    rds_st, st_st = audio_state.rds, audio_state.st
    stereo_done = False
    if rds_params is not None:
        # the RDS tap: the post-AGC MPX, the stream the reference ships
        # to the browser's decoder.  Only active FM rows that sent
        # {"cmd":"rds"} produce baseband; with no such row the stage is
        # skipped and its carries go stale (the JAX package's lax.cond).
        rds_on = chans.active & chans.rds & fm_mask
        if stereo_params is not None:
            # shared pilot: the 19 kHz pilot is bandpassed and tracked
            # once, and K-PILOT forms the stereo demix (against stereo's
            # own mono delay line) and the 57 kHz downmix from the same
            # phase.  make_rds_params reuses make_stereo_params, so the
            # stereo state mirrors the RDS state's pilot carries.
            new_bp, y = pilot_bandpass(rds_st.bp_tail, rds_params.bp_taps,
                                       stream)
            new_mpx, xd = delay_stream(rds_st.mpx_tail, stream)
            new_mono, xm = delay_stream(st_st.mono_tail, stream)
            phase, freq, _, stream, iq = pilot_mix(
                rds_st.phase, rds_st.freq, rds_params.f_nom, y, xs=xm,
                fm_mask=fm_mask, xr=xd if chans.need_rds else None)
            dec_tail = rds_st.dec_tail
            if chans.need_rds:
                dec_tail, q = rds_baseband(dec_tail, rds_params, iq, rds_on)
                rds_out.copy_(q)
            else:
                rds_out.zero_()
            rds_st = RDSState(bp_tail=new_bp, mpx_tail=new_mpx, phase=phase,
                              freq=freq, dec_tail=dec_tail)
            st_st = StereoState(bp_tail=new_bp, mono_tail=new_mono,
                                phase=phase, freq=freq)
            stereo_done = True
        elif chans.need_rds:
            rds_st, q = rds_process(rds_st, rds_params, stream, rds_on)
            rds_out.copy_(q)
        else:
            rds_out.zero_()
    nr_st = audio_state.nr
    if nr_params is not None:
        # the browser runs these on its decoded int16-scale audio, so
        # they run on the stream lifted to that domain (x 65536/4,
        # src/dsp.cpp:152), where spectral NR's integer rounding lands
        # on the same grid; / scale is exact (a power of two).  Only
        # active rows with the {"cmd":"nr"} opt-in take the result.
        scale = 65536.0 / 4.0
        nr_on = (chans.active & chans.nr)[:, None]
        lifted = stream * scale
        if isinstance(nr_params, NRParams):
            # every channel, every step: the noise track stays warm
            # across a listener's toggles
            nr_st, den = nr_process(nr_st, nr_params, lifted, b)
            stream = torch.where(nr_on, den / scale, stream)
        elif chans.need_nr:
            # skipped with no opted-in listener: the carries go stale
            # (a reused slot is zeroed by the reset mask anyway)
            if isinstance(nr_params, NBParams):
                nr_st, den = nb_process(nr_st, nr_params, lifted)
            else:
                nr_st, den = anr_process(nr_st, nr_params, lifted)
            stream = torch.where(nr_on, den / scale, stream)
    if stereo_params is not None and not stereo_done:
        # FM rows get pilot-PLL stereo; other modes pass mono to both ears
        st_st, stream = stereo_decode(st_st, stereo_params, stream, fm_mask)

    de_st = audio_state.de
    if deemph_a is not None:
        # after the RDS tap and the stereo demix (the subcarriers must
        # not see the pole), before decimation, on the per-stream rows
        fm_rows = chans.active & fm_mask
        if nch > 1:
            fm_rows = fm_rows.repeat_interleave(nch)
        de_st, stream = deemph_process(de_st, deemph_a, stream, fm_rows)
    dec_st = audio_state.dec
    if decim_taps is not None:
        # device Opus decimation (the reference clamps the Opus rate
        # without resampling, src/audio.cpp:59); the per-hop framing is
        # gone, as Opus frames span hops anyway
        dec_st, out = polyphase_decimate(dec_st, stream, decim_taps,
                                         cfg.opus_decim)
        if nch > 1:  # [2C, T/f] -> [C, 2*T/f] interleaved L/R
            t2 = out.shape[-1]
            out = out.reshape(c, 2, t2).transpose(1, 2).reshape(c, 2 * t2)
    elif nch > 1:  # [2C, B*half] -> [B, C, 2*half] interleaved L/R per hop
        out = (stream.reshape(c, 2, b, half).permute(2, 0, 3, 1)
               .reshape(b, c, 2 * half))
    else:
        out = stream.reshape(c, b, half).permute(1, 0, 2)
    out16.copy_(float_to_int16(out))
    return AudioState(chan=chan_st, dc=dc_st, agc=agc_st, dec=dec_st,
                      st=st_st, nr=nr_st, rds=rds_st, de=de_st), pwr


class HopPipeline:
    """Single-device hop pipeline."""

    def __init__(self, cfg: ServerConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HopPipeline: no CUDA device is available; "
                               "pass device='cpu' to run the plain "
                               "PyTorch versions of the kernels")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"HopPipeline: unsupported device {device}")
        self.window = torch.from_numpy(hann_window(cfg.fft_size)).to(
            self.device)
        self.agc_params = make_agc_params(cfg.audio_sps)
        self.dc_delay = dc_blocker_delay(cfg.audio_sps)
        self.num_channels = cfg.max_channels
        self.hop_batch = cfg.hop_batch
        # wire scalars per hop: H reals or 2H for IQ
        self.wire_per_hop = cfg.hop_size * (1 if cfg.is_real else 2)
        self.view_cap = cfg.view_cap
        self.due_cap = waterfall_due_cap(cfg)
        self.pyramid_width = pyramid_width(cfg.fft_result_size,
                                           cfg.downsample_levels)
        self.decim_taps = opus_decim_taps(cfg)
        self.decim = cfg.opus_decim if self.decim_taps is not None else 1
        self.stereo_params = stereo_params_for(cfg)
        self.rds_params = rds_params_for(cfg)
        self.deemph_a = deemph_alpha_for(cfg)
        self.nr_params = nr_params_for(cfg)
        # RDS baseband samples per channel per step (0 when off)
        self.rds_t = (cfg.hop_batch * (cfg.audio_fft_size // 2)
                      // self.rds_params.decim
                      if self.rds_params is not None else 0)
        if (self.stereo_params is not None
                and cfg.hop_batch * (cfg.audio_fft_size // 2)
                < self.stereo_params.delay):
            raise ValueError(
                "stereo: per-step audio block shorter than the pilot "
                "bandpass group delay; raise hop_batch")
        self._all_rows = torch.arange(cfg.hop_batch, dtype=torch.int32,
                                      device=self.device)

    # ------------------------------------------------------------------
    def init_state(self, frame0: int = 0) -> HopState:
        """Fresh carries.  frame0 seeds the hop counter when rebuilding
        mid-stream (error recovery / idle resume): only its PARITY is
        consumed (the (-1)^(m*hop) fix-up in demodulate_from_bins), so
        the true stream parity keeps audio polarity continuous across
        the rebuild."""
        return HopState(frame=frame0 & 1, audio=init_audio_state(
            self.cfg, self.num_channels, self.agc_params.window,
            self.dc_delay, self.device))

    def empty_channels(self) -> ChannelTable:
        z = np.zeros(self.num_channels, np.int32)
        return channels_from_numpy(z, z, z, z, z.astype(bool),
                                   device=self.device)

    def resize_channel_rows(self, state: HopState, k: int) -> HopState:
        """Slice (shrink) or zero-pad (grow) every per-channel carry to
        k rows (k * nch for the per-stream decimator and de-emphasis
        rows).

        The state half of active-channel bucketing: the driver runs the
        step at the smallest configured bucket >= the highest active
        slot.  Carries of retained rows are untouched; rows dropped by a
        shrink belong to inactive slots, and a reused slot is re-zeroed
        by the registry's one-shot RESET_FULL mask, so zero-padding on
        regrow is exact."""
        nch = self.cfg.audio_channels

        def conv(x, group):
            kk = k * nch if group in PER_STREAM else k
            if x.shape[0] >= kk:
                return x[:kk]
            pad = torch.zeros((kk - x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, pad])
        return HopState(frame=state.frame, audio=map_rows(conv, state.audio))

    def empty_views(self, num: int = 0) -> WaterfallViews:
        n = num or 1
        z = torch.zeros((n,), dtype=torch.int32, device=self.device)
        return WaterfallViews(start=z, length=z)

    def default_due_idx(self, frame0: int = 0) -> torch.Tensor:
        """[due_cap] int32 gather positions for a given step's frame0."""
        due = waterfall_due_positions(self.cfg, frame0) or [0]
        return to_device(pad_due_positions(due, self.due_cap), torch.int32,
                         self.device)

    # ------------------------------------------------------------------
    def step(self, state: HopState, raw: torch.Tensor, chans: ChannelTable,
             views: WaterfallViews | None = None, waterfall: str = "views",
             reset: torch.Tensor | None = None,
             due_idx: torch.Tensor | None = None,
             ) -> tuple[HopState, HopOutputs]:
        """raw: [(B+1) * wire_per_hop] wire samples (halo prepended by
        the host, ``convert.host_preconvert`` dtype) on this device.

        waterfall: 'views' (serve client views, the production mode),
        'full' (whole pyramid, testing/debug), 'off'.
        reset: [C] int32 RESET_* mask, one-shot carry zeroing.
        due_idx: [due_cap] int32 in-batch hop positions whose waterfall
        views to gather ('views' mode; defaults to the frame0=0 cadence).
        """
        if waterfall not in WATERFALL_MODES:
            raise ValueError(f"waterfall must be one of {WATERFALL_MODES}")
        cfg = self.cfg
        b = self.hop_batch
        c = chans.l.shape[0]
        half = cfg.audio_fft_size // 2
        if views is None:
            views = self.empty_views()
        w = views.start.shape[0]
        d = self.due_cap if waterfall == "views" else 0
        packed, audio16, pwr_out, wf, rds8 = alloc_packed(
            b, c, half, d, w, self.view_cap, self.device, self.decim,
            cfg.audio_channels, self.rds_t)

        spec = spectra_from_raw(cfg, self.window, raw, b)
        pyr = torch.zeros((b, 0), dtype=torch.int8, device=self.device)
        if waterfall == "full":
            pyr = waterfall_from_spectra(cfg, spec, self._all_rows)
        elif waterfall == "views":
            # the pyramid of the cadence-due hops only; the kernel reads
            # those rows of the spectrum in place
            if due_idx is None:
                due_idx = self.default_due_idx()
            pyr_due = waterfall_from_spectra(cfg, spec, due_idx)
            wf.copy_(gather_waterfall_views(pyr_due, views, self.view_cap))

        audio_st, pwr = audio_from_spectra(
            cfg, self.agc_params, self.dc_delay, state.audio, spec, chans,
            state.frame, reset, audio16, rds8, decim_taps=self.decim_taps,
            stereo_params=self.stereo_params, rds_params=self.rds_params,
            deemph_a=self.deemph_a, nr_params=self.nr_params)
        pwr_out.copy_(pwr)
        return (HopState(frame=state.frame + b, audio=audio_st),
                HopOutputs(audio=audio16, avg_power=pwr_out, wf=wf,
                           pyramid=pyr, rds=rds8, packed=packed))


def channels_from_numpy(l, r, m_idx, mode, active, am_env=None, rds=None,
                        nr=None, device="cpu") -> ChannelTable:
    """Host-side helper: build a device ChannelTable from numpy arrays
    (and decide on the host whether the AM PLL, RDS and noise-reduction
    stages must run)."""
    am_env = np.zeros(np.shape(l), bool) if am_env is None else am_env
    rds = np.zeros(np.shape(l), bool) if rds is None else rds
    nr = np.zeros(np.shape(l), bool) if nr is None else nr
    active_np = np.asarray(active, bool)
    mode_np = np.asarray(mode)
    need_pll = bool(np.any(active_np & (mode_np == MODE_AM)
                           & ~np.asarray(am_env, bool)))
    need_rds = bool(np.any(active_np & (mode_np == MODE_FM)
                           & np.asarray(rds, bool)))
    need_nr = bool(np.any(active_np & np.asarray(nr, bool)))
    i32, b8 = torch.int32, torch.bool
    return ChannelTable(
        l=to_device(l, i32, device), r=to_device(r, i32, device),
        m_idx=to_device(m_idx, i32, device),
        mode=to_device(mode, i32, device),
        active=to_device(active, b8, device),
        am_env=to_device(am_env, b8, device), rds=to_device(rds, b8, device),
        nr=to_device(nr, b8, device),
        need_pll=need_pll, need_rds=need_rds, need_nr=need_nr)
