"""The hop pipeline in PyTorch: the server's DSP engine for one device.

One ``HopPipeline.step`` processes ``hop_batch`` hops:

  raw wire ints -> on-device format convert -> 50%-overlap framing ->
  Hann window -> batched forward FFT (X/N) -> waterfall power/int8
  pyramid of the cadence-due hops (kernel K-WF) -> channel bin gathers
  (DC wrap by index) -> batched IFFTs + USB/LSB/AM/FM demod (AM carrier
  PLL: kernel K-PLL) -> DC blocker -> look-ahead AGC + int16 (kernel
  K-AGC) -> one packed int8 output buffer.

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
from .ops.channelizer import (
    MODE_AM, ChannelState, ChannelTable, demodulate_batch, init_channel_state,
)
from .ops.cuda.agc import agc_int16
from .ops.cuda.waterfall import pyramid_width, waterfall_rows
from .ops.fft import forward_spectrum, frame_hops
from .ops.windows import hann_window

WATERFALL_MODES = ("views", "full", "off")


class AudioState(NamedTuple):
    """All per-channel carries (one row per channel-table row)."""

    chan: ChannelState
    dc: DCBlockerState
    agc: AGCState


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
    audio: torch.Tensor      # [B, C, A/2] int16 (a view into packed)
    avg_power: torch.Tensor  # [B, C] f32 (a view into packed)
    wf: torch.Tensor         # [D, W, view_cap] int8 client waterfall views
    #                          (a view into packed; D = 0 unless 'views')
    pyramid: torch.Tensor    # [B, P] full int8 pyramid ('full' mode only)
    packed: torch.Tensor     # [X] int8: audio|avg_power|wf, the one buffer
    #                          the serving loop copies to the host


def alloc_packed(b: int, c: int, half: int, d: int, w: int, cap: int,
                 device) -> tuple[torch.Tensor, ...]:
    """The step's packed output buffer and its typed views
    (packed, audio16 [B, C, half], pwr [B, C], wf [D, W, cap]); the
    stages write straight into the views, so the JAX package's
    pack_outputs concatenation has no counterpart here.  ``unpack_outputs`` is the
    host-side inverse."""
    na, npw = b * c * half * 2, b * c * 4
    packed = torch.empty(na + npw + d * w * cap, dtype=torch.int8,
                         device=device)
    audio16 = packed[:na].view(torch.int16).view(b, c, half)
    pwr = packed[na:na + npw].view(torch.float32).view(b, c)
    wf = packed[na + npw:].view(d, w, cap)
    return packed, audio16, pwr, wf


def unpack_outputs(packed: np.ndarray, b: int, c: int, half: int,
                   d: int, w: int, cap: int):
    """Host-side inverse of ``alloc_packed`` (zero-copy numpy views):
    (audio [B, C, half] int16, pwr [B, C] f32, wf [D, W, cap] int8)."""
    na, npw = b * c * half * 2, b * c * 4
    audio = packed[:na].view(np.int16).reshape(b, c, half)
    pwr = packed[na:na + npw].view(np.float32).reshape(b, c)
    wf = packed[na + npw:na + npw + d * w * cap].view(np.int8).reshape(
        d, w, cap)
    return audio, pwr, wf


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


def init_audio_state(cfg: ServerConfig, num_channels: int, agc_window: int,
                     dc_delay: int, device) -> AudioState:
    return AudioState(
        chan=init_channel_state(num_channels, cfg.audio_fft_size, device),
        dc=init_dc_state(num_channels, dc_delay, device),
        agc=init_agc_state(num_channels, agc_window, device),
    )


def map_rows(fn, audio: AudioState) -> AudioState:
    """Apply fn(tensor, group) to every per-channel carry, where group
    is 'chan', 'dc' or 'agc'."""
    return AudioState(*(
        type(part)(*(fn(x, name) for x in part))
        for name, part in zip(AudioState._fields, audio)))


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
    out16: torch.Tensor,         # [B, C, A/2] int16, written in place
) -> tuple[AudioState, torch.Tensor]:
    """Demod + DC/AGC/int16 chain over the B hops of a step.

    Returns (state, avg_power [B, C]); the int16 audio goes to out16.

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
    if reset is not None:
        masks = {"chan": reset == 1, "dc": reset == 1, "agc": reset >= 1}

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
    agc_st = agc_int16(audio_state.agc, stream.contiguous(), agc_params,
                       out16)
    return AudioState(chan=chan_st, dc=dc_st, agc=agc_st), pwr


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
        k rows.

        The state half of active-channel bucketing: the driver runs the
        step at the smallest configured bucket >= the highest active
        slot.  Carries of retained rows are untouched; rows dropped by a
        shrink belong to inactive slots, and a reused slot is re-zeroed
        by the registry's one-shot RESET_FULL mask, so zero-padding on
        regrow is exact."""
        def conv(x, _group):
            if x.shape[0] >= k:
                return x[:k]
            pad = torch.zeros((k - x.shape[0],) + tuple(x.shape[1:]),
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
        packed, audio16, pwr_out, wf = alloc_packed(
            b, c, half, d, w, self.view_cap, self.device)

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
            state.frame, reset, audio16)
        pwr_out.copy_(pwr)
        return (HopState(frame=state.frame + b, audio=audio_st),
                HopOutputs(audio=audio16, avg_power=pwr_out, wf=wf,
                           pyramid=pyr, packed=packed))


def channels_from_numpy(l, r, m_idx, mode, active, am_env=None,
                        device="cpu") -> ChannelTable:
    """Host-side helper: build a device ChannelTable from numpy arrays
    (and decide on the host whether the AM PLL stage must run)."""
    am_env = np.zeros(np.shape(l), bool) if am_env is None else am_env
    need_pll = bool(np.any(np.asarray(active, bool)
                           & (np.asarray(mode) == MODE_AM)
                           & ~np.asarray(am_env, bool)))
    i32, b8 = torch.int32, torch.bool
    return ChannelTable(
        l=to_device(l, i32, device), r=to_device(r, i32, device),
        m_idx=to_device(m_idx, i32, device),
        mode=to_device(mode, i32, device),
        active=to_device(active, b8, device),
        am_env=to_device(am_env, b8, device), need_pll=need_pll)
