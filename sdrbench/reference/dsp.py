"""Plain reference of the spectrum server's hop step.

Given the raw wire blocks, the listener table and the waterfall views,
it works out again everything the served step derives from them: the
format convert, the 50%-overlap frames and their periodic Hann window,
the forward FFT (X/N), the int8-dB waterfall pyramid of the
cadence-due hops and each view's slice of it, the channel bin gathers,
the SSB/AM/FM IFFTs with their parity fix-up and overlap-add, the AM
carrier PLL, the FM discriminator, the DC blocker, the look-ahead AGC
and the round-half-up int16, and each channel's slice power.  The
semantics are PhantomSDR's (src/fft.cpp, src/fft_impl.cpp,
src/signal.cpp, src/utils.h, src/utils/audioprocessing.cpp,
src/utils/dsp.cpp), written as plain PyTorch for the bulk and NumPy
loops for the two per-sample recursions (the PLL and the AGC gain), in
float32 as the configuration states.

It imports nothing of the program under test and takes nothing the
program made: the plan below is derived from the configuration's
dictionary, and the carries start at zero or are handed in.

``lowp=True`` is the control: the same arithmetic with the spectrum and
the demodulated stream stored in bfloat16 (the storage a faster step
would be tempted to use); it must fail the comparison.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

MODES = {"USB": 0, "LSB": 1, "AM": 2, "FM": 3}
USB, LSB, AM, FM = 0, 1, 2, 3

# 20 * log10(2): dB per power of two; log2 -> dB (src/fft_impl.cpp:42)
DB_PER_OCTAVE = 6.020599913279624
LOG2_TO_DB = 0.3010299956639812 * 20.0
# the carrier PLL's loop gains: liquid's nco pll bandwidth 0.001
# (src/signal.cpp:61): alpha = bw on frequency, beta = sqrt(bw) on phase
PLL_ALPHA = np.float32(0.001)
PLL_BETA = np.float32(0.001 ** 0.5)
TWO_PI = np.float32(2.0 * math.pi)
WIRE = {"u8": (np.uint8, 128.0, True), "s8": (np.int8, 128.0, False),
        "s16": (np.int16, 32768.0, False)}


@dataclass(frozen=True)
class Plan:
    """What the configuration fixes for one step (spectrumserver.cpp's
    derivations)."""

    fmt: str
    is_real: bool
    sps: int
    frequency: int
    n: int              # forward FFT size
    b: int              # hops a step
    c: int              # channel table rows
    r: int              # display bins (fft_result_size)
    a: int              # audio IFFT size
    levels: int         # waterfall pyramid levels
    size_log2: int
    skip: int           # waterfall cadence (every skip-th hop)
    audio_sps: int
    wf_size: int
    am_sync: bool

    @property
    def hop(self) -> int:
        return self.n // 2

    @property
    def half(self) -> int:
        return self.a // 2

    @property
    def base_idx(self) -> int:
        return 0 if self.is_real else self.n // 2 + 1

    @property
    def wire_per_hop(self) -> int:
        return self.hop * (1 if self.is_real else 2)

    @property
    def dc_delay(self) -> int:
        return (self.audio_sps // 750) * 2          # src/signal.cpp:54

    @property
    def agc_window(self) -> int:
        return int(200.0 * self.audio_sps / 1000.0)

    @property
    def agc_coeffs(self) -> tuple[np.float32, np.float32, np.float32]:
        """attack, release, level (audioprocessing.cpp:10-15)."""
        att = 1.0 - np.exp(-1.0 / (50.0 * 0.001 * self.audio_sps))
        rel = 1.0 - np.exp(-1.0 / (300.0 * 0.001 * self.audio_sps))
        return np.float32(att), np.float32(rel), np.float32(0.2)

    @property
    def carrier_cutoff(self) -> int:
        return 500 * self.a // self.audio_sps        # src/signal.cpp:217

    def hz(self, display_bin: float) -> float:
        """Frequency of a display bin (bin 0 is the band's lowest)."""
        df = self.sps / self.n
        if self.is_real:
            return self.frequency + display_bin * df
        return self.frequency - self.sps // 2 + (display_bin + 1) * df

    def level_offsets(self) -> list[int]:
        out, o = [], 0
        for i in range(self.levels):
            out.append(o)
            o += self.r >> i
        return out


def plan(cfg: dict) -> Plan:
    """The plan of a configuration dictionary (the ``config_from_dict``
    layout: ``input`` and ``tpu`` tables)."""
    inp, tpu = cfg["input"], cfg.get("tpu", {})
    n, sps = int(inp["fft_size"]), int(inp["sps"])
    is_real = str(inp.get("signal", "iq")).lower() == "real"
    r = n // 2 if is_real else n
    audio_sps = int(inp.get("audio_sps", 12000))
    wf = int(inp.get("waterfall_size", 1024))
    levels, cur = 0, r
    while cur >= wf:
        levels += 1
        cur //= 2
    if levels == 0:
        levels, wf = 1, r
    fmt = str(inp.get("driver", {}).get("format", "f32")).lower()
    if fmt not in WIRE:
        raise ValueError(f"reference: wire format {fmt} not supported")
    return Plan(
        fmt=fmt, is_real=is_real, sps=sps,
        frequency=int(inp.get("frequency", 0)), n=n,
        b=int(tpu["hop_batch"]), c=int(tpu["max_channels"]), r=r,
        a=math.ceil(audio_sps * n / sps / 4.0) * 4, levels=levels,
        size_log2=int(round(math.log2(n))) + int(
            inp.get("brightness_offset", 0)),
        skip=max(1, int(sps / n / 10.0) * 2), audio_sps=audio_sps,
        wf_size=wf, am_sync=bool(inp.get("am_sync", True)))


def due_rows(p: Plan, frame0: int) -> list[int]:
    """Hops of a step on the waterfall cadence (src/fft.cpp:33, 100)."""
    return [h for h in range(p.b) if (frame0 + h) % p.skip == 0]


class Table(NamedTuple):
    """The listeners, one row per channel slot (numpy)."""

    l: np.ndarray
    r: np.ndarray
    m_idx: np.ndarray
    mode: np.ndarray
    active: np.ndarray
    am_env: np.ndarray


class Views(NamedTuple):
    """The waterfall views: pyramid level, first bin in that level's row,
    and length."""

    level: np.ndarray
    start: np.ndarray
    length: np.ndarray


class Carries(NamedTuple):
    """Per-channel state carried from one step to the next."""

    ssb_prev: torch.Tensor      # [C, A/2] f32
    cplx_prev: torch.Tensor     # [C, A/2] c64
    fm_prev: torch.Tensor       # [C] c64
    carrier_prev: torch.Tensor  # [C, A/2] c64
    pll_phase: np.ndarray       # [C] f32
    pll_freq: np.ndarray        # [C] f32
    dc_tail: torch.Tensor       # [C, 2D-2] f32
    agc_tail: torch.Tensor      # [C, W-1] f32
    agc_gain: np.ndarray        # [C] f32
    agc_seen: np.ndarray        # [C] int64


def zero_carries(p: Plan, device) -> Carries:
    c, h = p.c, p.half

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Carries(
        ssb_prev=z((c, h), torch.float32),
        cplx_prev=z((c, h), torch.complex64),
        fm_prev=z((c,), torch.complex64),
        carrier_prev=z((c, h), torch.complex64),
        pll_phase=np.zeros(c, np.float32), pll_freq=np.zeros(c, np.float32),
        dc_tail=z((c, 2 * p.dc_delay - 2), torch.float32),
        agc_tail=z((c, p.agc_window - 1), torch.float32),
        agc_gain=np.zeros(c, np.float32), agc_seen=np.zeros(c, np.int64))


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and back (complex: each part)."""
    if x.is_complex():
        return torch.complex(x.real.bfloat16().float(),
                             x.imag.bfloat16().float())
    return x.bfloat16().float()


def hann(n: int) -> np.ndarray:
    """Periodic Hann window (src/utils/dsp.cpp:6-11)."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


# ------------------------------------------------------------------ spectra

def spectra(p: Plan, raw: np.ndarray, window: torch.Tensor,
            lowp: bool = False) -> torch.Tensor:
    """One block of wire samples, its halo first -> [B, R'] spectra X/N
    in natural FFT order (src/fft.cpp:47-70, src/fft_impl.cpp:131-161)."""
    dtype, scale, unsigned = WIRE[p.fmt]
    if raw.dtype != dtype or raw.shape[0] != (p.b + 1) * p.wire_per_hop:
        raise ValueError(f"reference: block {raw.dtype}{raw.shape}")
    x = torch.from_numpy(raw).to(window.device).to(torch.float32)
    if unsigned:
        x = x - scale
    x = x * (1.0 / scale)
    if not p.is_real:
        x = torch.view_as_complex(x.view(-1, 2))
    frames = x.as_strided((p.b, p.n), (p.hop, 1))
    xw = frames * (window * (1.0 / p.n))
    spec = torch.fft.rfft(xw) if p.is_real else torch.fft.fft(xw)
    return bf16(spec) if lowp else spec


# ---------------------------------------------------------------- waterfall

def quantize(power: torch.Tensor, offset: int) -> torch.Tensor:
    """int8 dB of a power (src/fft_impl.cpp:13-61): trunc toward zero,
    saturated; zero power is -128."""
    pw = torch.clamp_min(power, 0.0)
    off = float(np.float32(offset) * np.float32(DB_PER_OCTAVE))
    db = torch.log2(pw) * LOG2_TO_DB + 127.0 + off
    db = torch.where(pw > 0, db, -128.0)
    return torch.clamp(torch.trunc(db), -128.0, 127.0).to(torch.int8)


def pyramid(p: Plan, spec: torch.Tensor, rows: list[int]
            ) -> list[torch.Tensor]:
    """The int8 pyramid levels [D, R >> i] of the given hops: power of
    the display-ordered bins, then adjacent-pair sums
    (src/fft_impl.cpp:148-172)."""
    sel = spec[torch.tensor(rows, device=spec.device)][:, :p.r]
    pw = sel.real * sel.real + sel.imag * sel.imag
    if p.base_idx:
        pw = torch.roll(pw, -p.base_idx, dims=-1)
    out = [quantize(pw, p.size_log2)]
    for i in range(1, p.levels):
        pw = pw[..., 0::2] + pw[..., 1::2]
        out.append(quantize(pw, p.size_log2 - i))
    return out


def view_rows(p: Plan, spec: torch.Tensor, frame0: int, views: Views
              ) -> list[list[np.ndarray]]:
    """For each due hop of the step, each view's int8 row
    (``[due][view] -> [length]``)."""
    rows = due_rows(p, frame0)
    if not rows:
        return []
    levels = [lv.cpu().numpy() for lv in pyramid(p, spec, rows)]
    return [[levels[int(lev)][d, s:s + n]
             for lev, s, n in zip(views.level, views.start, views.length)]
            for d in range(len(rows))]


# --------------------------------------------------------------- channels

def gather_bins(p: Plan, spec: torch.Tensor, t: Table):
    """(ssb bins [B, C, A/2+1], cplx bins [B, C, A], slice power [B, C])
    of each listener's slice (src/signal.cpp:102-214); bins past R wrap
    to the start for IQ (the DC wrap, src/fft.cpp:91-98) and are zero
    for real input."""
    dev = spec.device
    a, half, r = p.a, p.half, p.r

    def dt(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(dev)

    l, rr, m = dt(t.l), dt(t.r), dt(t.m_idx)
    start = (l + p.base_idx) % r
    width = rr - l
    m_rel = m - l

    def gather(rel, valid):
        idx = (start[:, None] + rel).clamp(0, r + a - 1)
        if p.is_real:
            valid = valid & (idx < r)
            idx = idx.clamp_max(r - 1)
        else:
            idx = idx % r
        return torch.where(valid[None], spec[:, idx], 0)

    k = torch.arange(a, device=dev)
    sl = gather(k[None, :].expand(p.c, a), k[None, :] < width[:, None])
    power = torch.sum(sl.real * sl.real + sl.imag * sl.imag, dim=-1)

    kr = torch.arange(half + 1, device=dev)
    is_lsb = dt(t.mode == LSB).bool()[:, None]
    ssb_rel = torch.where(is_lsb, m_rel[:, None] - kr[None, :],
                          m_rel[:, None] + kr[None, :])
    ssb = gather(ssb_rel, (ssb_rel >= 0) & (ssb_rel < width[:, None]))

    pos, neg = k[None, :] < half, k[None, :] > half
    c_rel = torch.where(pos, m_rel[:, None] + k[None, :],
                        m_rel[:, None] - (a - k)[None, :])
    cplx = gather(c_rel, (pos | neg) & (c_rel >= 0)
                  & (c_rel < width[:, None]))
    return ssb, cplx, power


def pll(car: np.ndarray, base: np.ndarray, phase: np.ndarray,
        freq: np.ndarray):
    """Carrier-synchronous AM detection (src/signal.cpp:242-252), one
    sample after another: mix by the NCO, phase error arg(carrier),
    second-order loop update, phase wrapped into [0, 2pi).
    car, base: [K, L] complex64; returns (out [K, L] f32, phase, freq)."""
    cr, ci = (np.ascontiguousarray(x.T) for x in (car.real, car.imag))
    br, bi = (np.ascontiguousarray(x.T) for x in (base.real, base.imag))
    out = np.empty_like(cr)
    phase, freq = phase.astype(np.float32), freq.astype(np.float32)
    for i in range(cr.shape[0]):
        cs, sn = np.cos(phase), np.sin(phase)
        err = np.arctan2(ci[i] * cs - cr[i] * sn, cr[i] * cs + ci[i] * sn)
        freq = freq + PLL_ALPHA * err
        phase = np.fmod(phase + PLL_BETA * err + freq, TWO_PI)
        phase = np.where(phase < 0, phase + TWO_PI, phase)
        out[i] = br[i] * cs + bi[i] * sn
    return out.T, phase, freq


def dc_block(tail: torch.Tensor, x: torch.Tensor, d: int):
    """Two cascaded length-d moving averages subtracted from the input
    delayed by d-1 (src/utils.h:139-169)."""
    y = torch.cat([tail, x], dim=-1)

    def mean(v):
        c = torch.nn.functional.pad(torch.cumsum(v, dim=-1), (1, 0))
        return (c[..., d:] - c[..., :-d]) * (1.0 / d)

    out = y[..., d - 1:d - 1 + x.shape[-1]] - mean(mean(y))
    return y[..., -(2 * d - 2):], out


def sliding_max_abs(y: torch.Tensor, w: int, n: int) -> torch.Tensor:
    """max |y[..., i:i+w]| for i < n (by doubling spans)."""
    m = y.abs()
    span = 1
    while 2 * span <= w:
        m = torch.maximum(m[..., :-span], m[..., span:])
        span *= 2
    return torch.maximum(m[..., :n], m[..., w - span:w - span + n])


def agc(p: Plan, tail: torch.Tensor, gain: np.ndarray, seen: np.ndarray,
        x: torch.Tensor):
    """Look-ahead AGC (src/utils/audioprocessing.cpp:5-73): out[t] =
    x[t-W+1] * gain[t] once W samples were pushed (0 before), the gain
    smoothed toward 0.2 / (window peak + 1e-10) with attack when it
    must fall and release when it may rise.  Returns (tail, gain, seen,
    out [C, L] f32 numpy)."""
    w = p.agc_window
    att, rel, level = p.agc_coeffs
    n = x.shape[-1]
    y = torch.cat([tail, x], dim=-1)
    peaks = sliding_max_abs(y, w, n).cpu().numpy()
    desired = np.ascontiguousarray((level / (peaks + np.float32(1e-10))).T)
    full = (seen[:, None] + np.arange(1, n + 1)[None, :]) >= w
    full_t = np.ascontiguousarray(full.T)
    gains = np.empty_like(desired)
    g = gain.astype(np.float32)
    for i in range(n):
        d = desired[i]
        g = np.where(full_t[i], np.where(d < g, g - att * (g - d),
                                         g + rel * (d - g)), g)
        gains[i] = g
    yy = y[..., :n].cpu().numpy()
    out = np.where(full, yy * gains.T, np.float32(0.0))
    return (y[..., y.shape[-1] - (w - 1):], g, np.minimum(seen + n, w),
            out)


def to_int16(x: np.ndarray) -> np.ndarray:
    """Round half up to int16 at 65536/4 (src/utils/dsp.cpp:152-165)."""
    v = np.floor(x * np.float32(16384.0) + np.float32(32768.5)) - 32768.0
    return np.clip(v, -32768, 32767).astype(np.int16)


def channels(p: Plan, car: Carries, spec: torch.Tensor, t: Table,
             frame0: int, lowp: bool = False):
    """The listeners' step: (carries, audio [B, C, A/2] int16, slice
    power [B, C] f32)."""
    a, half, b, c = p.a, p.half, p.b, p.c
    dev = spec.device
    ssb_bins, cplx_bins, power = gather_bins(p, spec, t)
    mode = torch.from_numpy(np.asarray(t.mode, np.int64)).to(dev)
    is_lsb = (mode == LSB)[None, :, None]
    k = torch.arange(a, device=dev)

    # c2r reads only the real part of the DC and Nyquist bins
    edge = torch.ones(half + 1, device=dev)
    edge[0] = edge[half] = 0.0
    ssb_bins = torch.complex(ssb_bins.real, ssb_bins.imag * edge)
    ssb_wave = torch.fft.irfft(ssb_bins, n=a, norm="forward")
    ssb_wave = torch.where(is_lsb, ssb_wave.flip(-1), ssb_wave)
    cplx_wave = torch.fft.ifft(cplx_bins, norm="forward")

    # parity fix-up on odd hops (src/signal.cpp:160-168, 223-234)
    m_even = torch.from_numpy(np.asarray(t.m_idx) % 2 == 0).to(dev)
    parity = ~m_even if p.is_real else m_even
    odd = (torch.arange(b, device=dev) + frame0) % 2 == 1
    sgn = torch.where(odd[:, None] & parity[None, :], -1.0, 1.0)[:, :, None]
    ssb_wave = ssb_wave * sgn
    cplx_wave = cplx_wave * sgn

    # overlap-add with the previous hop's second half
    ssb_out = ssb_wave[:, :, :half] + torch.cat(
        [car.ssb_prev[None], ssb_wave[:-1, :, half:]])
    cplx_out = cplx_wave[:, :, :half] + torch.cat(
        [car.cplx_prev[None], cplx_wave[:-1, :, half:]])
    env = torch.sqrt(cplx_out.real * cplx_out.real
                     + cplx_out.imag * cplx_out.imag)
    am_audio = env
    phase, freq, carrier_prev = car.pll_phase, car.pll_freq, car.carrier_prev
    sync = t.active & (t.mode == AM) & ~t.am_env
    if p.am_sync and sync.any():
        cut = p.carrier_cutoff
        keep = (k < cut) | (k >= a - cut)
        car_wave = torch.fft.ifft(torch.where(keep, cplx_bins, 0),
                                  norm="forward") * sgn
        car_out = car_wave[:, :, :half] + torch.cat(
            [car.carrier_prev[None], car_wave[:-1, :, half:]])
        rows = np.nonzero(sync)[0]
        ri = torch.from_numpy(rows).to(dev)
        cf = car_out.permute(1, 0, 2).reshape(c, b * half)[ri]
        bf = cplx_out.permute(1, 0, 2).reshape(c, b * half)[ri]
        out, ph, fr = pll(cf.cpu().numpy(), bf.cpu().numpy(),
                          phase[rows], freq[rows])
        phase, freq = phase.copy(), freq.copy()
        phase[rows], freq[rows] = ph, fr
        am = am_audio.permute(1, 0, 2).reshape(c, b * half).clone()
        am[ri] = torch.from_numpy(np.ascontiguousarray(out)).to(dev)
        am_audio = am.reshape(c, b, half).permute(1, 0, 2)
        carrier_prev = car_wave[-1, :, half:].clone()

    # FM: arg(x[i] conj(x[i-1])) seeded across steps (dsp.cpp:27-35)
    flat = cplx_out.permute(1, 0, 2).reshape(c, b * half)
    prev = torch.cat([car.fm_prev[:, None], flat[:, :-1]], dim=1)
    fm_audio = (torch.angle(flat * torch.conj(prev))
                .reshape(c, b, half).permute(1, 0, 2))

    md = mode[None, :, None]
    audio = torch.where(md == AM, am_audio,
                        torch.where(md == FM, fm_audio, ssb_out))
    audio = torch.where(torch.isfinite(audio), audio, 0.0)
    if lowp:
        audio = bf16(audio)

    stream = audio.permute(1, 0, 2).reshape(c, b * half)
    dc_tail, stream = dc_block(car.dc_tail, stream, p.dc_delay)
    agc_tail, gain, seen, out = agc(p, car.agc_tail, car.agc_gain,
                                    car.agc_seen, stream.contiguous())
    audio16 = to_int16(out).reshape(c, b, half).transpose(1, 0, 2)
    new = Carries(
        ssb_prev=ssb_wave[-1, :, half:].clone(),
        cplx_prev=cplx_wave[-1, :, half:].clone(),
        fm_prev=flat[:, -1].clone(), carrier_prev=carrier_prev,
        pll_phase=phase, pll_freq=freq, dc_tail=dc_tail, agc_tail=agc_tail,
        agc_gain=gain, agc_seen=seen)
    return new, np.ascontiguousarray(audio16), power.cpu().numpy()


def step(p: Plan, car: Carries, raw: np.ndarray, t: Table, views: Views,
         frame0: int, window: torch.Tensor, lowp: bool = False):
    """One whole step: (carries, audio int16 [B, C, A/2], power [B, C],
    view rows ``[due][view]``)."""
    spec = spectra(p, raw, window, lowp)
    rows = view_rows(p, spec, frame0, views)
    car, audio, power = channels(p, car, spec, t, frame0, lowp)
    return car, audio, power, rows
