"""Spectral noise reduction (Kim & Ruwisch / Ephraim-Malah) on the device.

The reference runs this in the browser on each client's decoded audio
(jsdsp/lib/NR_spectral.c, an MMSE spectral-subtraction noise reducer);
here it runs for every listener at once, batched over the channel
population [C, T], as a per-client opt-in (``{"cmd":"nr","enabled":
true}`` with ``[input] nr = true``, ``nr_algo = "spectral"``):

- sqrt-Hann analysis/synthesis windows at 50 % overlap,
- per-bin MMSE speech-presence probability -> noise-floor track,
- decision-directed a-priori SNR -> per-bin gain with a 0.001 floor,
- SNR-dependent moving-average smoothing of the gain curve (window
  1/3/5/7/9 bins),
- overlap-add resynthesis, rounded half to even.

The per-frame recursion (noise track, speech probability, SNR, gain) is
kernel K-NR on the card (ops/cuda/nr.py); everything else is batched
PyTorch: the frame FFTs before it, the smoothing, weighting, IFFTs and
overlap-add after it.

Faithful to NR_spectral.c:108-353 with its quirks, as the JAX package
is: the conjugate-bin index of the spectral weighting is ``2F-1-b``
(NR_spectral.c:328), the output is rounded to integers (the pipeline
feeds the int16-domain stream), the first 20 frames only accumulate the
noise estimate at unit gain, and the smoothing's edge bins keep their
unsmoothed gains.  The frame is ``half = audio_fft_size/2`` samples (one
frame per hop), and the noise-track division is guarded with 1e-30.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .cuda.build import div_scalar
from .cuda.nr import PSPRI, gain_frames

NR_WIDTH = 4
POWER_THRESHOLD = 0.4


class NRParams(NamedTuple):
    window: np.ndarray   # [2F] sqrt-Hann synthesis/analysis window
    final_gain: float
    alpha: float         # decision-directed SNR smoothing [0.95]
    xih1: float          # a-priori SNR of the speech-active hypothesis
    xih1r: float
    pfac: float


class NRState(NamedTuple):
    stage: torch.Tensor      # [C] int32: 0 fresh, 1..20 averaging, >20 run
    last_in: torch.Tensor    # [C, F] previous half-frame of input
    last_ifft: torch.Tensor  # [C, F] previous IFFT second half (OLA carry)
    nest: torch.Tensor       # [C, F] startup noise accumulator
    xt: torch.Tensor         # [C, F] noise-floor track
    pslp: torch.Tensor       # [C, F] smoothed speech probability
    hk_old: torch.Tensor     # [C, F] previous SNR_post * G^2


def make_nr_params(half: int, final_gain: float = 1.0, alpha: float = 0.95,
                   asnr_db: float = 30.0) -> NRParams:
    """Window + gain constants for frame size `half` (FFT 2*half).  The
    [2F] window repeats each sqrt-Hann point twice, like the reference's
    ``sqrtHann_256[i/2]`` indexing (NR_spectral.c:155)."""
    f = half
    tab = np.sin(np.pi * np.arange(f) / (f - 1)).astype(np.float32)
    win = np.repeat(tab, 2)
    xih1 = 10.0 ** (asnr_db / 10.0)
    return NRParams(
        window=win.astype(np.float32),
        final_gain=float(final_gain),
        alpha=float(alpha),
        xih1=xih1,
        xih1r=1.0 / (1.0 + xih1) - 1.0,
        pfac=(1.0 / PSPRI - 1.0) * (1.0 + xih1),
    )


def init_nr_state(num_channels: int, half: int, device="cpu") -> NRState:
    """All-zero carries; stage 0 marks 'fresh', and the first frame sets
    the gain-side carries to the reference's init values, so the
    pipeline's all-zeros reset re-arms NR exactly."""
    def z():
        return torch.zeros((num_channels, half), dtype=torch.float32,
                           device=device)
    return NRState(stage=torch.zeros((num_channels,), dtype=torch.int32,
                                     device=device),
                   last_in=z(), last_ifft=z(), nest=z(), xt=z(), pslp=z(),
                   hk_old=z())


def smooth_gains(g_run: torch.Tensor, x_pow: torch.Tensor,
                 running: torch.Tensor) -> torch.Tensor:
    """Musical-noise smoothing (bins [1, F), NR_spectral.c:257-314) of
    g_run [N, C, F]; frames that do not run (running [N, C] False) pass
    G = 1.  The window width is one of {1, 3, 5, 7, 9} per (frame,
    channel): the moving average of every width comes from static
    shifts of one cumulative sum, and the row's width selects."""
    f = g_run.shape[-1]
    bins = torch.arange(f, device=g_run.device)
    band = bins >= 1
    pre = torch.where(band, x_pow, 0.0).sum(-1)
    post = torch.where(band, g_run * g_run * x_pow, 0.0).sum(-1)
    pr = post / (pre + 1e-30)
    width = torch.floor(
        0.5 + NR_WIDTH * (1.0 - div_scalar(pr, POWER_THRESHOLD)))
    nn = torch.where(pr > POWER_THRESHOLD, 1, 1 + 2 * width.to(torch.int32))
    h_sel = (nn // 2)[..., None]
    cs = torch.cat([torch.zeros(g_run.shape[:-1] + (1,), dtype=g_run.dtype,
                                device=g_run.device),
                    torch.cumsum(g_run, dim=-1)], dim=-1)      # [..., F+1]
    g = g_run
    for h in range(1, NR_WIDTH + 1):
        # cs[b+h+1] - cs[b-h]; the edge pads land only on bins the
        # centre mask excludes
        hi_v = torch.cat([cs[..., h + 1:], cs[..., -1:].expand(
            cs.shape[:-1] + (h,))], dim=-1)
        lo_v = torch.cat([cs[..., :1].expand(cs.shape[:-1] + (h,)),
                          cs[..., :f - h]], dim=-1)
        sm = div_scalar(hi_v - lo_v, 2 * h + 1)
        centre = (bins >= 1 + h) & (bins < f - h)
        g = torch.where((h_sel == h) & centre, sm, g)
    return torch.where(running[..., None], g, 1.0)


@functools.lru_cache(maxsize=8)
def _window(window: bytes, device: torch.device) -> torch.Tensor:
    """The float32 window (as bytes) on device, copied there once."""
    return torch.from_numpy(np.frombuffer(window, np.float32).copy()).to(
        device)


def frame_spectra(last_in: torch.Tensor, window: torch.Tensor,
                  x: torch.Tensor, num_frames: int):
    """The step's analysis frames: each is the previous and the current
    half-frame of x [C, N*F] (the first one's previous half carried in
    last_in [C, F]) under the [2F] window.  Returns (cur [N, C, F] the
    half-frames, z [N, C, 2F] their FFTs, x_pow [N, C, F] the squared
    magnitudes of bins 0..F-1)."""
    c, t = x.shape
    f = t // num_frames
    cur = x.reshape(c, num_frames, f).permute(1, 0, 2)           # [N, C, F]
    prev = torch.cat([last_in[None], cur[:-1]])                  # [N, C, F]
    buf = torch.cat([prev, cur], dim=2) * window
    z = torch.fft.fft(buf.to(torch.complex64), dim=2)            # [N, C, 2F]
    zf = z[..., :f]
    return cur, z, (zf.real ** 2 + zf.imag ** 2).contiguous()


def nr_process(state: NRState, params: NRParams, x: torch.Tensor,
               num_frames: int) -> tuple[NRState, torch.Tensor]:
    """Denoise the int16-domain stream x [C, num_frames*F] -> same shape.
    Streaming: all history is carried in ``state``."""
    c, t = x.shape
    n = num_frames
    f = t // n
    win = _window(params.window.tobytes(), x.device)            # [2F]
    cur, z, x_pow = frame_spectra(state.last_in, win, x, n)

    carries, g_run, running = gain_frames(
        (state.stage, state.nest, state.xt, state.pslp, state.hk_old),
        params.alpha, params.xih1r, params.pfac, x_pow)
    g = smooth_gains(g_run, x_pow, running)                      # [N, C, F]

    # spectral weighting with the reference's 2F-1-b conjugate quirk:
    # bins 1..F-1 get G[b], bins F..2F-2 the reversed tail, bin 0 and
    # bin 2F-1 stay unscaled
    one = torch.ones((n, c, 1), dtype=torch.float32, device=x.device)
    gful = torch.cat([one, g[..., 1:], g[..., 1:].flip(-1), one], dim=2)
    y = torch.fft.ifft(z * gful, dim=2).real * win
    # overlap-add: frame i's first half + frame i-1's second half
    tails = torch.cat([state.last_ifft[None], y[:-1, :, f:]])
    outs = torch.round((y[..., :f] + tails) * params.final_gain)
    stage, nest, xt, pslp, hk_old = carries
    state = NRState(stage=stage, last_in=cur[-1].contiguous(),
                    last_ifft=y[-1, :, f:].contiguous(), nest=nest, xt=xt,
                    pslp=pslp, hk_old=hk_old)
    return state, outs.permute(1, 0, 2).reshape(c, t)
