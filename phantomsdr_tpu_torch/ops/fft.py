"""Forward FFT core: 50%-overlap framing, windowing, FFT.

Reference semantics (src/fft.cpp:47-70, src/fft_impl.cpp:131-161):

- hop = N/2 samples, hard-coded 50% overlap,
- each frame is [prev_half, cur_half] multiplied by the two halves of a
  periodic Hann window,
- forward FFT is unnormalized (FFTW convention); the quantize step then
  divides the spectrum by N in place, so the spectrum consumed by both
  the waterfall and the audio path is X/N,
- real input: r2c of N reals -> N/2(+1) bins; IQ input: c2c of N
  complex samples -> N bins in natural FFT order.

The FFT itself is ``torch.fft`` (cuFFT on the card), batched over the
hops of one step.
"""

from __future__ import annotations

import torch


def frame_hops(samples: torch.Tensor, num_hops: int,
               fft_size: int) -> torch.Tensor:
    """[B, N] overlapped frames from a contiguous sample run, as a
    strided view (no copy).

    ``samples``: [(B+1) * N/2] samples (previous half-frame followed by B
    new half-frames).  Frame b covers samples[b*H : b*H + N], H = N/2 --
    the reference's triple-buffer rotation (src/fft.cpp:50-68).
    """
    hop = fft_size // 2
    if samples.shape[0] != (num_hops + 1) * hop:
        raise ValueError(f"expected {(num_hops + 1) * hop} samples, got "
                         f"{samples.shape[0]}")
    return samples.contiguous().as_strided((num_hops, fft_size), (hop, 1))


def forward_spectrum(frames: torch.Tensor, window: torch.Tensor,
                     is_real: bool) -> torch.Tensor:
    """Window + forward FFT + 1/N normalization.

    Returns the normalized spectrum X/N in natural FFT order:
    [B, N/2 + 1] for real input (r2c), [B, N] for IQ (c2c).  The 1/N
    normalization mirrors the in-place divide the reference applies
    before power (src/fft_impl.cpp:34-35).  It is folded into the
    window: N is a power of two, so scaling the FFT's input by 1/N
    gives exactly the same floats as scaling its output, and saves a
    pass over the [B, N] spectrum.
    """
    n = window.shape[0]
    xw = frames * (window * (1.0 / n))
    if is_real:
        return torch.fft.rfft(xw)
    return torch.fft.fft(xw)
