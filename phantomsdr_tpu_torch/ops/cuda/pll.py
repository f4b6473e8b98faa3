"""K-PLL: AM carrier-synchronous detection (csrc/pll.cu).

Replaces the per-sample ``lax.scan`` of ``am_sync_detect``
(phantomsdr_tpu/ops/channelizer.py, unrolled by ops/unroll.py), the
liquid-dsp carrier PLL of the reference (src/signal.cpp:242-252).

Bound on the card: the per-channel dependent chain of one step's
samples, not its bytes.  The phase detector is taken as the identity
arg(carrier * exp(-i*phase)) = wrap(arg(carrier) - phase): arg(carrier)
does not depend on the loop, so the block's threads compute it (atan2)
while they stage the row, and a step is a subtraction, a wrap, the loop
update and the phase wrap.  The plain version's detector (sincos, the
complex product, atan2) still runs where the identity is not the
detector in float32: zero or non-finite carrier samples, an err within
1e-4 of +-pi, and a loop frequency of 0.5 rad a sample or more (no
carrier the loop could hold; noise alone walks there).  One warp runs
each channel's loop: a round predicts 32 samples by the identity alone,
then each lane applies that rule to its own sample from the predicted
state, all at once, and the round commits the samples up to the first
lane whose exact step disagrees -- so the transcendental functions
leave the chain, and the result is the rule's bit for bit.
``chain_probe`` launches those rounds alone over four samples' arg held
in registers; its time is the floor the kernel is measured against.
The kernel runs one block per channel: its threads stage the row's arg
in shared memory and leave but the one warp, which records each
sample's NCO phase; a second, fully parallel kernel turns those phases
into the output.  The phase wrap subtracts or adds 2*pi where that
equals ``fmod`` bit for bit and calls ``fmod`` elsewhere.  The identity
rounds otherwise than the plain version's atan2 of the rounded product
(a few 1e-7 rad an err), so the two agree to the tolerances of
tests/test_torch_cuda.py, not bit for bit.

``am_sync_detect_plain`` is the same recursion in plain PyTorch (a
Python loop over samples, vectorized over channels); the wrapper takes
it only for CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .build import (
    F, I, P, CudaKernel, check_host_or_cuda, require_cuda, stream_and_device,
)

KERNEL = CudaKernel("pll", [P, P, P, P, P, P, P, I, I, F, F, F, I, P],
                    probe_argtypes=[P, P, P, P, P, I, I, F, F, F, I, P])

# PLL loop gains for carrier sync, after liquid's
# nco_crcf_pll_set_bandwidth(0.001) (src/signal.cpp:61):
# alpha = bw applied to frequency, beta = sqrt(bw) applied to phase.
PLL_BW = 0.001
PLL_ALPHA = PLL_BW
PLL_BETA = PLL_BW ** 0.5
TWO_PI = 2.0 * math.pi
# alpha, beta and 2*pi as the float32 values the kernel takes
_GAINS = (float(np.float32(PLL_ALPHA)), float(np.float32(PLL_BETA)),
          float(np.float32(TWO_PI)))


def am_sync_detect_plain(carrier: torch.Tensor, baseband: torch.Tensor,
                         phase0: torch.Tensor, freq0: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See ``am_sync_detect``."""
    cr, ci = carrier.real.T.contiguous(), carrier.imag.T.contiguous()
    br, bi = baseband.real.T.contiguous(), baseband.imag.T.contiguous()
    out = torch.empty_like(cr)                          # [L, C]
    phase, freq = phase0.clone(), freq0.clone()
    for t in range(cr.shape[0]):
        cs, sn = torch.cos(phase), torch.sin(phase)     # exp(-i*phase)
        re = cr[t] * cs + ci[t] * sn
        im = ci[t] * cs - cr[t] * sn
        err = torch.atan2(im, re)
        freq = freq + PLL_ALPHA * err
        phase = phase + PLL_BETA * err
        # wrap like liquid's NCO phase constraint (and jnp.mod's sign
        # rule): an unwrapped phase loses float32 resolution over days
        phase = torch.fmod(phase + freq, TWO_PI)
        phase = torch.where(phase < 0, phase + TWO_PI, phase)
        out[t] = br[t] * cs + bi[t] * sn
    return out.T.contiguous(), phase, freq


def am_sync_detect(carrier: torch.Tensor, baseband: torch.Tensor,
                   phase0: torch.Tensor, freq0: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PLL carrier-synchronous AM detection (src/signal.cpp:242-252).

    carrier, baseband: [C, L] complex64 (carrier = <500 Hz lowpassed
    copy).  Per sample: mix both down by the NCO, phase error =
    arg(carrier), 2nd-order loop update, output = Re(baseband mixed).
    Returns (audio [C, L] float32, phase [C], freq [C]).
    """
    if check_host_or_cuda(carrier, "am_sync_detect"):
        return am_sync_detect_plain(carrier, baseband, phase0, freq0)
    require_cuda(carrier, "carrier", torch.complex64, 2)
    require_cuda(baseband, "baseband", torch.complex64, 2)
    require_cuda(phase0, "phase0", torch.float32, 1)
    require_cuda(freq0, "freq0", torch.float32, 1)
    c, n = carrier.shape
    if baseband.shape != carrier.shape or phase0.shape[0] != c \
            or freq0.shape[0] != c:
        raise ValueError("am_sync_detect: mismatched shapes "
                         f"{tuple(carrier.shape)} {tuple(baseband.shape)} "
                         f"{tuple(phase0.shape)} {tuple(freq0.shape)}")
    out = carrier.new_empty((c, n), dtype=torch.float32)
    phase = torch.empty_like(phase0)
    freq = torch.empty_like(freq0)
    stream, dev = stream_and_device(carrier)
    KERNEL.launch(carrier.data_ptr(), baseband.data_ptr(), phase0.data_ptr(),
                  freq0.data_ptr(), out.data_ptr(), phase.data_ptr(),
                  freq.data_ptr(), c, n, *_GAINS, dev, stream)
    return out, phase, freq


def chain_probe(carrier: torch.Tensor, phase0: torch.Tensor,
                freq0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chain alone, for timing: the same rounds over L
    samples per channel on the arg of four carrier samples held in
    registers, no stores.  Returns its (phase, freq); not counted as a
    launch of the kernel.  CUDA tensors only."""
    require_cuda(carrier, "carrier", torch.complex64, 2)
    require_cuda(phase0, "phase0", torch.float32, 1)
    require_cuda(freq0, "freq0", torch.float32, 1)
    c, n = carrier.shape
    if phase0.shape[0] != c or freq0.shape[0] != c:
        raise ValueError("chain_probe: mismatched shapes "
                         f"{tuple(carrier.shape)} {tuple(phase0.shape)} "
                         f"{tuple(freq0.shape)}")
    phase = torch.empty_like(phase0)
    freq = torch.empty_like(freq0)
    stream, dev = stream_and_device(carrier)
    KERNEL.probe(carrier.data_ptr(), phase0.data_ptr(), freq0.data_ptr(),
                 phase.data_ptr(), freq.data_ptr(), c, n, *_GAINS, dev,
                 stream)
    return phase, freq
