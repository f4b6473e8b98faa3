"""FM de-emphasis: a one-pole IIR per stream row.

Broadcast FM pre-emphasizes treble at the transmitter (+6 dB/octave
above 1/(2*pi*tau), tau = 75 us in the Americas / 50 us elsewhere); a
receiver applies the matching pole or FM audio sounds harsh.  The
reference ships the raw discriminator output and leaves this to the
browser; here it is a server-side option (``[input] deemphasis = 75``)
applied on the device to every FM listener at once:

    y[n] = alpha * y[n-1] + (1 - alpha) * x[n],
    alpha = exp(-1 / (tau * fs))

On the card the recurrence is kernel K-DEEMPH (ops/cuda/deemph.py).

Placement (pipeline.audio_from_spectra): after the RDS tap and the
stereo demix -- the 19 kHz pilot and the 38/57 kHz subcarriers must not
see the pole -- and before decimation, on the per-stream rows.  Non-FM
rows pass through untouched.
"""

from __future__ import annotations

import math

from .cuda.deemph import deemph_process  # noqa: F401  (re-exported)


def deemph_alpha(audio_sps: int, tau_us: float) -> float:
    """Pole coefficient for a tau-microsecond de-emphasis at fs."""
    return math.exp(-1.0 / (tau_us * 1e-6 * float(audio_sps)))
