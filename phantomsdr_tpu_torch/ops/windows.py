"""Analysis window (reference: src/utils/dsp.cpp:6-11).

Hann: ``w[i] = 0.5 * (1 - cos(2*pi*i / N))`` -- note the denominator is
``N`` (periodic Hann), not ``N - 1``.

Windows are returned as host numpy arrays; callers move them to the
device once.
"""

from __future__ import annotations

import numpy as np


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window of length ``n`` (reference src/utils/dsp.cpp:6-11)."""
    i = np.arange(n, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))
    return w.astype(dtype)
