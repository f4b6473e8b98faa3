"""wdsp variable-leak LMS noise reduction / auto-notch on the device.

The reference runs this in the browser (jsdsp/lib/ANR.c, Warren Pratt's
wdsp ANR): an adaptive FIR predicts the current sample from ``taps``
samples that are ``delay`` samples old.  Periodic content (tones,
carriers) is predictable at that lag, white content is not.  ``notch``
mode outputs the prediction error (removes carriers and tones), NR mode
4x the prediction (keeps the correlated part, drops hiss).  Here it runs
for every listener at once, batched [C, T], as an opt-in (``[input] nr
= true`` with ``nr_algo = "lms"`` or ``"notch"``, per client
``{"cmd":"nr","enabled":true}``).

This is the JAX package's shipped block-LMS form: weights frozen across
a block of B samples, the leak automaton advanced once per block, B =
min(block, T, 0.5/two_mu) with blocks restarting at every call; its
chain of blocks is kernel K-ANR on the card (ops/cuda/anr.py).  The
reference's leak-index quirk (ANR.c:100-105) makes the leak a two-state
automaton: 0 until the first nev < nel trigger after a zero reset, then
gamma * 120^4 * 6.25e-10 forever.  The JAX package's per-sample
``anr_process_exact`` (its oracle anchor) has no counterpart here; the
tests hold this port against the JAX package's block form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.anr import LIDX_INIT, NGAMMA_INIT, lms_blocks

# default weight-update block (samples); the 0.5/two_mu stability cap
# shrinks it for aggressive gains
BLOCK_DEFAULT = 256


class ANRParams(NamedTuple):
    taps: int       # 16..128 (ANR.c:26)
    delay: int      # 2..128, <= taps
    two_mu: float   # adaptation gain, 1e-7..8.192e-2
    gamma: float    # leakage, 1e-3..8192
    notch: bool     # True: output error (auto-notch); False: 4*y (NR)
    block: int      # weight-update block size (1 = per-sample)


class ANRState(NamedTuple):
    hist: torch.Tensor    # [C, taps+delay] newest-first delay line
    w: torch.Tensor       # [C, taps] adaptive weights
    lidx: torch.Tensor    # [C] leak index (pinned at 120 by the quirk)
    ngamma: torch.Tensor  # [C] leak term of the previous block


def make_anr_params(notch: bool = False, taps: int = 64, delay: int = 8,
                    two_mu: float = 1e-4, gamma: float = 0.1,
                    block: int = BLOCK_DEFAULT) -> ANRParams:
    return ANRParams(taps=int(taps), delay=int(delay),
                     two_mu=float(two_mu), gamma=float(gamma),
                     notch=bool(notch), block=int(block))


def init_anr_state(num_channels: int, params: ANRParams | None,
                   device="cpu") -> ANRState:
    """All-zero carries except the scalar floors; with ``params=None``
    the delay line and weights are zero-width.  A zero-reset row starts
    in the leak automaton's unarmed phase (leak-free until its first
    trigger), as in the JAX package."""
    c = num_channels
    nt = params.taps if params is not None else 0
    nd = params.delay if params is not None else 0

    def full(v):
        return torch.full((c,), v if params is not None else 0.0,
                          dtype=torch.float32, device=device)
    return ANRState(
        hist=torch.zeros((c, nt + nd), dtype=torch.float32, device=device),
        w=torch.zeros((c, nt), dtype=torch.float32, device=device),
        lidx=full(LIDX_INIT), ngamma=full(NGAMMA_INIT))


def block_size(params: ANRParams, t: int) -> int:
    """B = min(block, T, 0.5/two_mu), at least 1 (anr.py:242-243)."""
    return max(1, min(int(params.block), t,
                      int(0.5 / max(params.two_mu, 1e-9))))


def anr_process(state: ANRState, params: ANRParams, x: torch.Tensor
                ) -> tuple[ANRState, torch.Tensor]:
    """Filter x [C, T] -> same shape (streaming: the delay line, the
    weights and the leak are carried in ``state``)."""
    t = x.shape[1]
    if t == 0:
        return state, x
    carries, out = lms_blocks(
        state.hist, state.w, state.lidx, state.ngamma, x.contiguous(),
        params.taps, params.delay, params.two_mu, params.gamma,
        params.notch, block_size(params, t))
    return ANRState(*carries), out
