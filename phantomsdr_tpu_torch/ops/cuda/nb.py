"""K-NB: the Wild noise blanker's LPC fit, impulse search and repairs
(csrc/nb.cu, two launches around the two FIR passes of ops/nb.py).

Replaces the serial parts of ``nb_process`` (phantomsdr_tpu/ops/nb.py):

- ``lpc_coeffs`` (launch 1): the order+1 autocorrelation lags of the
  frame, Levinson-Durbin as transcribed from NB.c:120-148 (R[0] *
  (1 + 1e-9)), and the il-step forward and backward prediction
  recursions (the ``lax.scan``s of nb.py:188 and :195) folded into
  [il, order] coefficient matrices;
- ``repair`` (launch 2): the residual's mean and unbiased variance, the
  threshold thresh * sqrt(sigma2 * lpc_power) (lpc_power leaves out
  lpcs[order], NB.c:177), the greedy impulse search (skip-ahead by
  PL + 1 on detection, 20 at most; the ``lax.scan`` of nb.py:161 over
  its top_k-compacted candidates gives the same positions), the
  sequential repairs (nb.py:255: a later repair's forward basis sees
  earlier repairs, the backward basis only original samples) and the
  writeback, later repairs overwriting earlier ones.

Bound on the card: bytes (the working buffer and the residual read,
the repaired buffer written); the work that does not spread over
threads is Levinson, the two il-step recursions and the 20-slot repair
chain.  One block per channel for each launch: the frame streams
through shared memory for the lags, Levinson runs in one warp's
registers, the two recursions on two warps with each lane's columns in
registers; the residual is read once, each slot's span is staged into
a compact shared-memory buffer where overlapping spans share their
samples, and the chain reads only shared memory and registers.
``repair_chain_probe`` runs the repair chain alone over 20 slots PL + 1
apart (their spans staged and backward predictions formed first), as
its floor.

``lpc_coeffs_plain`` and ``repair_plain`` are the same in plain PyTorch,
in the JAX package's structure (vectorised over channels); the wrappers
take them only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import (
    F, I, P, CudaKernel, check_host_or_cuda, div_scalar, require_cuda,
    stream_and_device,
)

N_IMPULSE_COUNT = 20
MAX_ORDER = 40          # NB.c:19 max_lpc_order

LPC_KERNEL = CudaKernel("nb_lpc", [P, P, P, P, I, I, I, I, I, I, P],
                        source="nb")
REPAIR_KERNEL = CudaKernel("nb_repair", [P, P, P, P, P, P, P, P, P, I, I, I,
                                         I, I, F, I, P],
                           probe_argtypes=[P, P, P, P, P, I, I, I, I, I, I,
                                           P],
                           source="nb")


def half_len(il: int) -> int:
    """PL, the samples repaired on each side of an impulse."""
    return (il - 1) // 2


def crossfade(il: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(wfw, wbw): the forward and backward weights of a repair,
    arange(il) / (il - 1) in float32 and its reverse (NB.c:213-216)."""
    wbw = torch.from_numpy(np.arange(il, dtype=np.float32)
                           / np.float32(il - 1)).to(device)
    return wbw.flip(0), wbw


def levinson(r: torch.Tensor, order: int) -> torch.Tensor:
    """Batched Levinson-Durbin exactly as transcribed (NB.c:120-148).
    r: [C, order+1] autocorrelation -> lpcs [C, order+1], lpcs[:,0]=1."""
    c = r.shape[0]
    r0 = r[:, 0] * (1.0 + 1.0e-9)
    lpcs = torch.zeros((c, order + 1), dtype=torch.float32, device=r.device)
    lpcs[:, 0] = 1.0
    alfa = r0
    for m in range(1, order + 1):
        s = torch.zeros((c,), dtype=torch.float32, device=r.device)
        for u in range(1, m):
            s = s + lpcs[:, u] * r[:, m - u]
        k = -(r[:, m] + s) / alfa
        if m > 1:
            lpcs[:, 1:m] = lpcs[:, 1:m] + k[:, None] * lpcs[:, 1:m].flip(1)
        lpcs[:, m] = k
        alfa = alfa * (1.0 - k * k)
    return lpcs


def _recursion(taps: torch.Tensor, il: int, forward: bool) -> torch.Tensor:
    """The il-step prediction recursion as [C, il, order] rows: step i's
    prediction is row i . basis.  Forward: the basis shifts up and the
    prediction enters last; backward: it enters first (nb.py:184-196)."""
    c, order = taps.shape
    bmat = torch.eye(order, dtype=torch.float32,
                     device=taps.device).expand(c, order, order)
    rows = []
    for _ in range(il):
        ci = (taps[:, :, None] * bmat).sum(1)                   # [C, order]
        if forward:
            bmat = torch.cat([bmat[:, 1:], ci[:, None]], dim=1)
        else:
            bmat = torch.cat([ci[:, None], bmat[:, :-1]], dim=1)
        rows.append(ci)
    return torch.stack(rows if forward else rows[::-1], dim=1)


def lpc_coeffs_plain(wb: torch.Tensor, t: int, order: int, il: int):
    """See ``lpc_coeffs``."""
    lo = order + half_len(il)
    base = wb[:, lo:lo + t]
    r = torch.stack([(base[:, :t - i] * base[:, i:t]).sum(1)
                     for i in range(order + 1)], dim=1)
    lpcs = levinson(r, order)
    fwd = -lpcs.flip(1)[:, :order]          # [lpc_order .. lpc_1] negated
    bwd = -lpcs[:, 1:order + 1]             # [lpc_1 .. lpc_order] negated
    return lpcs, _recursion(fwd, il, True), _recursion(bwd, il, False)


def lpc_coeffs(wb: torch.Tensor, t: int, order: int, il: int):
    """LPC fit of the frame base = wb[:, order+PL : order+PL+t] of the
    working buffer wb [C, t + 2*order + 2*PL].

    Returns (lpcs [C, order+1] with lpcs[:, 0] = 1, coef_f [C, il,
    order], coef_b_rev [C, il, order]): sample i of a repair window is
    predicted forward as coef_f[i] . (the order samples before the
    window) and backward as coef_b_rev[i] . (the order samples after it).
    """
    if check_host_or_cuda(wb, "lpc_coeffs"):
        return lpc_coeffs_plain(wb, t, order, il)
    require_cuda(wb, "wb", torch.float32, 2)
    c, wlen = wb.shape
    if not 1 <= order <= MAX_ORDER or wlen != t + 2 * order + 2 * half_len(il):
        raise ValueError(f"lpc_coeffs: wb {tuple(wb.shape)} for t {t}, "
                         f"order {order} (1..{MAX_ORDER}), il {il}")
    lpcs = wb.new_empty((c, order + 1))
    coef_f = wb.new_empty((c, il, order))
    coef_b_rev = wb.new_empty((c, il, order))
    stream, dev = stream_and_device(wb)
    LPC_KERNEL.launch(wb.data_ptr(), lpcs.data_ptr(), coef_f.data_ptr(),
                      coef_b_rev.data_ptr(), c, wlen, t, order, il, dev,
                      stream)
    return lpcs, coef_f, coef_b_rev


def search_plain(temp: torch.Tensor, thr: torch.Tensor, order: int, pl: int):
    """Greedy impulse search over positions order+PL .. t-1 of the
    residual temp [C, t]: (count [C] int32, positions [C, 20] int32 =
    detected position - order, 0 past count).  Each selection suppresses
    at most PL candidates, so the earliest 20 * (PL + 1) candidates
    decide every selection (nb.py:140-161)."""
    c, t = temp.shape
    dev = temp.device
    count = torch.zeros((c,), dtype=torch.int32, device=dev)
    positions = torch.zeros((c, N_IMPULSE_COUNT), dtype=torch.int32,
                            device=dev)
    n_dom = t - (order + pl)
    if n_dom <= 0:
        return count, positions
    pos_dom = torch.arange(order + pl, t, dtype=torch.int32, device=dev)
    cand = torch.where(temp[:, order + pl:].abs() > thr[:, None],
                       pos_dom[None, :], t)
    k_cand = min(N_IMPULSE_COUNT * (pl + 1), n_dom)
    cpos = torch.topk(cand, k_cand, dim=1, largest=False, sorted=True).values
    nxt = torch.full((c,), order + pl, dtype=torch.int32, device=dev)
    slots = torch.arange(N_IMPULSE_COUNT, dtype=torch.int32, device=dev)
    for k in range(k_cand):
        pos = cpos[:, k]
        det = (pos < t) & (pos >= nxt) & (count < N_IMPULSE_COUNT)
        onehot = (slots[None, :] == count[:, None]) & det[:, None]
        positions = torch.where(onehot, (pos - order)[:, None], positions)
        nxt = torch.where(det, pos + pl + 1, nxt)
        count = count + det.to(torch.int32)
    return count, positions


def threshold_plain(temp: torch.Tensor, lpcs: torch.Tensor, thresh: float,
                    order: int) -> torch.Tensor:
    """thresh * sqrt(unbiased variance of temp * lpc_power) per channel,
    lpc_power = sum of lpcs[:, :order]^2 (nb.py:125-129)."""
    t = temp.shape[1]
    mean = div_scalar(temp.sum(1, keepdim=True), float(t))
    sigma2 = div_scalar(((temp - mean) ** 2).sum(1), float(t - 1))
    lpc_power = (lpcs[:, :order] ** 2).sum(1)
    return float(np.float32(thresh)) * torch.sqrt(sigma2 * lpc_power)


def repair_plain(wb, temp, lpcs, coef_f, coef_b_rev, thresh: float,
                 order: int, il: int):
    """See ``repair``."""
    c, wlen = wb.shape
    pl = half_len(il)
    dev = wb.device
    thr = threshold_plain(temp, lpcs, thresh, order)
    count, positions = search_plain(temp, thr, order, pl)
    pos64 = positions.to(torch.int64)

    # each slot's contiguous span: forward basis, window, backward basis
    w_span = 2 * order + il
    span = torch.arange(w_span, device=dev)
    spans = torch.gather(wb, 1, (pos64[:, :, None] + span).reshape(c, -1))
    spans = spans.reshape(c, N_IMPULSE_COUNT, w_span)
    rfw_orig = spans[:, :, :order]
    orig_patch = spans[:, :, order:order + il]
    rbw_all = spans[:, :, order + il:]
    # the backward basis of a slot never holds an earlier repair
    bpatch_all = (coef_b_rev[:, None] * rbw_all[:, :, None, :]).sum(-1)
    wfw, wbw = crossfade(il, dev)
    valid = (torch.arange(N_IMPULSE_COUNT, device=dev)[None, :]
             < count[:, None])                                  # [C, 20]
    # the chain: a sliding window of corrections (repaired - original)
    # anchored at the current slot's span
    width = order + il
    acc = torch.zeros((c, width), dtype=torch.float32, device=dev)
    wk = torch.arange(width, device=dev)[None, :]
    prev = pos64[:, 0]
    patches = []
    for j in range(N_IMPULSE_COUNT):
        pos = pos64[:, j]
        accp = torch.cat([acc, torch.zeros_like(acc)], dim=1)
        acc = torch.gather(accp, 1, (wk + (pos - prev)[:, None]).clamp(
            0, 2 * width - 1))
        rfw = rfw_orig[:, j] + acc[:, :order]
        fpred = (coef_f * rfw[:, None, :]).sum(-1)              # [C, il]
        patch = wfw * fpred + wbw * bpatch_all[:, j]
        corr = patch - orig_patch[:, j]
        acc = torch.cat([acc[:, :order], torch.where(
            valid[:, j, None], corr, acc[:, order:])], dim=1)
        prev = pos
        patches.append(patch)
    patches = torch.stack(patches, dim=1)                       # [C, 20, il]

    # one writeback: each patch cut where the next valid slot starts, so
    # no two kept elements share a target; the rest go to a spare column
    next_pos = torch.cat([pos64[:, 1:], pos64[:, -1:]], dim=1)
    next_valid = (torch.arange(1, N_IMPULSE_COUNT + 1, device=dev)[None, :]
                  < count[:, None])
    keep_len = torch.where(next_valid, (next_pos - pos64).clamp(max=il), il)
    ar = torch.arange(il, device=dev)
    keep = valid[:, :, None] & (ar[None, None, :] < keep_len[:, :, None])
    idx = torch.where(keep, (order + pos64)[:, :, None] + ar, wlen)
    wbf = torch.cat([wb, wb.new_zeros((c, 1))], dim=1)
    wbf.scatter_(1, idx.reshape(c, -1), patches.reshape(c, -1))
    return wbf[:, :wlen].contiguous(), count, positions, thr


def _check_repair(wb, temp, lpcs, coef_f, coef_b_rev, order, il):
    for name, v, nd in (("wb", wb, 2), ("temp", temp, 2), ("lpcs", lpcs, 2),
                        ("coef_f", coef_f, 3), ("coef_b_rev", coef_b_rev, 3)):
        require_cuda(v, name, torch.float32, nd)
    c, t = temp.shape
    if (wb.shape != (c, t + 2 * order + 2 * half_len(il))
            or lpcs.shape != (c, order + 1)
            or coef_f.shape != (c, il, order)
            or coef_b_rev.shape != (c, il, order)
            or not 1 <= order <= MAX_ORDER or il < 3):
        raise ValueError(f"repair: wb {tuple(wb.shape)}, temp "
                         f"{tuple(temp.shape)}, lpcs {tuple(lpcs.shape)}, "
                         f"coefficients {tuple(coef_f.shape)} "
                         f"{tuple(coef_b_rev.shape)}, order {order}, il {il}")


def repair(wb, temp, lpcs, coef_f, coef_b_rev, thresh: float, order: int,
           il: int):
    """Find the impulses in the residual temp [C, t] and repair them in
    the working buffer wb [C, t + 2*order + 2*PL].

    Returns (wbf: the repaired buffer [C, t + 2*order + 2*PL], count
    [C] int32, positions [C, 20] int32 (detected residual position -
    order, 0 past count), thr [C] the detection threshold).
    """
    if check_host_or_cuda(wb, "repair"):
        return repair_plain(wb, temp, lpcs, coef_f, coef_b_rev, thresh,
                            order, il)
    _check_repair(wb, temp, lpcs, coef_f, coef_b_rev, order, il)
    c, t = temp.shape
    wbf = torch.empty_like(wb)
    count = torch.empty((c,), dtype=torch.int32, device=wb.device)
    positions = torch.empty((c, N_IMPULSE_COUNT), dtype=torch.int32,
                            device=wb.device)
    thr = torch.empty((c,), dtype=torch.float32, device=wb.device)
    stream, dev = stream_and_device(wb)
    REPAIR_KERNEL.launch(wb.data_ptr(), temp.data_ptr(), lpcs.data_ptr(),
                         coef_f.data_ptr(), coef_b_rev.data_ptr(),
                         wbf.data_ptr(), count.data_ptr(),
                         positions.data_ptr(), thr.data_ptr(), c,
                         wb.shape[1], t, order, il,
                         float(np.float32(thresh)), dev, stream)
    return wbf, count, positions, thr


def repair_chain_probe(wb, temp, lpcs, coef_f, coef_b_rev, order: int,
                       il: int) -> torch.Tensor:
    """The kernel's repair chain alone, for timing: 20 repairs PL + 1
    apart from position PL on (the densest chain the search can give),
    with no statistics, search or copy.  Returns the buffer it wrote
    into (only the repaired windows are set); not counted as a launch of
    the kernel.  CUDA tensors only."""
    _check_repair(wb, temp, lpcs, coef_f, coef_b_rev, order, il)
    c, t = temp.shape
    wbf = wb.clone()
    stream, dev = stream_and_device(wb)
    REPAIR_KERNEL.probe(wb.data_ptr(), coef_f.data_ptr(),
                        coef_b_rev.data_ptr(), wbf.data_ptr(),
                        temp.data_ptr(), c, wb.shape[1], t, order, il, dev,
                        stream)
    return wbf
