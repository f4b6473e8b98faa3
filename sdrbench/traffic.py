"""The general traffic generator: one mix file -> listeners, waterfall
views and the synthetic band they listen to.

A mix (``sdrbench/traffic/<name>.json``) is data only:

- ``listeners``: how many, spread ``linspace(l_from, R - r_margin, n)``
  over the display bins, each ``min(A, width_max)`` bins wide, tuned to
  the middle of its slice;
- ``modes``: ``{"cycle": [...]}`` (listener i takes entry i mod len), or
  ``{"bands": [[upper_hz, mode], ..., [null, mode]]}`` (the first band
  whose upper edge lies above the listener's centre frequency);
- ``am_sync`` (AM listeners keep the PLL; false opts them out to the
  envelope), ``opt_in`` (``nr``, ``rds``: per-listener opt-ins);
- ``views``: ``count``, and the level and start rule of bench.py's
  mixed views (view w at level ``(w * level_step) % levels``, starting
  at ``(w * start_step) % (row width - span)``);
- ``signal``: amplitudes of the band (``tone_amp``, ``am_carrier``,
  ``am_depth``, ``fm_amp``, ``fm_dev_hz``, ``noise_rms``) and
  ``period_log2``, the period of the tones' content in samples;
- ``ring``: ``min_blocks`` and ``min_mb`` of distinct blocks;
- ``loop``: ``closed`` (the next block as soon as the driver takes one);
- ``window``: ``steady_steps`` received before the window opens;
- ``check``: ``start_steps`` compared from the stream's start,
  ``samples`` pairs of consecutive steps drawn in the window, among the
  steps ``stride`` apart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.dsp import AM, FM, LSB, MODES, USB, Plan, Table, Views


def listener_table(p: Plan, mix: dict) -> Table:
    """The listeners of the mix in channel slots 0..n-1 (the rest
    inactive)."""
    if any(mix.get("opt_in", {}).values()):
        raise ValueError("per-listener opt-ins (nr, rds, stereo) have no "
                         "reference yet")
    n = int(mix["listeners"])
    if n > p.c:
        raise ValueError(f"{n} listeners for {p.c} channel slots")
    lst = mix.get("placement", {})
    width = min(p.a, int(lst.get("width_max", 300)))
    l = np.zeros(p.c, np.int64)
    l[:n] = np.linspace(int(lst.get("l_from", 1000)),
                        p.r - int(lst.get("r_margin", 2000)), n).astype(
                            np.int64)
    r = l + width
    m = l + width // 2
    modes = np.zeros(p.c, np.int64)
    rule = mix["modes"]
    for i in range(n):
        if "cycle" in rule:
            name = rule["cycle"][i % len(rule["cycle"])]
        else:
            f = p.hz(float(m[i]))
            name = next(md for up, md in rule["bands"]
                        if up is None or f < float(up))
        modes[i] = MODES[name]
    active = np.arange(p.c) < n
    am_env = active & (modes == AM) & (not mix.get("am_sync", True))
    return Table(l=l, r=np.where(active, r, 0), m_idx=np.where(active, m, 0),
                 mode=modes, active=active, am_env=am_env)


def view_table(p: Plan, mix: dict) -> Views:
    """bench.py's views at mixed pyramid levels."""
    v = mix["views"]
    level, start, length = [], [], []
    for w in range(int(v["count"])):
        lev = (w * int(v.get("level_step", 7))) % p.levels
        row_w = p.r >> lev
        span = min(p.wf_size, row_w)
        level.append(lev)
        start.append((w * int(v.get("start_step", 131)))
                     % max(row_w - span, 1))
        length.append(span)
    return Views(np.asarray(level), np.asarray(start), np.asarray(length))


def place(p: Plan, table: Table, views: Views, channels, waterfalls) -> None:
    """Put the listeners and views into the program's registries through
    their public methods, as the server does for its clients."""
    names = {v: k for k, v in MODES.items()}
    for i in np.nonzero(table.active)[0]:
        slot = channels.acquire(f"sdrbench-{i}")
        if slot is None or slot.slot != i:
            raise RuntimeError(f"listener {i}: slot {slot}")
        if not channels.set_mode(slot, names[int(table.mode[i])]):
            raise RuntimeError(f"listener {i}: mode refused")
        if table.am_env[i]:
            channels.set_am_sync(slot, False)
        if not channels.retune(slot, int(table.l[i]), float(table.m_idx[i]),
                               int(table.r[i])):
            raise RuntimeError(f"listener {i}: retune refused")
    for w, (lev, s, n) in enumerate(zip(*views)):
        cid, ws = waterfalls.acquire()
        if cid != w:
            raise RuntimeError(f"view {w}: slot {cid}")
        # the span at level lev, asked for in full-resolution bins: the
        # level search lands on lev exactly
        waterfalls.retune(cid, ws, int(s) << int(lev), int(s + n) << int(lev))
        if ws.level != lev or ws.l != s or ws.r - ws.l != n:
            raise RuntimeError(f"view {w}: level {ws.level} [{ws.l}, "
                               f"{ws.r}) for {lev} [{s}, {s + n})")


# ----------------------------------------------------------------- the band

def _bessel(beta: float, nmax: int) -> np.ndarray:
    """J_n(beta) for n in -nmax..nmax: the Fourier coefficients of
    exp(i beta sin t)."""
    m = 256
    t = 2 * np.pi * np.arange(m) / m
    c = np.fft.fft(np.exp(1j * beta * np.sin(t))) / m
    return np.concatenate([c[m - nmax:], c[:nmax + 1]])


def components(p: Plan, table: Table, sig: dict, rng: np.random.Generator,
               period: int) -> tuple[np.ndarray, np.ndarray]:
    """Each listener's signal as complex exponentials over the tones'
    period: (frequency in cycles a period, complex amplitude).  SSB: three
    tones in the sideband; AM: a carrier near the tuned bin, 50%
    modulated by two tones; FM: a carrier near the tuned bin, one tone at
    ``fm_dev_hz`` deviation (its Bessel comb)."""
    df = p.sps / p.n                     # Hz a display bin
    per_hz = period / p.sps              # cycles a period per Hz
    freqs, amps = [], []

    def at(bin_pos: float, hz: float) -> int:
        """Cycles a period of display position ``bin_pos`` + ``hz``."""
        f = (bin_pos * df if p.is_real
             else (bin_pos - p.n / 2 + 1) * df) + hz
        return int(round(f * per_hz)) % period

    def add(f, a):
        freqs.append(f)
        amps.append(a)

    for i in np.nonzero(table.active)[0]:
        mode, m = int(table.mode[i]), float(table.m_idx[i])
        side = (float(table.r[i]) - m) * df
        phs = rng.uniform(0, 2 * np.pi, 8)
        if mode in (USB, LSB):
            sgn = 1.0 if mode == USB else -1.0
            for j, off in enumerate(rng.uniform(0.05, 0.9, 3) * side):
                a = sig["tone_amp"] * rng.uniform(0.5, 1.0)
                add(at(m, sgn * off), a * np.exp(1j * phs[j]))
            continue
        c0 = at(m, rng.uniform(-20.0, 20.0))
        if mode == AM:
            amp = sig["am_carrier"]
            add(c0, amp * np.exp(1j * phs[0]))
            depth = sig["am_depth"] * rng.dirichlet([1.0, 1.0])
            for j, fm in enumerate(rng.uniform(200.0, 3000.0, 2)):
                k = max(1, int(round(fm * per_hz)))
                for s in (1, -1):
                    add((c0 + s * k) % period, amp * depth[j] / 2
                        * np.exp(1j * (phs[0] + s * phs[1 + j])))
        elif mode == FM:
            k = max(1, int(round(rng.uniform(300.0, 1500.0) * per_hz)))
            beta = sig["fm_dev_hz"] / (k / per_hz)
            nmax = int(math.ceil(beta)) + 8
            jn = _bessel(beta, nmax)
            for j, n in enumerate(range(-nmax, nmax + 1)):
                add((c0 + n * k) % period, sig["fm_amp"] * jn[j]
                    * np.exp(1j * (phs[0] + n * phs[1])))
    return np.asarray(freqs, np.int64), np.asarray(amps, np.complex128)


def ring_blocks(p: Plan, mix: dict) -> int:
    """Blocks in the ring: at least ``min_blocks`` and ``min_mb``."""
    ring = mix["ring"]
    itemsize = np.dtype(
        {"u8": np.uint8, "s8": np.int8, "s16": np.int16}[p.fmt]).itemsize
    block_bytes = p.b * p.wire_per_hop * itemsize
    return max(int(ring["min_blocks"]),
               math.ceil(float(ring["min_mb"]) * 1e6 / block_bytes))


def make_ring(p: Plan, mix: dict, table: Table, seed: int, device
              ) -> list[np.ndarray]:
    """The ring of distinct raw blocks, each its halo first, contiguous
    and writable in pageable host memory: one continuous synthetic band
    over the ring's length (whose last hop is the first block's halo),
    made on ``device`` from ``seed`` and quantized to the wire format.

    The listeners' tones repeat every ``2**period_log2`` samples (a
    divisor of the ring's length, so the band is continuous round the
    ring); the noise is drawn afresh over the whole ring."""
    sig = mix["signal"]
    nb = ring_blocks(p, mix)
    step = p.b * p.hop                   # samples a block (no halo)
    length = nb * step
    period = 1 << int(sig["period_log2"])
    if length % period:
        raise ValueError(f"tone period {period} does not divide the ring's "
                         f"{length} samples")
    freqs, amps = components(p, table, sig, np.random.default_rng(seed),
                             period)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    dev = torch.device(device)
    if p.is_real:
        # Re(a e^{i w t}) for w < pi: half the amplitude on bin w of the
        # one-sided spectrum (the conjugate image for w > pi)
        pos = freqs <= period // 2
        freqs = np.where(pos, freqs, period - freqs)
        amps = np.where(pos, amps, np.conj(amps)) / 2
    # tones on one frequency add up (on the host: a few thousand)
    uniq, inv = np.unique(freqs, return_inverse=True)
    summed = np.zeros(uniq.shape[0], np.complex128)
    np.add.at(summed, inv, amps)
    f = torch.from_numpy(uniq).to(dev)
    a = torch.from_numpy(summed.astype(np.complex64)).to(dev)
    if p.is_real:
        spec = torch.zeros(period // 2 + 1, dtype=torch.complex64, device=dev)
        spec[f] = a
        tone = torch.fft.irfft(spec, n=period, norm="forward")
        del spec
        x = torch.randn(length, generator=gen, device=dev)
        x.mul_(float(sig["noise_rms"])).add_(
            tone.repeat(length // period))
        wire = torch.clamp(torch.round(x * 32000.0), -32768, 32767).to(
            torch.int16)
    else:
        spec = torch.zeros(period, dtype=torch.complex64, device=dev)
        spec[f] = a
        tone = torch.view_as_real(torch.fft.ifft(spec, norm="forward"))
        del spec
        x = torch.randn((length, 2), generator=gen, device=dev)
        x.mul_(float(sig["noise_rms"])).add_(
            tone.repeat(length // period, 1))
        if p.fmt != "u8":
            raise ValueError(f"IQ band in {p.fmt}: not generated")
        wire = torch.clamp(torch.round(x * 128.0 + 128.0), 0, 255).to(
            torch.uint8).reshape(-1)
    del x, tone
    wph = p.wire_per_hop
    per = step * (1 if p.is_real else 2)
    dtype = {torch.uint8: np.uint8, torch.int16: np.int16}[wire.dtype]
    blocks = []
    for j in range(nb):
        blk = np.empty((p.b + 1) * wph, dtype)
        t = torch.from_numpy(blk)
        lo = j * per
        t[:wph].copy_(wire[lo - wph:lo] if j else wire[-wph:])
        t[wph:].copy_(wire[lo:lo + per])
        blocks.append(blk)
    return blocks
