"""The comparison that decides ``correct``.

What is compared is what the timed path delivered to the sink, at the
cell's own sizes, for these steps:

- the stream's first ``start_steps`` steps, which the reference works
  out from zero carries: the start of the stream, independent of the
  program;
- ``samples`` pairs of consecutive steps (k, k + 1) in the window, drawn
  from the seed.  The reference cannot follow hundreds of steps in the
  time a run allows (its PLL and AGC run sample by sample), so it starts
  step k from the program's own carries going into it, then runs step
  k + 1 from its own: step k + 1 checks the carries step k handed on.

For each compared step, over the active listeners and every view:

- ``audio_lsb``: the widest gap between the program's int16 audio and
  the reference's (format convert, window and FFT, bin gathers and
  IFFTs, demodulators with the AM PLL, DC blocker, AGC, int16);
- ``power_rel``: the widest relative gap of the channels' slice power;
- ``wf_bytes``: how many of the views' int8 bytes differ (the pyramid
  and the view gather), the zero fill past each view's length included.

``control=True`` puts the reference computed in bfloat16 in the
program's place (``reference.dsp``'s ``lowp``): the limits' upper
readings.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import dsp


def carries_of(p: dsp.Plan, state) -> dsp.Carries:
    """The reference's carries from the program's (``HopState``), copied."""
    ch, dc, agc = state.audio.chan, state.audio.dc, state.audio.agc

    def rows(x):
        x = x.detach().clone()
        if x.shape[0] < p.c:   # a narrower channel bucket: zero rows
            pad = torch.zeros((p.c - x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad])
        return x

    def host(x, dtype):
        return rows(x).cpu().numpy().astype(dtype)

    return dsp.Carries(
        ssb_prev=rows(ch.ssb_prev), cplx_prev=rows(ch.cplx_prev),
        fm_prev=rows(ch.fm_prev), carrier_prev=rows(ch.carrier_prev),
        pll_phase=host(ch.pll_phase, np.float32),
        pll_freq=host(ch.pll_freq, np.float32),
        dc_tail=rows(dc.tail), agc_tail=rows(agc.tail),
        agc_gain=host(agc.gain, np.float32),
        agc_seen=host(agc.seen, np.int64))


class Gaps:
    """The widest gaps over the compared steps."""

    def __init__(self):
        self.audio = 0
        self.power = 0.0
        self.wf_diff = 0
        self.wf_bytes = 0

    def add(self, active, got, want) -> None:
        """got: (audio [B, C, A/2] int16, power [B, C], views [D, W, cap]
        or None, due list); want: the reference's (audio, power, rows)."""
        audio, power, wf, due = got
        w_audio, w_power, w_rows = want
        a = audio[:, active].astype(np.int64)
        b = w_audio[:, active].astype(np.int64)
        self.audio = max(self.audio, int(np.abs(a - b).max(initial=0)))
        pw, wp = power[:, active], w_power[:, active]
        rel = np.abs(pw.astype(np.float64) - wp) / np.maximum(
            np.abs(wp.astype(np.float64)), 1e-30)
        self.power = max(self.power, float(rel.max(initial=0.0)))
        if len(w_rows) != len(due) or (wf is None) != (not w_rows):
            # a due row missing or extra: every byte of the step differs
            n = max(len(w_rows), len(due)) * (wf.shape[1] * wf.shape[2]
                                              if wf is not None else 1)
            self.wf_diff += n
            self.wf_bytes += n
            return
        for d, row in enumerate(w_rows):
            for v, ref in enumerate(row):
                g = wf[d, v]
                n = ref.shape[0]
                self.wf_diff += int(np.count_nonzero(g[:n] != ref)
                                    + np.count_nonzero(g[n:]))
                self.wf_bytes += g.shape[0]

    def checks(self, limits: dict) -> dict:
        vals = {"audio_lsb": self.audio, "power_rel": self.power,
                "wf_bytes": self.wf_diff}
        return {k: {"value": v, "limit": limits[k]} for k, v in vals.items()}


def run(p, table, views, blocks, kept, states, start_steps, samples, limits,
        device, control: bool = False) -> dict:
    """The numbers compared, each beside its limit; a step the sink never
    kept, or a sampled step without the program's carries, counts as
    missing (``steps_missing``, limit 0)."""
    window = torch.from_numpy(dsp.hann(p.n)).to(device)
    gaps = Gaps()
    missing = 0
    active = np.asarray(table.active, bool)

    def chain(car, low, ks):
        """Reference (and control) steps ``ks`` from the given carries."""
        nonlocal missing
        for k in ks:
            raw = blocks[k % len(blocks)]
            car, audio, power, rows = dsp.step(p, car, raw, table, views,
                                               k * p.b, window)
            if control:
                low, la, lp, lr = dsp.step(p, low, raw, table, views,
                                           k * p.b, window, lowp=True)
                got = (la, lp, _pad(lr), dsp.due_rows(p, k * p.b))
            else:
                got = kept.get(k)
            if got is None:
                missing += 1
                continue
            gaps.add(active, got, (audio, power, rows))

    with torch.no_grad():
        zero = dsp.zero_carries(p, device)
        chain(zero, zero, range(start_steps))
        for k in samples:
            if k not in states:
                missing += 2
                continue
            chain(carries_of(p, states[k]), carries_of(p, states[k]),
                  [k, k + 1])
    out = gaps.checks(limits)
    out["steps_missing"] = {"value": missing, "limit": 0}
    return out


def _pad(rows):
    """The control's view rows as the program's [D, W, cap] array."""
    if not rows:
        return None
    cap = max(r.shape[0] for r in rows[0])
    out = np.zeros((len(rows), len(rows[0]), cap), np.int8)
    for d, row in enumerate(rows):
        for v, r in enumerate(row):
            out[d, v, :r.shape[0]] = r
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] >= c["limit"] if c.get("at_least")
               else c["value"] <= c["limit"] for c in checks.values())
