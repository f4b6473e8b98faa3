#!/usr/bin/env python3
"""Run the PyTorch port (phantomsdr_tpu_torch) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):

1. card      nvidia-smi's name and power limit, torch's device name
2. build     nvcc for every kernel of the main path (one per source, in
             parallel), from phantomsdr_tpu_torch/csrc
3. kernels   each kernel against its plain PyTorch version at the shapes
             the main path gives it (the server config of bench.py:
             u8 IQ at 35 MSPS, 2^20-point FFT, 36 hops a step, 128
             channels, 128 waterfall views), with times and bounds;
             K-PLL over three calls that carry its phase and frequency,
             and K-PLL and K-AGC beside their chain floor (the serial
             loop alone, timed by the kernel's probe entry point).
             ms is one wrapper call alone between CUDA events (the
             host's issue included); device_ms is per call over 10
             calls back to back; device_us_by_kernel is each CUDA
             kernel's time by torch.profiler
4. small     the whole step on the card against the whole step on the
             CPU (plain versions) at a small config
5. main      HopPipeline.step at full width: 10 'views' steps and 2
             'off' steps over a synthetic capture with one tone per
             demodulation mode; the tones must come out at their Hz,
             the waterfall peak on its carrier bin, and every kernel
             must have been launched
6. driver    DSPDriver over an in-memory SampleSource
7. server    the CLI's build() served on localhost; websocket clients
             on /audio and /waterfall must receive packets (skipped
             only when aiohttp is not installed)

then the kernel table, the card's nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs one CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import asyncio
import io
import json
import math
import socket
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 20261016
H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # float32 outside the tensor cores

BENCH_CFG = {
    "input": {
        "sps": 35_000_000, "frequency": 100_000_000, "fft_size": 1 << 20,
        "signal": "iq", "audio_sps": 12000, "waterfall_size": 1024,
        "driver": {"format": "u8"},
    },
    "tpu": {"hop_batch": 36, "max_channels": 128},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of one fn() call, each call alone between two
    CUDA events and synchronised, so the host's cost of issuing it counts
    too where the device would wait for it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 10, rounds: int = 3) -> float:
    """Milliseconds per fn() call on the device: ``calls`` calls back to
    back between two CUDA events, so that the host's issue runs ahead of
    the device; the median of ``rounds`` such runs."""
    import torch

    fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def device_us_by_kernel(fn, calls: int = 5) -> dict:
    """Device microseconds per fn() call of each CUDA kernel it launches
    (torch.profiler), by the kernel's function name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + ev.device_time_total / calls
    return out


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- the capture

class Tones:
    """One tone per demodulation mode on channels 0..3, placed on exact
    FFT bins (display bin m is (m - N/2 + 1) * fs/N Hz), plus noise."""

    def __init__(self, cfg):
        n, fs = cfg.fft_size, cfg.sps
        self.df = fs / n                            # Hz per bin
        self.audio_rate = cfg.audio_fft_size * self.df
        off3 = 3000 * n // fs
        off5 = 5000 * n // fs
        m = [int(0.30 * n), int(0.40 * n), int(0.60 * n), int(0.70 * n)]
        self.m = m
        # (l, r, m_idx) per channel and the audio tone in bins
        self.chans = [(m[0], m[0] + off3, m[0]), (m[1] - off3, m[1], m[1]),
                      (m[2] - off5, m[2] + off5, m[2]),
                      (m[3] - off5, m[3] + off5, m[3])]
        self.tone_bins = [30, 45, 21, 12]
        self.names = ["USB", "LSB", "AM", "FM"]
        self.usb_bin = m[0] + self.tone_bins[0]     # waterfall check
        self.fs, self.n = fs, n

    def freq(self, m: float) -> float:
        return (m - self.n / 2 + 1) * self.df

    def iq(self, start: int, count: int, gen):
        """Complex baseband samples [start, start+count) as u8
        interleaved IQ on the card."""
        import torch

        dev = "cuda"
        t = torch.arange(start, start + count, dtype=torch.float64,
                         device=dev)

        def phase(f_hz):
            cyc = torch.remainder(t * (f_hz / self.fs), 1.0)
            return 2 * math.pi * cyc

        tb = [b * self.df for b in self.tone_bins]
        x = 0.2 * torch.polar(torch.ones_like(t),
                              phase(self.freq(self.m[0]) + tb[0]))
        x = x + 0.2 * torch.polar(torch.ones_like(t),
                                  phase(self.freq(self.m[1]) - tb[1]))
        env = 1.0 + 0.5 * torch.cos(phase(tb[2]))
        x = x + 0.15 * env * torch.polar(torch.ones_like(t),
                                         phase(self.freq(self.m[2])))
        beta = 2000.0 / tb[3]                       # 2 kHz deviation
        fm_ph = phase(self.freq(self.m[3])) + beta * torch.sin(phase(tb[3]))
        x = x + 0.2 * torch.polar(torch.ones_like(t), fm_ph)
        noise = torch.randn((count, 2), dtype=torch.float64, device=dev,
                            generator=gen) * 0.01
        iq = torch.stack([x.real, x.imag], dim=-1) + noise
        return torch.clamp(torch.round(iq * 128 + 128), 0, 255).to(
            torch.uint8).reshape(-1)


def bench_tables(cfg, tones):
    """Channel table arrays (tone channels 0..3, the rest spread like
    bench.py) and 128 waterfall view starts/lengths (view 0 covers the
    USB tone at full resolution)."""
    from phantomsdr_tpu_torch.ops.quantize import pyramid_level_offsets

    c, r = cfg.max_channels, cfg.fft_result_size
    l = np.linspace(1000, r - 2000, c).astype(np.int64)
    width = np.full(c, min(cfg.audio_fft_size, 300))
    rr, mid = l + width, l + width // 2
    for i, (cl, cr, cm) in enumerate(tones.chans):
        l[i], rr[i], mid[i] = cl, cr, cm
    offs = pyramid_level_offsets(r, cfg.downsample_levels)
    starts = []
    for w in range(c):
        lev = (w * 7) % cfg.downsample_levels
        row_w = r >> lev
        span = min(cfg.waterfall_size, row_w)
        starts.append(offs[lev] + (w * 131) % max(row_w - span, 1))
    starts[0] = tones.usb_bin - 500
    lengths = np.full(c, cfg.waterfall_size)
    return (l, rr, mid, np.arange(c) % 4, np.ones(c, bool)), (
        np.asarray(starts), lengths)


def peak_hz(x: np.ndarray, rate: float) -> float:
    x = x - x.mean()
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return float(np.fft.rfftfreq(len(x), 1.0 / rate)[1 + np.argmax(spec[1:])])


def max_run_centroid(row: np.ndarray) -> float:
    """Centre of the first run of the row's maximum (a strong carrier
    clips several bins at int8 127)."""
    top = row.max()
    i = int(np.argmax(row == top))
    j = i
    while j + 1 < len(row) and row[j + 1] == top:
        j += 1
    return (i + j) / 2


# ------------------------------------------------------------------ phases

def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build(kernels):
    from phantomsdr_tpu_torch.ops.cuda.build import build_all

    t0 = time.monotonic()
    build_all(kernels)
    for k in kernels:
        k.lib()
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "libraries": [k.lib_path().name for k in kernels]})


def phase_kernels(cfg, raw0):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch

    from phantomsdr_tpu_torch.ops.agc import AGCState, make_agc_params
    from phantomsdr_tpu_torch.ops.cuda import agc, pll, waterfall
    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, spectra_from_raw, waterfall_due_positions,
    )

    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    pipe = HopPipeline(cfg, device="cuda")

    # ---- K-WF on the main path's spectra and due rows
    spec = spectra_from_raw(cfg, pipe.window, raw0, cfg.hop_batch)
    rows = torch.tensor(waterfall_due_positions(cfg, 0), dtype=torch.int32,
                        device="cuda")
    kw = dict(fft_result_size=cfg.fft_result_size, base_idx=cfg.base_idx,
              levels=cfg.downsample_levels, size_log2=cfg.size_log2)
    got = waterfall.waterfall_rows(spec, rows, **kw)
    want = waterfall.waterfall_rows_plain(spec, rows, **kw)
    torch.cuda.synchronize()
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    wf_err, wf_frac = int(diff.max()), float((diff > 0).float().mean())
    if wf_err != 0:
        raise AssertionError(f"K-WF vs plain: max {wf_err} steps on "
                             f"{wf_frac:.2e} of bins")
    d, r = rows.shape[0], cfg.fft_result_size
    p = got.shape[1]
    b_ms, b_by = bound_ms(8 * d * r + d * p, d * r * 3 + d * p * 6)
    rows_out.append(dict(
        name="K-WF waterfall pyramid", route="cuda",
        source="phantomsdr_tpu_torch/csrc/waterfall.cu",
        replaces="phantomsdr_tpu/ops/pallas/waterfall.py:96",
        shape=f"[{cfg.hop_batch}, {r}] c64 spectra, {d} due rows -> "
              f"[{d}, {p}] int8",
        max_abs_err=wf_err, frac_differing=wf_frac,
        tolerance="equal (the plain version's arithmetic and pair order)",
        ms=time_ms(lambda: waterfall.waterfall_rows(spec, rows, **kw), 20),
        device_ms=device_ms(lambda: waterfall.waterfall_rows(spec, rows,
                                                             **kw)),
        device_us_by_kernel=device_us_by_kernel(
            lambda: waterfall.waterfall_rows(spec, rows, **kw)),
        plain_ms=time_ms(
            lambda: waterfall.waterfall_rows_plain(spec, rows, **kw), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del spec, got, want

    # ---- K-PLL on [C, B*half] AM streams: carriers a few Hz off, 0.5
    # modulated baseband plus noise; three consecutive calls carry the
    # phase and frequency from one to the next
    c, half = cfg.max_channels, cfg.audio_fft_size // 2
    n = cfg.hop_batch * half
    calls = 3
    t = torch.arange(calls * n, device="cuda", dtype=torch.float32)
    off = (torch.rand(c, 1, device="cuda", generator=gen) - 0.5) * 0.02
    ph0 = torch.rand(c, 1, device="cuda", generator=gen) * 6.0
    car = torch.polar(torch.ones(c, calls * n, device="cuda"), off * t + ph0)
    msg = 1.0 + 0.5 * torch.sin(0.1 * t)[None, :]
    noise = torch.randn(c, calls * n, 2, device="cuda", generator=gen) * 0.01
    carrier_all = car + torch.view_as_complex(noise)
    baseband_all = (car * msg).to(torch.complex64)
    segs = [(carrier_all[:, k * n:(k + 1) * n].contiguous(),
             baseband_all[:, k * n:(k + 1) * n].contiguous())
            for k in range(calls)]
    carrier, baseband = segs[0]
    phase0 = torch.zeros(c, device="cuda")
    freq0 = torch.zeros(c, device="cuda")
    scale = float(baseband_all.abs().max())
    pll_err = 0.0
    kcar = pcar = (phase0, freq0)
    for k, (seg_c, seg_b) in enumerate(segs):
        got = pll.am_sync_detect(seg_c, seg_b, *kcar)
        want = pll.am_sync_detect_plain(seg_c, seg_b, *pcar)
        torch.cuda.synchronize()
        pll_err = max(pll_err, float((got[0] - want[0]).abs().max()))
        if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
            raise AssertionError(f"K-PLL vs plain: phase/freq carries differ "
                                 f"after call {k + 1}")
        kcar, pcar = got[1:], want[1:]
    if not pll_err <= PLL_ATOL * scale:
        raise AssertionError(f"K-PLL vs plain: max |diff| {pll_err} > "
                             f"{PLL_ATOL} * {scale}")
    del carrier_all, baseband_all, car, msg, noise, t
    b_ms, b_by = bound_ms(c * n * (8 + 8 + 4) + 4 * c * 4,
                          c * n * PLL_OPS_PER_SAMPLE)

    def run_pll():
        pll.am_sync_detect(carrier, baseband, phase0, freq0)

    rows_out.append(dict(
        name="K-PLL AM carrier PLL", route="cuda",
        source="phantomsdr_tpu_torch/csrc/pll.cu",
        replaces="phantomsdr_tpu/ops/channelizer.py:155 (lax.scan via "
                 "ops/unroll.py:60)",
        shape=f"[{c}, {n}] c64 carrier + baseband -> [{c}, {n}] f32",
        max_abs_err=pll_err, chained_calls=calls,
        tolerance=f"|diff| <= {PLL_ATOL} * max|baseband|, carries equal",
        ms=time_ms(run_pll, 10),
        device_ms=device_ms(run_pll),
        plain_ms=time_ms(lambda: pll.am_sync_detect_plain(
            carrier, baseband, phase0, freq0), 1, warmup=0),
        chain_floor_ms=device_ms(lambda: pll.chain_probe(carrier, phase0,
                                                         freq0)),
        device_us_by_kernel=device_us_by_kernel(run_pll),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        chain_note=f"{n} dependent loop steps per channel"))

    # ---- K-AGC on [C, B*half] streams with a mix of warm-up states
    params = make_agc_params(cfg.audio_sps)
    w = params.window
    x = torch.randn(c, n, device="cuda", generator=gen) * 0.05
    x[:, ::97] *= 8.0
    x[c // 2:] *= 10.0
    state = AGCState(
        tail=torch.randn(c, w - 1, device="cuda", generator=gen) * 0.05,
        gain=torch.rand(c, device="cuda", generator=gen) * 5.0,
        seen=torch.tensor([0, w // 2, w - 1, w] * (c // 4),
                          dtype=torch.int32, device="cuda"))
    b = cfg.hop_batch
    out_k = torch.empty(b, c, half, dtype=torch.int16, device="cuda")
    out_p = torch.empty_like(out_k)
    st_k = agc.agc_int16(state, x, params, out_k)
    st_p = agc.agc_int16_plain(state, x, params, out_p)
    torch.cuda.synchronize()
    agc_err = int((out_k.to(torch.int32) - out_p.to(torch.int32)).abs().max())
    if agc_err > 1:
        raise AssertionError(f"K-AGC vs plain: int16 max |diff| {agc_err}")
    if not (torch.equal(st_k.tail, st_p.tail)
            and torch.equal(st_k.seen, st_p.seen)
            and torch.allclose(st_k.gain, st_p.gain, rtol=1e-5)):
        raise AssertionError("K-AGC vs plain: carried state differs")
    m = w - 1 + n
    b_ms, b_by = bound_ms(c * (4 * n + 4 * (w - 1) + 8) + c * (2 * n
                          + 4 * (w - 1) + 8),
                          c * (m * math.log2(w) + n * AGC_OPS_PER_SAMPLE))
    rows_out.append(dict(
        name="K-AGC look-ahead AGC + int16", route="cuda",
        source="phantomsdr_tpu_torch/csrc/agc.cu",
        replaces="phantomsdr_tpu/ops/agc.py:193 (lax.scan) + "
                 "agc.py:108 (_sliding_max_abs)",
        shape=f"[{c}, {n}] f32, window {w} -> [{b}, {c}, {half}] int16",
        max_abs_err=agc_err, tolerance="int16 |diff| <= 1",
        ms=time_ms(lambda: agc.agc_int16(state, x, params, out_k), 20),
        device_ms=device_ms(lambda: agc.agc_int16(state, x, params, out_k)),
        plain_ms=time_ms(lambda: agc.agc_int16_plain(state, x, params,
                                                     out_p), 1, warmup=0),
        chain_floor_ms=device_ms(lambda: agc.chain_probe(x, state.gain,
                                                         params)),
        device_us_by_kernel=device_us_by_kernel(
            lambda: agc.agc_int16(state, x, params, out_k)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        chain_note=f"{n} dependent gain steps per channel"))
    for row in rows_out:
        row["bound_us"] = row["bound_ms"] * 1e3
        emit({"phase": "kernel", **row})
    return rows_out


# per-sample operation counts used for the operations bound (float32
# operations, transcendental functions counted as ~20 each)
PLL_OPS_PER_SAMPLE = 60
AGC_OPS_PER_SAMPLE = 12
# K-PLL vs its plain version: the same float32 recursion in the same
# operation order; only sin/cos/atan2 may round differently (a few ulps
# a sample), and the stable 2nd-order loop pulls such a phase error back
# within ~1/sqrt(bandwidth) ~ 32 samples instead of accumulating it --
# the bound of tests/test_torch_channelizer.py (PLL_RTOL)
PLL_ATOL = 1e-5


def phase_small():
    """Whole step on the card vs the whole step on the CPU, 4 steps."""
    import torch

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.pipeline import HopPipeline, channels_from_numpy

    cfg = config_from_dict({
        "input": {"sps": 192000, "frequency": 7000000, "fft_size": 4096,
                  "signal": "iq", "audio_sps": 2000, "waterfall_size": 512,
                  "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 4, "max_channels": 16}})
    c, r = cfg.max_channels, cfg.fft_result_size
    l = np.linspace(10, r - 300, c).astype(np.int32)
    rng = np.random.default_rng(SEED)
    results = {}
    for dev in ("cuda", "cpu"):
        pipe = HopPipeline(cfg, device=dev)
        table = channels_from_numpy(l, l + 100, l + 50, np.arange(c) % 4,
                                    np.ones(c, bool), device=dev)
        state = pipe.init_state()
        rng = np.random.default_rng(SEED)
        audio, pyr = [], []
        for _ in range(6):
            n = (cfg.hop_batch + 1) * pipe.wire_per_hop
            raw = (rng.integers(-3000, 3000, n)
                   + 8000 * np.sin(0.13 * np.arange(n))).astype(np.int16)
            state, out = pipe.step(state, torch.from_numpy(raw).to(dev),
                                   table, waterfall="full")
            audio.append(out.audio.cpu().numpy().astype(int))
            pyr.append(out.pyramid.cpu().numpy().astype(int))
        results[dev] = (np.concatenate(audio), np.concatenate(pyr))
    a_err = int(np.abs(results["cuda"][0] - results["cpu"][0]).max())
    wdiff = np.abs(results["cuda"][1] - results["cpu"][1])
    if a_err > 4 or wdiff.max() > 1 or (wdiff > 0).mean() >= 1e-3:
        raise AssertionError(f"card vs CPU step: audio {a_err}, waterfall "
                             f"{wdiff.max()} on {(wdiff > 0).mean():.2e}")
    emit({"phase": "small", "audio_max_abs_int16": a_err,
          "audio_peak_int16": int(np.abs(results["cpu"][0]).max()),
          "waterfall_max_steps": int(wdiff.max()),
          "waterfall_frac_differing": float((wdiff > 0).mean())})


def phase_main(cfg, tones, stream, kernels):
    """Full width main path: 10 'views' + 2 'off' steps."""
    import torch

    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, WaterfallViews, channels_from_numpy, to_device,
        waterfall_due_positions,
    )

    pipe = HopPipeline(cfg, device="cuda")
    table_np, (starts, lengths) = bench_tables(cfg, tones)
    table = channels_from_numpy(*table_np, device="cuda")
    views = WaterfallViews(start=to_device(starts, torch.int32, "cuda"),
                           length=to_device(lengths, torch.int32, "cuda"))
    due = waterfall_due_positions(cfg, 0)
    due_idx = to_device(due, torch.int32, "cuda")
    state = pipe.init_state()
    blk = cfg.hop_batch * pipe.wire_per_hop
    modes = ["views"] * 10 + ["off"] * 2
    audio, wf, step_ms = [], [], []
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    for s, mode in enumerate(modes):
        raw = stream[s * blk: s * blk + blk + pipe.wire_per_hop]
        t0 = time.perf_counter()
        state, out = pipe.step(state, raw, table, views, mode,
                               due_idx=due_idx)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        audio.append(out.audio[:, :4].cpu().numpy())
        if mode == "views":
            wf.append(out.wf.cpu().numpy())
        if not bool(torch.isfinite(out.avg_power).all()):
            raise AssertionError(f"step {s}: non-finite channel power")
    launches = {k.name: k.launches for k in kernels}

    # tones: the last 6 steps (the AGC has settled after ~1 s)
    res = {}
    a = np.concatenate(audio)[-6 * cfg.hop_batch:]      # [hops, 4, half]
    for i, name in enumerate(tones.names):
        x = a[:, i].reshape(-1).astype(np.float64)
        want = tones.tone_bins[i] * tones.df
        got = peak_hz(x, tones.audio_rate)
        res[name] = {"want_hz": want, "got_hz": got,
                     "rms": float(np.sqrt(np.mean(x ** 2)))}
        if abs(got - want) > 3.0 or res[name]["rms"] < 100:
            raise AssertionError(f"{name} tone at {got} Hz (rms "
                                 f"{res[name]['rms']}), want {want}")
    # waterfall: view 0 starts 500 bins below the USB tone (level 0)
    cents = [max_run_centroid(v[0, :cfg.waterfall_size])
             for step in wf for v in step]
    if any(abs(cc - 500) > 1 for cc in cents):
        raise AssertionError(f"waterfall peak off the carrier: {cents}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    views_ms = step_ms[1:10]
    med = float(np.median(views_ms))
    samples = cfg.hop_batch * cfg.hop_size
    emit({"phase": "main", "steps": modes, "launches": launches,
          "tones": res, "waterfall_peak_offsets": sorted(set(cents)),
          "step_ms": step_ms, "views_step_ms_median": med,
          "off_step_ms": step_ms[10:],
          "msps": samples / (med * 1e-3) / 1e6,
          "samples_per_step": samples, "due_rows": len(due)})
    return launches


def phase_driver(cfg, tones, host_bytes):
    from phantomsdr_tpu_torch.ops.quantize import pyramid_level_offsets
    from phantomsdr_tpu_torch.runtime.driver import DSPDriver, SampleSource
    from phantomsdr_tpu_torch.runtime.registry import (
        ChannelRegistry, WaterfallRegistry,
    )

    src = SampleSource(cfg, io.BytesIO(host_bytes))
    channels = ChannelRegistry(cfg)
    slot = channels.acquire("smoke")
    l, r, m = tones.chans[0]
    channels.retune(slot, l, float(m), r)
    wf = WaterfallRegistry(cfg, pyramid_level_offsets(
        cfg.fft_result_size, cfg.downsample_levels))
    wf.acquire()
    got, done, bad = [], threading.Event(), []
    nblocks = len(host_bytes) // (cfg.hop_batch * cfg.hop_size * 2)

    def consumer(frame0, audio, pwr, wfv, due, wf_meta, audio_meta, rds):
        if audio.shape[0] != cfg.hop_batch or not np.isfinite(pwr).all():
            bad.append((frame0, audio.shape))
        got.append((frame0, wfv is not None))
        if len(got) >= nblocks:
            done.set()

    drv = DSPDriver(cfg, src, channels, consumer, waterfall_registry=wf,
                    waterfall_active=lambda: True, device="cuda")
    drv.start()
    ok = done.wait(timeout=300)
    drv.stop()
    snap = drv.metrics.snapshot(cfg)
    if not ok or bad or drv.metrics.device_errors:
        raise AssertionError(f"driver: {len(got)}/{nblocks} batches, bad "
                             f"{bad}, errors {drv.metrics.device_errors} "
                             f"{drv.metrics.last_device_error}")
    emit({"phase": "driver", "batches": len(got),
          "device_errors": drv.metrics.device_errors,
          "step_ms_p50": snap["step_ms_p50"],
          "msps_device": snap["msps_device"]})


async def _server_clients(port: int, tones):
    import aiohttp

    out = {}
    async with aiohttp.ClientSession() as s:
        async with s.ws_connect(f"http://127.0.0.1:{port}/audio",
                                max_msg_size=1 << 22) as ws:
            info = json.loads((await ws.receive(timeout=120)).data)
            l, r, m = tones.chans[0]
            await ws.send_str(json.dumps({"cmd": "window", "l": l,
                                          "m": float(m), "r": r}))
            n = 0
            deadline = time.monotonic() + 120
            while n < 3 and time.monotonic() < deadline:
                msg = await ws.receive(timeout=120)
                if msg.type == aiohttp.WSMsgType.BINARY:
                    n += 1
            out["audio_packets"] = n
            out["basic_info_fft_size"] = info.get("fft_size")
        async with s.ws_connect(f"http://127.0.0.1:{port}/waterfall",
                                max_msg_size=1 << 22) as ws:
            n = 0
            deadline = time.monotonic() + 120
            while n < 2 and time.monotonic() < deadline:
                msg = await ws.receive(timeout=120)
                if msg.type == aiohttp.WSMsgType.BINARY:
                    n += 1
            out["waterfall_packets"] = n
    return out


def phase_server(cfg, tones, host_bytes):
    try:
        from aiohttp import web
    except ImportError:
        emit({"server_phase": "skipped: aiohttp not installed"})
        return
    from phantomsdr_tpu_torch.main import build

    server, driver = build(cfg, io.BytesIO(host_bytes), loop_file=True,
                           device="cuda")
    driver.start()

    async def run():
        runner = web.AppRunner(server.app)
        await runner.setup()
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        site = web.TCPSite(runner, "127.0.0.1", port)
        await site.start()
        try:
            return await _server_clients(port, tones)
        finally:
            driver.stop()       # no dispatch into a closing loop
            await runner.cleanup()

    try:
        res = asyncio.run(run())
    finally:
        driver.stop()
    if res["audio_packets"] < 3 or res["waterfall_packets"] < 2:
        raise AssertionError(f"server: {res}")
    if driver.metrics.device_errors:
        raise AssertionError(f"server: device errors "
                             f"{driver.metrics.last_device_error}")
    emit({"phase": "server", **res,
          "device_errors": driver.metrics.device_errors})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.ops.cuda import agc, pll, waterfall

    torch.manual_seed(SEED)
    kernels = [waterfall.KERNEL, pll.KERNEL, agc.KERNEL]
    smi = phase_card()
    phase_build(kernels)

    cfg = config_from_dict(BENCH_CFG)
    tones = Tones(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hop = cfg.hop_size
    blk = cfg.hop_batch * hop
    stream = torch.cat([tones.iq(s * blk, blk, gen) for s in range(12)]
                       + [tones.iq(12 * blk, hop, gen)])
    rows = phase_kernels(cfg, stream[:(cfg.hop_batch + 1) * 2 * hop])
    phase_small()
    launches = phase_main(cfg, tones, stream, kernels)
    host_bytes = stream[:4 * 2 * blk].cpu().numpy().tobytes()
    del stream
    phase_driver(cfg, tones, host_bytes)
    phase_server(cfg, tones, host_bytes)

    for row in rows:
        row["launches"] = launches[next(k.name for k in kernels
                                        if row["source"].endswith(
                                            f"/{k.name}.cu"))]
        row["checked"] = True
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
