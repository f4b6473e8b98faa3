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
             calls back to back; kernel_ms is the device work of one
             call alone, with the host's launch work hidden behind a
             device spin; device_us_by_kernel is each CUDA kernel's time a
             call by torch.profiler, device_us_per_launch the mean of
             one recorded launch and profiler_records how many launches
             it recorded (it loses some of the port's)
             K-PILOT, K-DEEMPH and K-AGC's float mode at the shapes of
             the wideband WBFM step (128 channels x 40,272 samples),
             K-PILOT's sine against sinf on every float32 of [-0, 2pi]
             and its chain floor beside the old one (the earlier
             design's loop body: libdevice sinf, the wrap a branch);
             K-NR, K-ANR and K-NB at the shapes of the bench config
             with [input] nr (128 channels x 36 frames x 180 samples),
             over two calls that carry their state, K-NR also with every
             third channel silent from the start, its written-out
             division and square root against the IEEE ones on 2^32
             inputs each and its chain floor in cycles a frame, K-NB's line
             with the impulses per channel and the threshold margins
4. small     the whole step on the card against the whole step on the
             CPU (plain versions) at a small config; small_wbfm the same
             with stereo + RDS + de-emphasis + Opus decimation; small_nr
             the same with nr = true for each nr_algo
5. main      HopPipeline.step at full width: 10 'views' steps and 2
             'off' steps over a synthetic capture with one tone per
             demodulation mode; the tones must come out at their Hz,
             the waterfall peak on its carrier bin, and every kernel
             must have been launched
5b. mesh     mesh server mode on this card: the bench config as 4
             shards on cuda:0 (parallel.sharded: the halo passed along
             the ring, the spectra gathered, the channels sharded), 6
             'views' steps held against the single-device step on the
             same stream (int16 audio within 4, power rtol 2e-4,
             waterfall rows within one step on < 0.1% of bytes); both
             steps' times, device-busy shares and peak device memory;
             whether libaom loaded and, if so, the mesh's waterfall rows
             through the port's AV1 encoder and decoder, losslessly
5c. multihost  multi-host server mode on this card: two processes of
             this script (--multihost-worker) run the CLI's cluster path
             (multihost.bootstrap, main.build_multihost, MultihostDriver)
             on cuda:0 (gloo, staged through pinned host memory: NCCL
             refuses two ranks on one card), one shard of the bench
             config each, every channel slot a listener and every
             waterfall slot a client; process 0 reads 6 blocks and ships
             process 1 its rows and the control block over the TCP link;
             what each driver hands its serving edge (its channels, the
             waterfall replica) is held against the single device on the
             same stream and tables with the mesh phase's tolerances; the
             ingest's cycle (one dispatch to the next, the link
             included) beside a block's real time, the drivers' step
             times, staging times, device-busy shares, peak device
             memory and the kernels' launches of each process
6. driver    DSPDriver over an in-memory SampleSource; mesh_driver the
             same in mesh mode over 8 blocks, the USB listener's tone
             checked on the last 4
7. server    the CLI's build() served on localhost; websocket clients
             on /audio and /waterfall must receive packets (skipped
             only when aiohttp is not installed); mesh_server the same
             in mesh mode; multihost_server two processes of
             `python -m phantomsdr_tpu_torch --device cuda --coordinator
             ... --num-processes 2` on this card, the clients on the
             follower's port, SIGTERM ending both
7b. nr       the bench config with nr = true for each nr_algo
             (spectral, lms, notch, nb), every listener opted in, 10
             'views' steps with the nr column off and then on: each
             processor judged on its listener as tools/verify judges it
             (noise floor, LMS SNR gain, notch depth, click count), step
             time, profiler split, device-busy share
8. wbfm      the wideband profile (20 MSPS, 2^20 FFT, 192 kHz audio, 128
             WBFM channels over four synthetic stereo stations) with
             stereo, de-emphasis and Opus decimation: 10 steps; each ear
             must carry its tone with > 20 dB rejection of the other
             through the 48 kHz stream; step time, a profiler split of
             the stages, a short DSPDriver run
9. rds       the soak profile (1.536 MSPS, FFT 131072, stereo + RDS +
             de-emphasis, 128 channels) over an FM capture of an RDS
             MPX: the host decoder must assemble the exact PI and PS
10. entry    phantomsdr_tpu_torch.entry: entry() on cuda:0 stepped twice
             against entry(device="cpu") on the same inputs (int16
             within 4, power rtol 2e-4, waterfall within one step), then
             dryrun_multichip(4) as 4 shards on this card
11. profile  tools/torch_profile.py's stage table at the bench config
             with the opt-in stages: stages, substages, the ingest and
             packing outside them, the host-issue times, the end-to-end
             step; each stage must launch its kernels
12. verify_tone  the tools/verify tone check through the CLI on the card
             (captures.py, python -m phantomsdr_tpu_torch --device cuda,
             client.py's tone check for 8 s through the port's decoders,
             tools/torch_clients.tone_check): the tone's Hz, the
             waterfall rows on the carrier, the CLI's launches
12b. verify_variants  tools/verify's other checks through the CLI on the
             card, three runs at a time: for each of am, stereo, rds,
             both, de, soak, nr and lms (not both over Opus: the card's
             machine has no libopus), the capture of
             tools/torch_verify.make, `python -m phantomsdr_tpu_torch
             --loop --throttle --device cuda` on a free port (killed by
             its PID) and `tools/torch_verify.py check` (client.py's
             windows, trims and bars on the port's decoders); each run's
             figures beside client.py's bars, the kernels its config
             turns on launched, no device error, the server's step time
             and RSS
13. soak_smoke  tools/torch_soak.py for 60 s on the card with loosened
             bars: at least 100 audio and 100 waterfall packets, no
             error, the CLI's launches of K-WF, K-PLL and K-AGC
14. ingest   tools/torch_ingest_bench.py at the bench config's block
             (36 hops, u8 IQ): the pipe read, the upload (the halo
             concat, the pinned copy, the copy to the card) and the
             driver-shaped overlap, which must sustain 35 MSPS
15. serve_full  the north-star deployment through the CLI: `python -m
             phantomsdr_tpu_torch --device cuda` on the bench config
             read from stdin, fed through a pipe at 70 MB/s by
             tools/torch_clients.PipeFeeder from 4 blocks of the main
             phase's capture; tools/torch_stress.py's 100 churning audio
             and 28 waterfall clients (half on deflate, every 10th
             decoding its stream) for 60 s, and beside them a steady
             listener on each tone (USB, LSB, AM with the PLL, FM) and
             a waterfall client on the USB carrier.  It must hold: the
             feed at >= 69 MB/s with no lag of a block, 35 MSPS within
             2% from /metrics over the window, no device error, no
             dropped encode, a dispatch p99 under a block's 539 ms, no
             client or decode error, each steady listener at >= 0.95 of
             the packet rate the step cadence implies with its tone at
             its Hz within 3 Hz, the waterfall peak on the carrier, and
             K-WF, K-PLL and K-AGC launched in the window; with the
             server's CPU seconds a second, threads, RSS, device memory,
             step time, device-busy share and encode queue depth
16. bench    `python -m phantomsdr_tpu_torch.bench --profile iq`, then
             `--profile real` (bench.py's counterpart, at bench.py's own
             window lengths, in build/bench/): each last stdout line
             bench.py's four keys with a value > 0, each details file
             K-WF, K-PLL and K-AGC launched in the timed windows; the
             value, the windows, the with-ingest MSPS and the step ms
17. serve_rx888  configs/config.example.rx888.toml as shipped (s16 real
             at 70 MSPS, 2^20-point FFT, 12 hops a step, 128 channels,
             the LSB default at 7.1 MHz; only its port set) through the
             CLI, read from stdin at 140 MB/s (PipeFeeder, RealTones'
             blocks): serve_full's clients and bars for 30 s, taken over
             to this deployment (the feed >= 138.6 MB/s with its longest
             lag under 539 ms, 70 MSPS within 2%, the dispatch p99 under
             one block, 89.9 ms), its steady listeners tuned by the
             real-input mapping (tools/torch_clients.hz_to_bin) plus one
             on the default window

The real-input path: the kernels phase holds
K-WF, K-PLL and K-AGC also at bench.py's real profile (REAL_CFG: s16
real at 70 MSPS, 96 hops a step, 64 channels, waterfall 1024) -- K-WF on
the 8 due rows of a [96, 524,289] spectrum, base_idx 0, 10 levels,
equal; K-PLL at [64, 8640] over three chained calls and K-AGC at [64,
8640] at their lines' tolerances -- as a ``real`` object on each line;
after small_nr, small_real runs the whole real step on the card against
the CPU at the rx888 TOML's sizes over 128 (SMALL_REAL_CFG: FFT 8192,
12 hops, 16 channels, am_sync on with one envelope listener, 'views'
then 'off'; phase_small's tolerances, the power within rtol 2e-4); after
main, real runs HopPipeline.step at REAL_CFG for 8 'views' and 2 'off'
steps over RealTones' capture (a tone per mode on exact bins in 0-35
MHz) with main's criteria, the step ms and the device-busy share.

then the whole script's time, the kernel table, the card's nvidia-smi
line, and as the last line
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
from pathlib import Path
from typing import NamedTuple

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
# configs/config.example.wideband.toml (the reference's own config.toml:
# 20 MSPS, 2^20-point FFT, 192 kHz WBFM audio) with WBFM stereo,
# de-emphasis and Opus (device decimation /4 to 48 kHz)
WIDEBAND_CFG = {
    "input": {
        "sps": 20_000_000, "frequency": 98_000_000, "fft_size": 1 << 20,
        "signal": "iq", "audio_sps": 192000, "waterfall_size": 2048,
        "stereo": True, "deemphasis": 75, "audio_compression": "opus",
        "driver": {"format": "u8"},
    },
    "tpu": {"hop_batch": 8, "max_channels": 128},
}
# tools/verify/captures.py's soak profile: 1.536 MSPS, FFT 131072,
# 192 kHz audio, stereo + RDS + de-emphasis 75 us
SOAK_CFG = {
    "input": {
        "sps": 1_536_000, "frequency": 98_000_000, "fft_size": 131072,
        "signal": "iq", "audio_sps": 192000, "waterfall_size": 1024,
        "stereo": True, "rds": True, "deemphasis": 75,
        "driver": {"format": "s16"},
    },
    "tpu": {"hop_batch": 4, "max_channels": 128},
}
# bench.py's real profile (RX888 class): s16 real at 70 MSPS, 2^20-point
# FFT (524,288 display bins), 96 hops a step, 64 channels, waterfall 1024
REAL_CFG = {
    "input": {
        "sps": 70_000_000, "frequency": 0, "fft_size": 1 << 20,
        "signal": "real", "audio_sps": 12000, "waterfall_size": 1024,
        "driver": {"format": "s16"},
    },
    "tpu": {"hop_batch": 96, "max_channels": 64},
}
# configs/config.example.rx888.toml with its sizes over 128 (546,875 S/s,
# FFT 8192, waterfall 16: the same 66.76 Hz a bin, 180-point audio IFFTs,
# skip_num 12 and 9 pyramid levels), 16 channels
SMALL_REAL_CFG = {
    "input": {
        "sps": 546_875, "frequency": 0, "fft_size": 8192, "signal": "real",
        "audio_sps": 12000, "waterfall_size": 16,
        "driver": {"format": "s16"},
    },
    "tpu": {"hop_batch": 12, "max_channels": 16},
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


def device_us_by_kernel(fn, calls: int = 5, records: dict | None = None,
                        per_launch: dict | None = None) -> dict:
    """Device microseconds per fn() call of each CUDA kernel it launches
    (torch.profiler), by the kernel's function name: the kernel's total
    over ``calls`` calls, divided by ``calls``.

    The profiler does not keep every record of the port's own
    (ctypes-launched) kernels when they run back to back: on the card it
    kept 1-5 of 5, with or without the two warm-up calls run here before
    the recorded ones.  So ``records``, where given, receives the number
    of launches of each kernel it recorded, and ``per_launch`` the mean
    device microseconds of one recorded launch -- the figure to use
    where records are missing."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    warm = 2
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warm, active=calls,
                                   repeat=1)) as prof:
        for _ in range(warm + calls):
            fn()
            torch.cuda.synchronize()
            prof.step()
    out, total, count = {}, {}, {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            total[name] = total.get(name, 0.0) + ev.device_time_total
            count[name] = count.get(name, 0) + ev.count
    for name in total:
        out[name] = total[name] / calls
        if records is not None:
            records[name] = count[name]
        if per_launch is not None:
            per_launch[name] = total[name] / count[name]
    return out


def profiled(fn, calls: int = 5) -> dict:
    """``device_us_by_kernel`` of fn and, beside it, the launches of
    each kernel the profiler recorded in those calls and the mean device
    microseconds of one recorded launch."""
    rec, mean = {}, {}
    us = device_us_by_kernel(fn, calls, rec, mean)
    return {"device_us_by_kernel": us, "device_us_per_launch": mean,
            "profiler_records": {"calls": calls, **rec}}


def flush_l2() -> None:
    """Evict the card's 50 MB L2 cache (write 128 MB)."""
    import torch

    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    _FLUSH.zero_()


_FLUSH = None


def kernel_ms(fn, reps: int = 10, cold: bool = False) -> float:
    """Median milliseconds of the device work of one fn() call: CUDA
    events recorded right around the call while the device is kept busy
    (``torch.cuda._sleep``) until the call's launches are queued, so
    that neither the host's launch work nor an idle gap counts.  With ``cold``
    the L2 cache is flushed before each call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if cold:
            flush_l2()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# about 1 ms of device spin at the H100's clock: far longer than the
# host's work to launch one wrapper call
SPIN_CYCLES = 2_000_000


def sm_cycles_per_ms(reps: int = 5) -> float:
    """The SM clock of this run: cycles of a device spin
    (``torch.cuda._sleep``) per millisecond it took, the median of
    ``reps``."""
    import torch

    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SPIN_CYCLES)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return SPIN_CYCLES / float(np.median(times[1:]))


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


class RealTones:
    """The real-input counterpart of Tones: one tone per demodulation
    mode on an exact FFT bin in 0-35 MHz (the bin of f Hz is f * 2R /
    sps, R = N/2 display bins from 0 Hz), plus noise, as s16 real.  The
    LSB tone lies 15 bins under 7.1 MHz, inside the default LSB window of
    configs/config.example.rx888.toml (l = 106,333, m = 106,355.57, r =
    106,355 at its 2^20-point FFT)."""

    def __init__(self, cfg):
        n, fs, r = cfg.fft_size, cfg.sps, cfg.fft_result_size
        self.df = fs / n                            # Hz per bin
        self.audio_rate = cfg.audio_fft_size * self.df
        off3 = 3000 * n // fs                       # 3 / 5 kHz in bins
        off5 = 5000 * n // fs
        m = [int(0.30 * r), int(7_100_000 * n / fs), int(0.60 * r),
             int(0.70 * r)]
        self.m = m
        self.chans = [(m[0], m[0] + off3, m[0]), (m[1] - off3, m[1], m[1]),
                      (m[2] - off5, m[2] + off5, m[2]),
                      (m[3] - off5, m[3] + off5, m[3])]
        self.tone_bins = [15, 15, 10, 6]
        self.names = ["USB", "LSB", "AM", "FM"]
        self.usb_bin = m[0] + self.tone_bins[0]     # waterfall check
        self.fs, self.n = fs, n

    def real(self, start: int, count: int, gen):
        """Samples [start, start+count) as s16 on the card; every phase
        is 2 pi (t * bin mod N) / N in integers, so exact at any t."""
        import torch

        t = torch.arange(start, start + count, dtype=torch.int64,
                         device="cuda")

        def phase(b: int):
            return (torch.remainder(t * b, self.n).to(torch.float64)
                    * (2 * math.pi / self.n))

        m, tb = self.m, self.tone_bins
        x = 0.2 * torch.cos(phase(m[0] + tb[0]))
        x += 0.2 * torch.cos(phase(m[1] - tb[1]))
        x += 0.15 * (1.0 + 0.5 * torch.cos(phase(tb[2]))) * torch.cos(
            phase(m[2]))
        beta = 2000.0 / (tb[3] * self.df)           # 2 kHz deviation
        x += 0.2 * torch.cos(phase(m[3]) + beta * torch.sin(phase(tb[3])))
        x += torch.randn(count, dtype=torch.float64, device="cuda",
                         generator=gen) * 0.01
        return torch.clamp(torch.round(x * 32000), -32768, 32767).to(
            torch.int16)


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


# tests/test_rds.py's RDS bitstream and MPX (that file imports JAX),
# with the port's block encoder
RDS_PI, RDS_PS, RDS_RT = 0x54A7, "PHANTOM!", "TPU SPECTRUM SERVER RADIOTEXT"


def rds_group_bits() -> list[int]:
    """Clean RDS bitstream: 0A (PS) + 2A (RadioText) groups."""
    from phantomsdr_tpu_torch.runtime.rds import (
        OFFSET_A, OFFSET_B, OFFSET_C, OFFSET_D, encode_block,
    )

    blocks = []
    for seg in range(4):
        b = (0 << 12) | (9 << 5) | seg
        d = (ord(RDS_PS[2 * seg]) << 8) | ord(RDS_PS[2 * seg + 1])
        blocks += [(RDS_PI, OFFSET_A), (b, OFFSET_B), (0xE0E0, OFFSET_C),
                   (d, OFFSET_D)]
    text = (RDS_RT + "\r").ljust(64)[:64]
    for seg in range(16):
        b = (2 << 12) | (9 << 5) | seg
        c = (ord(text[4 * seg]) << 8) | ord(text[4 * seg + 1])
        d = (ord(text[4 * seg + 2]) << 8) | ord(text[4 * seg + 3])
        blocks += [(RDS_PI, OFFSET_A), (b, OFFSET_B), (c, OFFSET_C),
                   (d, OFFSET_D)]
    bits = []
    for data, off in blocks:
        w = encode_block(data, off)
        bits += [(w >> i) & 1 for i in range(25, -1, -1)]
    return bits


def rds_mpx(n: int, fs: float, rds_amp: float = 0.06) -> np.ndarray:
    """FM MPX at fs: mono + 9% pilot + stereo DSB (800 Hz left only,
    1300 Hz right only) + the differentially encoded biphase RDS stream
    at 1187.5 bps on 57 kHz, float32."""
    tx = np.bitwise_xor.accumulate(np.array(rds_group_bits() * 40))
    pos = np.arange(n) * 1187.5 / fs
    k = pos.astype(np.int64)
    d = np.where(tx[k % tx.size] == 1, 1.0, -1.0) * np.sin(
        2 * np.pi * (pos - k))
    th = 2 * np.pi * 19000.0 * np.arange(n) / fs
    t = np.arange(n) / fs
    left, right = np.sin(2 * np.pi * 800.0 * t), np.sin(2 * np.pi * 1300.0 * t)
    x = (0.4 * (left + right) / 2 + 0.09 * np.cos(th)
         + 0.4 * (left - right) / 2 * np.cos(2 * th)
         + rds_amp * d * np.cos(3 * th))
    return x.astype(np.float32)


def fm_s16(mpx: np.ndarray, up: int, sps: float, device: str, seed: int):
    """The MPX upsampled by `up` (staircase) and FM-modulated at 75 kHz
    deviation on the centre of the band, plus noise: s16 interleaved IQ
    on ``device``."""
    import torch

    m = torch.from_numpy(mpx).to(device, torch.float64).repeat_interleave(up)
    ph = 2 * math.pi * 75000.0 * torch.cumsum(m, 0) / sps
    gen = torch.Generator(device=device).manual_seed(seed)
    iq = 0.5 * torch.stack([torch.cos(ph), torch.sin(ph)], -1)
    iq = iq + 0.005 * torch.randn(iq.shape, dtype=torch.float64,
                                  device=device, generator=gen)
    return torch.round(iq * 32000).to(torch.int16).reshape(-1)


class Stations:
    """Four WBFM stations (75 kHz deviation) across the wideband
    profile's 20 MHz, each carrying the stereo MPX of
    tests/test_stereo.py (19 kHz pilot, 800 Hz left only, 1300 Hz right
    only), plus noise; the FM phase is the MPX's exact integral."""

    OFFSETS = (-0.315, -0.105, 0.135, 0.355)   # of sps: -6.3 .. 7.1 MHz

    def __init__(self, cfg):
        n, self.fs = cfg.fft_size, cfg.sps
        df = self.fs / n
        self.bins = [int(round(f * self.fs / df)) for f in self.OFFSETS]
        self.freqs = [b * df for b in self.bins]
        self.m = [b + n // 2 - 1 for b in self.bins]   # display bins
        self.off96 = 96000 * cfg.fft_result_size // cfg.sps

    @staticmethod
    def mpx_integral(t):
        """Integral from 0 to t of 0.225 (L + R) + 0.09 cos(th) + 0.225
        (L - R) cos(2 th), L = sin(wl t), R = sin(wr t), th = wp t."""
        import torch

        wl, wr, wp = (2 * math.pi * f for f in (800.0, 1300.0, 19000.0))

        def s(w):      # integral of sin(w t)
            return (1 - torch.cos(w * t)) / w

        return (0.225 * (s(wl) + s(wr)) + 0.09 * torch.sin(wp * t) / wp
                + 0.1125 * (s(wl + 2 * wp) + s(wl - 2 * wp)
                            - s(wr + 2 * wp) - s(wr - 2 * wp)))

    def iq(self, start: int, count: int, gen):
        """Samples [start, start+count) as u8 interleaved IQ on the card."""
        import torch

        t = torch.arange(start, start + count, dtype=torch.float64,
                         device="cuda") / self.fs
        fmph = 2 * math.pi * 75000.0 * self.mpx_integral(t)
        x = torch.zeros((count, 2), dtype=torch.float64, device="cuda")
        for k, f in enumerate(self.freqs):
            ph = torch.remainder(t * f, 1.0) * 2 * math.pi + fmph + k
            x += 0.2 * torch.stack([torch.cos(ph), torch.sin(ph)], -1)
        x += torch.randn((count, 2), dtype=torch.float64, device="cuda",
                         generator=gen) * 0.01
        return torch.clamp(torch.round(x * 128 + 128), 0, 255).to(
            torch.uint8).reshape(-1)


def tone_amp(x: np.ndarray, f: float, rate: float) -> float:
    n = x.size
    return float(np.abs(np.sum(x * np.exp(-2j * np.pi * f * np.arange(n)
                                          / rate))) * 2 / n)


def split_device_us(fn, calls: int = 2) -> dict:
    """torch.profiler's device microseconds per fn() call, summed by the
    stages' kernels: FFTs (cuFFT), FIRs (cuDNN conv1d), K-PILOT,
    K-DEEMPH, K-AGC, K-PLL, K-WF, K-NR, K-ANR, K-NB and everything
    else."""
    groups = {"fft": 0.0, "fir_conv1d": 0.0, "K-PILOT": 0.0,
              "K-DEEMPH": 0.0, "K-AGC": 0.0, "K-PLL": 0.0, "K-WF": 0.0,
              "K-NR": 0.0, "K-ANR": 0.0, "K-NB": 0.0, "other": 0.0}
    by_kernel = device_us_by_kernel(fn, calls)
    for name, us in by_kernel.items():
        low = name.lower()
        if "fft" in low:
            g = "fft"
        elif "pilot" in low:
            g = "K-PILOT"
        elif "deemph" in low:
            g = "K-DEEMPH"
        elif low.startswith("agc"):
            g = "K-AGC"
        elif low.startswith("pll"):
            g = "K-PLL"
        elif "pyramid" in low:
            g = "K-WF"
        elif low.startswith("nr_"):
            g = "K-NR"
        elif low.startswith("anr_"):
            g = "K-ANR"
        elif low.startswith("nb_"):
            g = "K-NB"
        elif any(k in low for k in ("conv", "cudnn", "xmma", "gemm")):
            g = "fir_conv1d"
        else:
            g = "other"
        groups[g] += us
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"by_stage_us": groups, "total_us": sum(groups.values()),
            "top_kernels_us": dict(top)}


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


def check_wf(cfg, raw):
    """K-WF against its plain version (max |diff| 0) on the cadence-due
    rows of the spectra of one step of ``raw`` at ``cfg``: the measured
    fields of its kernel line, its call and its plain version's."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import waterfall
    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, spectra_from_raw, waterfall_due_positions,
    )

    pipe = HopPipeline(cfg, device="cuda")
    spec = spectra_from_raw(cfg, pipe.window, raw, cfg.hop_batch)
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
        raise AssertionError(f"K-WF vs plain at [{cfg.hop_batch}, "
                             f"{spec.shape[1]}]: max {wf_err} steps on "
                             f"{wf_frac:.2e} of bins")
    d, r = rows.shape[0], cfg.fft_result_size
    p = got.shape[1]
    b_ms, b_by = bound_ms(8 * d * r + d * p, d * r * 3 + d * p * 6)

    def run():
        waterfall.waterfall_rows(spec, rows, **kw)

    def plain():
        waterfall.waterfall_rows_plain(spec, rows, **kw)

    return dict(
        shape=f"[{cfg.hop_batch}, {spec.shape[1]}] c64 spectra, {d} due "
              f"rows, {cfg.downsample_levels} levels, base_idx "
              f"{cfg.base_idx} -> [{d}, {p}] int8",
        max_abs_err=wf_err, frac_differing=wf_frac,
        ms=time_ms(run, 20), kernel_ms=kernel_ms(run),
        device_ms=device_ms(run), bound_ms=b_ms, bound_by=b_by), run, plain


def check_pll(c: int, n: int, gen, calls: int = 3):
    """K-PLL against its plain version on [c, n] AM streams (carriers a
    few Hz off, 0.5 modulated baseband plus noise) over ``calls``
    consecutive calls that carry the phase and frequency: the measured
    fields of its kernel line, and its first call's, its plain
    version's and its chain probe's calls."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import pll

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
        if not (torch.allclose(got[1], want[1], atol=PLL_PHASE_ATOL)
                and torch.allclose(got[2], want[2], atol=PLL_FREQ_ATOL)):
            raise AssertionError(f"K-PLL vs plain at [{c}, {n}]: phase/freq "
                                 f"carries differ after call {k + 1}")
        kcar, pcar = got[1:], want[1:]
    if not pll_err <= PLL_ATOL * scale:
        raise AssertionError(f"K-PLL vs plain at [{c}, {n}]: max |diff| "
                             f"{pll_err} > {PLL_ATOL} * {scale}")
    del carrier_all, baseband_all, car, msg, noise, t
    b_ms, b_by = bound_ms(c * n * (8 + 8 + 4) + 4 * c * 4,
                          c * n * PLL_OPS_PER_SAMPLE)

    def run():
        pll.am_sync_detect(carrier, baseband, phase0, freq0)

    def plain():
        pll.am_sync_detect_plain(carrier, baseband, phase0, freq0)

    def chain():
        pll.chain_probe(carrier, phase0, freq0)

    return dict(
        shape=f"[{c}, {n}] c64 carrier + baseband -> [{c}, {n}] f32",
        max_abs_err=pll_err, chained_calls=calls,
        ms=time_ms(run, 10), kernel_ms=kernel_ms(run),
        device_ms=device_ms(run), bound_ms=b_ms, bound_by=b_by), \
        run, plain, chain


def check_agc(c: int, b: int, half: int, audio_sps: int, gen):
    """K-AGC against its plain version (int16 within 1, the carried
    state equal) on [c, b * half] streams with a mix of warm-up states:
    the measured fields of its kernel line, and its call's, its plain
    version's and its chain probe's calls."""
    import torch

    from phantomsdr_tpu_torch.ops.agc import AGCState, make_agc_params
    from phantomsdr_tpu_torch.ops.cuda import agc

    n = b * half
    params = make_agc_params(audio_sps)
    w = params.window
    x = torch.randn(c, n, device="cuda", generator=gen) * 0.05
    x[:, ::97] *= 8.0
    x[c // 2:] *= 10.0
    state = AGCState(
        tail=torch.randn(c, w - 1, device="cuda", generator=gen) * 0.05,
        gain=torch.rand(c, device="cuda", generator=gen) * 5.0,
        seen=torch.tensor([0, w // 2, w - 1, w] * (c // 4),
                          dtype=torch.int32, device="cuda"))
    out_k = torch.empty(b, c, half, dtype=torch.int16, device="cuda")
    out_p = torch.empty_like(out_k)
    st_k = agc.agc_int16(state, x, params, out_k)
    st_p = agc.agc_int16_plain(state, x, params, out_p)
    torch.cuda.synchronize()
    agc_err = int((out_k.to(torch.int32) - out_p.to(torch.int32)).abs().max())
    if agc_err > 1:
        raise AssertionError(f"K-AGC vs plain at [{c}, {n}]: int16 max "
                             f"|diff| {agc_err}")
    if not (torch.equal(st_k.tail, st_p.tail)
            and torch.equal(st_k.seen, st_p.seen)
            and torch.allclose(st_k.gain, st_p.gain, rtol=1e-5)):
        raise AssertionError(f"K-AGC vs plain at [{c}, {n}]: carried state "
                             f"differs")
    m = w - 1 + n
    b_ms, b_by = bound_ms(c * (4 * n + 4 * (w - 1) + 8) + c * (2 * n
                          + 4 * (w - 1) + 8),
                          c * (m * math.log2(w) + n * AGC_OPS_PER_SAMPLE))

    def run():
        agc.agc_int16(state, x, params, out_k)

    def plain():
        agc.agc_int16_plain(state, x, params, out_p)

    def chain():
        agc.chain_probe(x, state.gain, params)

    return dict(
        shape=f"[{c}, {n}] f32, window {w} -> [{b}, {c}, {half}] int16",
        max_abs_err=agc_err, ms=time_ms(run, 20), kernel_ms=kernel_ms(run),
        device_ms=device_ms(run), bound_ms=b_ms, bound_by=b_by), \
        run, plain, chain


def phase_kernels(cfg, raw0):
    """Each kernel vs its plain version at the main path's shapes; K-WF,
    K-PLL and K-AGC also at the real-input shapes of REAL_CFG (their
    lines' ``real`` objects)."""
    import torch

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.ops.cuda import agc, pll, waterfall

    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    # ---- K-WF on the main path's spectra and due rows
    wf, run, plain = check_wf(cfg, raw0)
    rows_out.append(dict(
        name="K-WF waterfall pyramid", route="cuda", kernel=waterfall.KERNEL,
        source="phantomsdr_tpu_torch/csrc/waterfall.cu",
        replaces="phantomsdr_tpu/ops/pallas/waterfall.py:96",
        tolerance="equal (the plain version's arithmetic and pair order)",
        **wf, **profiled(run), plain_ms=time_ms(plain, 5), library_ms=None))
    del run, plain

    # ---- K-PLL on [C, B*half] AM streams, three chained calls
    c, half = cfg.max_channels, cfg.audio_fft_size // 2
    n = cfg.hop_batch * half
    pl, run, plain, chain = check_pll(c, n, gen)
    rows_out.append(dict(
        name="K-PLL AM carrier PLL", route="cuda", kernel=pll.KERNEL,
        source="phantomsdr_tpu_torch/csrc/pll.cu",
        replaces="phantomsdr_tpu/ops/channelizer.py:155 (lax.scan via "
                 "ops/unroll.py:60)",
        tolerance=f"|diff| <= {PLL_ATOL} * max|baseband|, carries within "
                  f"{PLL_PHASE_ATOL} (phase) and {PLL_FREQ_ATOL} (freq)",
        **pl, plain_ms=time_ms(plain, 1, warmup=0),
        chain_floor_ms=device_ms(chain), **profiled(run), library_ms=None,
        chain_note=f"{n} dependent loop steps per channel"))

    # ---- K-AGC on [C, B*half] streams with a mix of warm-up states
    ag, run, plain, chain = check_agc(c, cfg.hop_batch, half,
                                      cfg.audio_sps, gen)
    rows_out.append(dict(
        name="K-AGC look-ahead AGC + int16", route="cuda", kernel=agc.KERNEL,
        source="phantomsdr_tpu_torch/csrc/agc.cu",
        replaces="phantomsdr_tpu/ops/agc.py:193 (lax.scan) + "
                 "agc.py:108 (_sliding_max_abs)",
        tolerance="int16 |diff| <= 1", **ag,
        plain_ms=time_ms(plain, 1, warmup=0),
        chain_floor_ms=device_ms(chain), **profiled(run), library_ms=None,
        chain_note=f"{n} dependent gain steps per channel"))
    del run, plain, chain
    agc_int16_row = rows_out[-1]

    # ---- the same three at the real-input shapes: bench.py's real
    # profile (its own generator: the draws above stay as they were)
    rcfg = config_from_dict(REAL_CFG)
    rgen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    raw = RealTones(rcfg).real(0, (rcfg.hop_batch + 1) * rcfg.hop_size,
                               rgen)
    rows_out[0]["real"] = check_wf(rcfg, raw)[0]
    del raw
    rhalf = rcfg.audio_fft_size // 2
    rows_out[1]["real"] = check_pll(rcfg.max_channels,
                                    rcfg.hop_batch * rhalf, rgen)[0]
    rows_out[2]["real"] = check_agc(rcfg.max_channels, rcfg.hop_batch,
                                    rhalf, rcfg.audio_sps, rgen)[0]

    rows_out += wbfm_kernel_rows(gen)
    # the bench-shape int16 kernel beside the float mode's row (its last)
    rows_out[-1]["int16_bench_kernel_ms"] = agc_int16_row["kernel_ms"]
    rows_out += nr_kernel_rows(cfg, gen)
    for row in rows_out:
        row["bound_us"] = row["bound_ms"] * 1e3
        emit({"phase": "kernel", **printable(row)})
    return rows_out


def printable(row: dict) -> dict:
    """A kernel row without its CudaKernel objects."""
    return {k: v for k, v in row.items() if k not in ("kernel", "kernels")}


def wbfm_kernel_rows(gen):
    """K-PILOT, K-DEEMPH and K-AGC's float mode against their plain
    versions at the shapes the wideband WBFM step gives them: 128
    channels of T = 8 * 5,034 = 40,272 samples at 192 kHz (stereo: 256
    de-emphasis rows; a 38,400-sample AGC window)."""
    import torch

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.ops.agc import (
        AGCState, agc_process, make_agc_params,
    )
    from phantomsdr_tpu_torch.ops.cuda import agc, deemph, pilot
    from phantomsdr_tpu_torch.ops.deemph import deemph_alpha
    from phantomsdr_tpu_torch.ops.polyphase import fir
    from phantomsdr_tpu_torch.ops.stereo import make_stereo_params

    cfg = config_from_dict(WIDEBAND_CFG)
    c, fs = cfg.max_channels, cfg.audio_sps
    n = cfg.hop_batch * cfg.audio_fft_size // 2
    rows = []

    # ---- K-PILOT: the pilot of MPX-like rows, two calls that carry the
    # phase and frequency, the stereo mix on FM rows (every third row
    # not FM)
    t = torch.arange(2 * n, device="cuda", dtype=torch.float32) / fs
    th = 2 * math.pi * 19000.0 * t + torch.rand(c, 1, device="cuda",
                                                generator=gen) * 6
    x = (0.3 * torch.sin(2 * math.pi * 800 * t)
         + 0.09 * torch.cos(th)
         + 0.2 * torch.sin(2 * math.pi * 1300 * t) * torch.cos(2 * th)
         + 0.02 * torch.randn(c, 2 * n, device="cuda", generator=gen))
    x = x * (1 + torch.arange(c, device="cuda")[:, None] % 3)
    sp = make_stereo_params(fs)
    y = fir(torch.cat([torch.zeros(c, sp.taps.shape[0] - 1, device="cuda"),
                       x], 1), sp.taps)
    fm = torch.arange(c, device="cuda") % 3 != 1
    segs = [(y[:, k * n:(k + 1) * n].contiguous(),
             x[:, k * n:(k + 1) * n].contiguous()) for k in range(2)]
    scale = float(x.abs().max())
    del t, th, x, y
    zero = torch.zeros(c, device="cuda")
    kcar = pcar = (zero, zero)
    pilot_err = 0.0
    for k, (ys, xs) in enumerate(segs):
        got = pilot.pilot_mix(*kcar, sp.f_nom, ys, xs=xs, fm_mask=fm)
        want = pilot.pilot_mix_plain(*pcar, sp.f_nom, ys, xs=xs, fm_mask=fm)
        torch.cuda.synchronize()
        pilot_err = max(pilot_err, float((got[2] - want[2]).abs().max()),
                        float((got[3] - want[3]).abs().max()))
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(f"K-PILOT vs plain: phase/freq carries "
                                 f"differ after call {k + 1}")
        kcar, pcar = got[:2], want[:2]
    if not pilot_err <= PLL_ATOL * scale:
        raise AssertionError(f"K-PILOT vs plain: max |diff| {pilot_err} > "
                             f"{PLL_ATOL} * {scale}")
    ys, xs = segs[1]
    del segs, got, want
    # the kernel's sine against libdevice sinf on every float32 of the
    # wrapped phase's range [-0, 2*pi]
    sin_checked, sin_mismatches = pilot.sin_check()
    want_checked = int(np.float32(2 * np.pi).view(np.uint32)) + 2
    if sin_mismatches or sin_checked != want_checked:
        raise AssertionError(f"K-PILOT sine vs sinf: {sin_mismatches} of "
                             f"{sin_checked} differ (want 0 of "
                             f"{want_checked})")
    b_ms, b_by = bound_ms(4 * c * n * 4 + 4 * c * 4 + c,
                          c * n * PILOT_OPS_PER_SAMPLE)

    def run_pilot():
        pilot.pilot_mix(zero, zero, sp.f_nom, ys, xs=xs, fm_mask=fm)

    rows.append(dict(
        name="K-PILOT pilot PLL + stereo demix", route="cuda",
        source="phantomsdr_tpu_torch/csrc/pilot.cu",
        replaces="phantomsdr_tpu/ops/stereo.py:160 (pilot_track, lax.scan "
                 "via ops/unroll.py:60) + stereo.py:196 (stereo_demix)",
        kernel=pilot.KERNEL,
        shape=f"[{c}, {n}] f32 pilot + delayed MPX -> [{2 * c}, {n}] f32 "
              f"L/R rows",
        max_abs_err=pilot_err, chained_calls=2,
        tolerance=f"|diff| <= {PLL_ATOL} * max|x| on ph and L/R, carries "
                  f"equal",
        ms=time_ms(run_pilot, 10),
        kernel_ms=kernel_ms(run_pilot),
        device_ms=device_ms(run_pilot),
        plain_ms=time_ms(lambda: pilot.pilot_mix_plain(
            zero, zero, sp.f_nom, ys, xs=xs, fm_mask=fm), 1, warmup=0),
        chain_floor_ms=device_ms(lambda: pilot.chain_probe(ys, zero, zero,
                                                           sp.f_nom)),
        # the old floor: the earlier design's loop body (libdevice sinf
        # at the step's start, the wrap a branch) in the same probe
        chain_floor_ms_old=device_ms(lambda: pilot.chain_probe(
            ys, zero, zero, sp.f_nom, pilot.BODY_EARLIER)),
        sin_checked=sin_checked, sin_mismatches=sin_mismatches,
        **profiled(run_pilot),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        chain_note=f"{n} dependent loop steps per channel"))
    del ys, xs

    # ---- K-DEEMPH on the 2C stereo stream rows, with the carry and a
    # mask of FM rows (inactive rows pass through)
    a = deemph_alpha(fs, cfg.deemphasis)
    xd = torch.randn(2 * c, n, device="cuda", generator=gen) * 0.2
    y0 = torch.randn(2 * c, device="cuda", generator=gen) * 0.2
    mask = (torch.arange(2 * c, device="cuda") // 2) % 16 != 5
    got_c, got = deemph.deemph_process(y0, a, xd, mask)
    want_c, want = deemph.deemph_process_plain(y0, a, xd, mask)
    torch.cuda.synchronize()
    de_scale = float(xd.abs().max())
    de_err = max(float((got - want).abs().max()),
                 float((got_c - want_c).abs().max()))
    if not (de_err <= DEEMPH_ATOL * de_scale
            and torch.equal(got[~mask], xd[~mask])
            and torch.equal(got_c[~mask], y0[~mask])):
        raise AssertionError(f"K-DEEMPH vs plain: max |diff| {de_err} > "
                             f"{DEEMPH_ATOL} * {de_scale}, or a masked "
                             f"row changed")
    del got, want
    b_ms, b_by = bound_ms(2 * 2 * c * n * 4 + 2 * c * 9,
                          2 * c * n * DEEMPH_OPS_PER_SAMPLE)

    def run_deemph():
        deemph.deemph_process(y0, a, xd, mask)

    rows.append(dict(
        name="K-DEEMPH de-emphasis IIR", route="cuda",
        source="phantomsdr_tpu_torch/csrc/deemph.cu",
        replaces="phantomsdr_tpu/ops/deemph.py:45 (deemph_process, "
                 "lax.associative_scan)",
        kernel=deemph.KERNEL,
        shape=f"[{2 * c}, {n}] f32 -> [{2 * c}, {n}] f32, alpha {a:.6f}",
        max_abs_err=de_err,
        tolerance=f"|diff| <= {DEEMPH_ATOL} * max|x|, masked rows equal",
        ms=time_ms(run_deemph, 20),
        kernel_ms=kernel_ms(run_deemph),
        device_ms=device_ms(run_deemph),
        plain_ms=time_ms(lambda: deemph.deemph_process_plain(y0, a, xd,
                                                             mask),
                         1, warmup=0),
        chain_floor_ms=None,
        **profiled(run_deemph),
        # its input evicted from L2 before each call (the 41 MB input
        # fits in the 50 MB L2, where the warm calls above find it)
        kernel_ms_cold_l2=kernel_ms(run_deemph, cold=True),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        chain_note="no serial loop: chunks of 32 samples a thread, "
                   "combined by a block scan"))
    del xd

    # ---- K-AGC float mode: a 192 kHz window (38,400 samples) over the
    # step's 40,272, mixed warm-up states
    params = make_agc_params(fs)
    w = params.window
    xa = torch.randn(c, n, device="cuda", generator=gen) * 0.05
    xa[:, ::97] *= 8.0
    xa[c // 2:] *= 10.0
    state = AGCState(
        tail=torch.randn(c, w - 1, device="cuda", generator=gen) * 0.05,
        gain=torch.rand(c, device="cuda", generator=gen) * 5.0,
        seen=torch.tensor([0, w // 2, w - 1, w] * (c // 4),
                          dtype=torch.int32, device="cuda"))
    st_k, y_k = agc.agc_float(state, xa, params)
    st_p, y_p = agc_process(state, xa, params)
    torch.cuda.synchronize()
    agc_err = float((y_k - y_p).abs().max())
    if not (torch.allclose(y_k, y_p, rtol=1e-6, atol=1e-7)
            and torch.equal(st_k.tail, st_p.tail)
            and torch.equal(st_k.seen, st_p.seen)
            and torch.allclose(st_k.gain, st_p.gain, rtol=1e-6, atol=0)):
        raise AssertionError(f"K-AGC float vs plain: max |diff| {agc_err}, "
                             f"or the carried state differs")
    del y_k, y_p
    m = w - 1 + n
    b_ms, b_by = bound_ms(c * (4 * n + 4 * (w - 1) + 8) + c * (4 * n
                          + 4 * (w - 1) + 8),
                          c * (m * math.log2(w) + n * AGC_OPS_PER_SAMPLE))
    rows.append(dict(
        name="K-AGC look-ahead AGC, float output", route="cuda",
        source="phantomsdr_tpu_torch/csrc/agc.cu",
        replaces="phantomsdr_tpu/ops/agc.py:193 (lax.scan) + "
                 "agc.py:108 (_sliding_max_abs), WBFM path",
        kernel=agc.FLOAT_KERNEL,
        shape=f"[{c}, {n}] f32, window {w} -> [{c}, {n}] f32",
        max_abs_err=agc_err, tolerance="rtol 1e-6, atol 1e-7",
        ms=time_ms(lambda: agc.agc_float(state, xa, params), 20),
        kernel_ms=kernel_ms(lambda: agc.agc_float(state, xa, params)),
        device_ms=device_ms(lambda: agc.agc_float(state, xa, params)),
        plain_ms=time_ms(lambda: agc_process(state, xa, params), 1,
                         warmup=0),
        chain_floor_ms=device_ms(lambda: agc.chain_probe(xa, state.gain,
                                                         params)),
        **profiled(
            lambda: agc.agc_float(state, xa, params)),
        # the int16 mode at the same shapes, for comparison
        int16_device_ms=device_ms(lambda: agc.agc_int16(
            state, xa, params, torch.empty(cfg.hop_batch, c, n // cfg.hop_batch,
                                           dtype=torch.int16,
                                           device="cuda"))),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        chain_note=f"{n} dependent gain steps per channel"))
    return rows


def click_rows(c: int, t: int, gen, clicks: int = 8):
    """[C, t] int16-domain rows on the card: a 500 Hz tone (three
    levels) in noise, and clicks 3 samples wide at random places."""
    import torch

    tt = torch.arange(t, device="cuda") / 12000.0
    x = (3000 * torch.sin(2 * math.pi * 500 * tt)[None]
         * (1 + torch.arange(c, device="cuda")[:, None] % 3)
         + 250 * torch.randn(c, t, device="cuda", generator=gen))
    rows = torch.arange(c, device="cuda")
    for _ in range(clicks):
        at = torch.randint(0, t - 4, (c,), device="cuda", generator=gen)
        for k in range(3):
            x[rows, at + k] += 20000
    return x


def nr_kernel_rows(cfg, gen):
    """K-NR, K-ANR and K-NB against their plain versions at the shapes
    the bench config with [input] nr gives them: 128 channels of 36
    frames of 180 samples (6480 a step) in the int16 domain; each over
    two calls that carry the state.  These kernels take microseconds,
    less than their wrappers' host work, so their chain floors are
    timed like kernel_ms (the host's issue hidden behind a spin)."""
    import torch

    from phantomsdr_tpu_torch.ops import nb as nbm
    from phantomsdr_tpu_torch.ops.anr import (
        block_size, init_anr_state, make_anr_params,
    )
    from phantomsdr_tpu_torch.ops.cuda import anr, nb, nr
    from phantomsdr_tpu_torch.ops.nr import (
        frame_spectra, init_nr_state, make_nr_params,
    )

    c, n, f = cfg.max_channels, cfg.hop_batch, cfg.audio_fft_size // 2
    t = n * f
    rows = []

    # ---- K-NR on the frame powers of tone-and-noise streams
    p = make_nr_params(f)
    tt = torch.arange(2 * t, device="cuda") / 12000.0
    gate = (torch.arange(c, device="cuda")[:, None] % 2) * (tt > 0.3)
    x = (6000 * torch.sin(2 * math.pi * 700 * tt)[None] * gate
         + 1500 * torch.randn(c, 2 * t, device="cuda", generator=gen))
    win = torch.from_numpy(p.window).to("cuda")
    st = init_nr_state(c, f, "cuda")
    carries = (st.stage, st.nest, st.xt, st.pslp, st.hk_old)

    def nr_vs_plain(streams):
        """Two chained calls of K-NR and of its plain version on the
        frame powers of ``streams`` from a fresh state: (max |diff| of
        the gains, max relative diff of gains and carries, the plain
        version's carries, the last powers)."""
        x_pows, last = [], st.last_in
        for k in range(2):
            cur, _, xp = frame_spectra(last, win, streams[:, k * t:(k + 1) * t], n)
            x_pows.append(xp)
            last = cur[-1]
        kc = pc = carries
        err, rel = 0.0, 0.0
        for k, xp in enumerate(x_pows):
            kc, kg, kr = nr.gain_frames(kc, p.alpha, p.xih1r, p.pfac, xp)
            pc, pg, pr = nr.gain_frames_plain(pc, p.alpha, p.xih1r, p.pfac, xp)
            torch.cuda.synchronize()
            err = max(err, float((kg - pg).abs().max()))
            rel = max([rel] + [float(((a - b).abs() / b.abs().clamp(
                min=1e-30)).max()) for a, b in zip((kg,) + kc[1:],
                                                  (pg,) + pc[1:])])
            if not (torch.equal(kr, pr) and torch.equal(kc[0], pc[0])):
                raise AssertionError(f"K-NR vs plain: running flags or stage "
                                     f"differ after call {k + 1}")
        if rel > NR_RTOL:
            raise AssertionError(f"K-NR vs plain: max relative diff {rel} > "
                                 f"{NR_RTOL}")
        return err, rel, pc, x_pows[1]

    # the kernel's written-out division, reciprocal and square root
    # against __fdiv_rn and __fsqrt_rn over 2^32 inputs each
    ieee = nr.fast_check()
    if ieee["div"][2] or ieee["sqrt_rcp"][2]:
        raise AssertionError(f"K-NR: a written-out division or square root "
                             f"differs from the IEEE one: {ieee}")
    # every third channel silent from the start (an idle slot: zero
    # powers, xt_safe 1e-30), beside tone-and-noise channels
    quiet = x.clone()
    quiet[::3] = 0.0
    _, silent_rel, _, _ = nr_vs_plain(quiet)
    nr_err, nr_rel, pc, xp = nr_vs_plain(x)

    def run_nr():
        nr.gain_frames(pc, p.alpha, p.xih1r, p.pfac, xp)

    b_ms, b_by = bound_ms(2 * n * c * f * 4 + n * c + 2 * (4 * c * f * 4
                                                           + 4 * c),
                          n * c * f * NR_OPS_PER_BIN)
    # the chain floor's cycles a frame: its probe over 2n frames less its
    # probe over n, over n frames, at the SM clock of this run
    floor_ms = kernel_ms(lambda: nr.chain_probe(pc, p.alpha, p.xih1r, p.pfac, xp))
    xp2 = torch.cat([xp, xp]).contiguous()
    floor2_ms = kernel_ms(lambda: nr.chain_probe(pc, p.alpha, p.xih1r, p.pfac, xp2))
    clock = sm_cycles_per_ms()
    rows.append(dict(
        name="K-NR spectral NR frame recursion", route="cuda",
        source="phantomsdr_tpu_torch/csrc/nr.cu",
        replaces="phantomsdr_tpu/ops/nr.py:249 (lax.scan over _gain_frame, "
                 "nr.py:120-175)",
        kernel=nr.KERNEL,
        shape=f"x_pow [{n}, {c}, {f}] f32 -> g_run [{n}, {c}, {f}] f32, "
              f"running [{n}, {c}] bool, 5 carries [{c}, {f}]",
        max_abs_err=nr_err, max_rel_err=nr_rel, chained_calls=2,
        silent_rows_max_rel_err=silent_rel,
        # (values checked, accepted by the written-out path, differing)
        ieee_check=ieee,
        tolerance=f"g_run and carries within rtol {NR_RTOL}, running and "
                  f"stage equal (also with every third channel silent "
                  f"from the start)",
        ms=time_ms(run_nr, 20), kernel_ms=kernel_ms(run_nr),
        device_ms=device_ms(run_nr),
        plain_ms=time_ms(lambda: nr.gain_frames_plain(
            pc, p.alpha, p.xih1r, p.pfac, xp), 3),
        chain_floor_ms=floor_ms, chain_floor_2n_frames_ms=floor2_ms,
        sm_cycles_per_ms=clock,
        chain_floor_cycles_per_frame=(floor2_ms - floor_ms) * clock / n,
        **profiled(run_nr),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        chain_note=f"{n} dependent frames per (channel, bin)"))
    del x, quiet, tt, gate, xp2

    # ---- K-ANR, LMS NR at the config's defaults: 25 blocks of 256 and
    # one of 80 a step
    pa = make_anr_params(notch=False)
    bsz = block_size(pa, t)
    tt = torch.arange(2 * t, device="cuda") / 12000.0
    xa = (3000 * torch.sin(2 * math.pi * 800 * tt
                           + torch.rand(c, 1, device="cuda", generator=gen))
          + 1000 * torch.randn(c, 2 * t, device="cuda", generator=gen))
    sa = init_anr_state(c, pa, "cuda")
    kc = pc = tuple(sa)
    scale = float(xa.abs().max())
    anr_err = 0.0
    lms = (pa.taps, pa.delay, pa.two_mu, pa.gamma, pa.notch, bsz)
    for k in range(2):
        xs = xa[:, k * t:(k + 1) * t].contiguous()
        kc, ko = anr.lms_blocks(*kc, xs, *lms)
        pc, po = anr.lms_blocks_plain(*pc, xs, *lms)
        torch.cuda.synchronize()
        anr_err = max([anr_err, float((ko - po).abs().max())]
                      + [float((a - b).abs().max()) for a, b in zip(kc, pc)])
    if anr_err > ANR_ATOL * scale:
        raise AssertionError(f"K-ANR vs plain: max |diff| {anr_err} > "
                             f"{ANR_ATOL} * {scale}")

    def run_anr():
        anr.lms_blocks(*pc, xs, *lms)

    b_ms, b_by = bound_ms(2 * c * t * 4 + 2 * c * (pa.taps * 2 + pa.delay
                                                   + 2) * 4,
                          c * t * 6 * pa.taps)
    rows.append(dict(
        name="K-ANR block LMS NR / auto-notch", route="cuda",
        source="phantomsdr_tpu_torch/csrc/anr.cu",
        replaces="phantomsdr_tpu/ops/anr.py:249 (lax.scan over "
                 "_block_body, anr.py:193-225)",
        kernel=anr.KERNEL,
        shape=f"[{c}, {t}] f32 -> [{c}, {t}] f32, taps {pa.taps}, delay "
              f"{pa.delay}, blocks {t // bsz} x {bsz} + {t % bsz}",
        max_abs_err=anr_err, chained_calls=2,
        tolerance=f"output and carries |diff| <= {ANR_ATOL} * max|x|",
        ms=time_ms(run_anr, 20), kernel_ms=kernel_ms(run_anr),
        device_ms=device_ms(run_anr),
        plain_ms=time_ms(lambda: anr.lms_blocks_plain(*pc, xs, *lms), 3),
        chain_floor_ms=kernel_ms(lambda: anr.chain_probe(*pc, xs, *lms)),
        **profiled(run_anr),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        chain_note=f"{-(-t // bsz)} dependent LMS blocks per channel"))
    del xa, tt

    # ---- K-NB: the blanker's two launches around the FIRs, on rows
    # with clicks; each launch against its plain version on the same
    # inputs (the card's own LPC fit and residual), so that a rounding
    # difference upstream cannot move a detection
    pn = nbm.make_nb_params()
    order, il = pn.taps, pn.impulse_len
    lo = order + (il - 1) // 2
    xn = click_rows(c, 2 * t, gen)
    state = nbm.init_nb_state(c, pn, "cuda")
    scale = float(xn.abs().max())
    nb_err, lpc_err, counts, margins, sel_margins = 0.0, 0.0, [], [], []
    for k in range(2):
        xs = xn[:, k * t:(k + 1) * t].contiguous()
        wb = torch.cat([state.tail, xs], 1).contiguous()
        lpcs, cf, cb = nb.lpc_coeffs(wb, t, order, il)
        want = nb.lpc_coeffs_plain(wb, t, order, il)
        lpc_err = max([lpc_err] + [float((a - b).abs().max())
                                   for a, b in zip((lpcs, cf, cb), want)])
        temp = nbm.fir_fresh(lpcs, nbm.fir_fresh(
            lpcs.flip(1), wb[:, lo:lo + t])).contiguous()
        wbf, kcount, kpos, kthr = nb.repair(wb, temp, lpcs, cf, cb,
                                            pn.thresh, order, il)
        pwbf, pcount, ppos, _ = nb.repair_plain(wb, temp, lpcs, cf, cb,
                                                pn.thresh, order, il)
        torch.cuda.synchronize()
        if not (torch.equal(kcount, pcount) and torch.equal(kpos, ppos)):
            raise AssertionError(f"K-NB vs plain: impulse counts or "
                                 f"positions differ in call {k + 1}")
        nb_err = max(nb_err, float((wbf - pwbf).abs().max()))
        state = state._replace(tail=wbf[:, t:].contiguous())
        counts.append(kcount.tolist())
        ratio = (temp[:, lo:].abs() / kthr[:, None] - 1).abs()
        margins.append(float(ratio.min()))
        sel = torch.gather(ratio, 1, (kpos.long() + order - lo).clamp(min=0))
        valid = torch.arange(20, device="cuda")[None] < kcount[:, None]
        sel_margins.append(float(sel[valid].min()) if valid.any() else None)
    if nb_err > NB_ATOL * scale or lpc_err > NB_LPC_ATOL:
        raise AssertionError(f"K-NB vs plain: repaired buffer max |diff| "
                             f"{nb_err} (bound {NB_ATOL} * {scale}), LPC "
                             f"coefficients {lpc_err} (bound {NB_LPC_ATOL})")

    def run_nb():
        nb.lpc_coeffs(wb, t, order, il)
        nb.repair(wb, temp, lpcs, cf, cb, pn.thresh, order, il)

    def run_nb_plain():
        nb.lpc_coeffs_plain(wb, t, order, il)
        nb.repair_plain(wb, temp, lpcs, cf, cb, pn.thresh, order, il)

    wlen = wb.shape[1]
    b_ms, b_by = bound_ms(c * 4 * (t + (order + 1) + 2 * il * order)
                          + c * 4 * (2 * wlen + t + 2 * il * order + order
                                     + 1) + c * 4 * 22,
                          c * (2 * (order + 1) * t + 4 * t
                               + 4 * 20 * il * order))
    rows.append(dict(
        name="K-NB noise blanker (LPC fit; search + repairs)", route="cuda",
        source="phantomsdr_tpu_torch/csrc/nb.cu",
        replaces="phantomsdr_tpu/ops/nb.py:161 (search lax.scan), :188, "
                 ":195 (coefficient lax.scans), :255 (repair lax.scan), "
                 "nb_process nb.py:104-282",
        kernel=nb.REPAIR_KERNEL, kernels=[nb.LPC_KERNEL, nb.REPAIR_KERNEL],
        shape=f"wb [{c}, {wlen}] f32, order {order}, il {il} -> repaired "
              f"wb [{c}, {wlen}], <= 20 impulses a channel",
        max_abs_err=nb_err, lpc_max_abs_err=lpc_err, chained_calls=2,
        tolerance=f"counts and positions equal, repaired buffer |diff| <= "
                  f"{NB_ATOL} * max|x| (launch 2 on the inputs launch 1 "
                  f"and the FIRs gave it); LPC coefficients |diff| <= "
                  f"{NB_LPC_ATOL}",
        impulses_per_channel=counts,
        # min over the searched positions of | |temp| / thr - 1 |, and
        # over the detected ones: how close a detection came to flipping
        threshold_margin_min=margins,
        threshold_margin_min_detected=sel_margins,
        ms=time_ms(run_nb, 20), kernel_ms=kernel_ms(run_nb),
        device_ms=device_ms(run_nb),
        nb_process_device_ms=device_ms(lambda: nbm.nb_process(state, pn,
                                                              xs)),
        plain_ms=time_ms(run_nb_plain, 3),
        chain_floor_ms=kernel_ms(lambda: nb.repair_chain_probe(
            wb, temp, lpcs, cf, cb, order, il)),
        **profiled(run_nb),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        chain_note="Levinson (order^2/2 steps), 2 x il recursion steps and "
                   "up to 20 dependent repair slots per channel"))
    return rows


# per-sample operation counts used for the operations bound (float32
# operations, transcendental functions counted as ~20 each)
PLL_OPS_PER_SAMPLE = 60
AGC_OPS_PER_SAMPLE = 12
PILOT_OPS_PER_SAMPLE = 55      # sin + cos(2 ph) and 15 float operations
DEEMPH_OPS_PER_SAMPLE = 3
NR_OPS_PER_BIN = 80            # ~30 float operations, expf, 4 div/sqrt
# K-NR vs plain: the same float32 operations in the same order; expf,
# division and sqrt are the accurate ones on both sides
NR_RTOL = 1e-5
# K-ANR vs plain, K-NB vs plain: the bars of tests/test_torch_anr.py and
# tests/test_torch_nb.py (the long sums add in another order)
ANR_ATOL = 1e-4
NB_ATOL = 1e-5
# K-NB's LPC fit vs plain: lags summed in another order go through
# Levinson's divisions (coefficients of order 1)
NB_LPC_ATOL = 1e-3
# K-DEEMPH vs its plain loop: the same recurrence, but each 32-sample
# chunk starts from a carry the block scan composed in another order
# (tests/test_deemph.py's atol 2e-5 at unit scale)
DEEMPH_ATOL = 2e-5
# K-PLL vs its plain version: the same float32 loop update in the same
# operation order; the kernel's phase detector is arg(carrier) - phase
# where the plain version takes atan2 of the mixed product, so err rounds
# differently (a few 1e-7 rad a sample), and the stable 2nd-order loop
# pulls such a phase error back within ~1/sqrt(bandwidth) ~ 32 samples
# instead of accumulating it -- the bound of
# tests/test_torch_channelizer.py (PLL_RTOL); the carries' bounds are
# tests/test_torch_cuda.py's
PLL_ATOL = 1e-5
PLL_PHASE_ATOL = 1e-5
PLL_FREQ_ATOL = 1e-6


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


def phase_small_real():
    """The whole real-input step on the card against the whole step on
    the CPU (plain versions) at SMALL_REAL_CFG: 16 channels cycling the
    modes, am_sync on with the AM listener of row 6 on the envelope,
    views at mixed pyramid levels; 6 'views' then 2 'off' steps.
    phase_small's tolerances: int16 within 4, the waterfall within one
    step on < 0.1% of bins; the channel power within rtol 2e-4."""
    import torch

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.ops.quantize import pyramid_level_offsets
    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, WaterfallViews, channels_from_numpy, to_device,
    )

    cfg = config_from_dict(SMALL_REAL_CFG)
    c, r, lev = cfg.max_channels, cfg.fft_result_size, cfg.downsample_levels
    l = np.linspace(10, r - 200, c).astype(np.int32)
    am_env = np.zeros(c, bool)
    am_env[6] = True
    offs = pyramid_level_offsets(r, lev)
    starts = np.array([offs[0] + 100, offs[1] + 5, offs[3] + 7,
                       offs[lev - 1]], np.int32)
    lengths = np.array([16, 16, 12, cfg.waterfall_size], np.int32)
    modes = ["views"] * 6 + ["off"] * 2
    results = {}
    for dev in ("cuda", "cpu"):
        pipe = HopPipeline(cfg, device=dev)
        table = channels_from_numpy(l, l + 90, l + 45, np.arange(c) % 4,
                                    np.ones(c, bool), am_env=am_env,
                                    device=dev)
        views = WaterfallViews(start=to_device(starts, torch.int32, dev),
                               length=to_device(lengths, torch.int32, dev))
        state = pipe.init_state()
        rng = np.random.default_rng(SEED)
        audio, pwr, wf = [], [], []
        for mode in modes:
            n = (cfg.hop_batch + 1) * pipe.wire_per_hop
            raw = (rng.integers(-3000, 3000, n)
                   + 8000 * np.sin(0.13 * np.arange(n))).astype(np.int16)
            state, out = pipe.step(state, torch.from_numpy(raw).to(dev),
                                   table, views, mode)
            audio.append(out.audio.cpu().numpy().astype(int))
            pwr.append(out.avg_power.cpu().numpy())
            if mode == "views":
                wf.append(out.wf.cpu().numpy().astype(int))
        results[dev] = (np.concatenate(audio), np.concatenate(pwr),
                        np.concatenate(wf))
    (ka, kp, kw), (pa, pp, pw) = results["cuda"], results["cpu"]
    a_err = int(np.abs(ka - pa).max())
    p_err = float(np.max(np.abs(kp - pp) / (np.abs(pp) + 1e-30)))
    wdiff = np.abs(kw - pw)
    peak = int(np.abs(pa).max())
    if (a_err > 4 or not np.allclose(kp, pp, rtol=2e-4, atol=1e-12)
            or wdiff.max() > 1 or (wdiff > 0).mean() >= 1e-3
            or peak <= 100 or not kw.any()):
        raise AssertionError(f"real card vs CPU step: audio {a_err} (peak "
                             f"{peak}), power rtol {p_err}, waterfall "
                             f"{wdiff.max()} on {(wdiff > 0).mean():.2e}")
    emit({"phase": "small_real", "steps": modes,
          "audio_max_abs_int16": a_err, "audio_peak_int16": peak,
          "power_max_rel_err": p_err,
          "waterfall_max_steps": int(wdiff.max()),
          "waterfall_frac_differing": float((wdiff > 0).mean()),
          "waterfall_shape": list(kw.shape)})


def warm_wbfm_state(pipe, state):
    """The state with the AGC past its look-ahead (seen = window, unit
    gain) and the look-ahead tail filled with FM discriminator output of
    the RDS MPX, so that a few steps already give audio and baseband."""
    import torch

    agc = state.audio.agc
    w = pipe.agc_params.window
    fs = pipe.cfg.audio_sps
    fm = 2 * math.pi * 75000.0 / fs * rds_mpx(w - 1, fs)
    tail = torch.from_numpy(fm).to(pipe.device).expand_as(agc.tail)
    return state._replace(audio=state.audio._replace(agc=agc._replace(
        tail=tail.contiguous(), seen=torch.full_like(agc.seen, w),
        gain=torch.ones_like(agc.gain))))


def phase_small_wbfm():
    """The whole WBFM step (stereo + RDS + de-emphasis + Opus
    decimation, 1.536 MSPS, FFT 32768, 192 kHz audio, 4 channels) on the
    card against the whole step on the CPU, 3 steps from a warm AGC."""
    import torch

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.pipeline import HopPipeline, channels_from_numpy

    cfg = config_from_dict({
        "input": {"sps": 1_536_000, "frequency": 98_000_000,
                  "fft_size": 32768, "signal": "iq", "audio_sps": 192000,
                  "waterfall_size": 512, "stereo": True, "rds": True,
                  "deemphasis": 75, "audio_compression": "opus",
                  "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 4, "max_channels": 4}})
    steps = 3
    wph = cfg.hop_size * 2
    blk = cfg.hop_batch * wph
    up = cfg.sps // cfg.audio_sps
    n = (steps * blk + wph) // 2
    raw_all = fm_s16(rds_mpx(n // up + 1, cfg.audio_sps), up, cfg.sps,
                     "cpu", SEED)[:2 * n]
    mid, half = cfg.fft_result_size // 2, cfg.audio_fft_size // 2
    results = {}
    for dev in ("cuda", "cpu"):
        pipe = HopPipeline(cfg, device=dev)
        table = channels_from_numpy(
            [mid - half // 2] * 4, [mid + half // 2] * 4, [mid] * 4,
            [3, 3, 0, 3], [True, True, True, False],
            rds=[True, False, False, True], device=dev)
        state = warm_wbfm_state(pipe, pipe.init_state())
        audio, rds = [], []
        for k in range(steps):
            raw = raw_all[k * blk:k * blk + blk + wph].to(dev)
            state, out = pipe.step(state, raw, table, waterfall="off")
            audio.append(out.audio.cpu().numpy().astype(int))
            rds.append(out.rds.cpu().numpy().astype(int))
        results[dev] = (np.concatenate(audio, 1), np.concatenate(rds, 2))
    a_err = int(np.abs(results["cuda"][0] - results["cpu"][0]).max())
    rdiff = np.abs(results["cuda"][1] - results["cpu"][1])
    peak = int(np.abs(results["cpu"][0][0]).max())
    if (a_err > 4 or rdiff.max() > 1 or peak < 1000
            or not results["cpu"][1][0].any()):
        raise AssertionError(f"WBFM card vs CPU step: audio {a_err} (peak "
                             f"{peak}), RDS int8 {rdiff.max()}")
    emit({"phase": "small_wbfm", "audio_max_abs_int16": a_err,
          "audio_peak_int16": peak,
          "rds_max_steps": int(rdiff.max()),
          "rds_frac_differing": float((rdiff > 0).mean()),
          "audio_shape": list(results["cuda"][0].shape)})


def small_nr_cfg(algo: str):
    """__graft_entry__._small_cfg's sizes (FFT 4096 at 192 kS/s, 12 kHz
    audio, 4 hops a step, 16 channels) with [input] nr = true."""
    from phantomsdr_tpu_torch.config import config_from_dict

    return config_from_dict({
        "input": {"sps": 192000, "frequency": 7000000, "fft_size": 4096,
                  "signal": "iq", "audio_sps": 12000, "waterfall_size": 512,
                  "nr": True, "nr_algo": algo, "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 4, "max_channels": 16}})


NR_ALGOS = ("spectral", "lms", "notch", "nb")


def phase_small_nr():
    """For each nr_algo, the whole step on the card against the whole
    step on the CPU (plain versions), every other row opted in, 8 steps
    (the AGC's 0.2 s window and spectral NR's 20-frame start take the
    first 5)."""
    import torch

    from phantomsdr_tpu_torch.pipeline import HopPipeline, channels_from_numpy

    errs, peaks = {}, {}
    for algo in NR_ALGOS:
        cfg = small_nr_cfg(algo)
        c, r = cfg.max_channels, cfg.fft_result_size
        l = np.linspace(10, r - 300, c).astype(np.int32)
        results = {}
        for dev in ("cuda", "cpu"):
            pipe = HopPipeline(cfg, device=dev)
            table = channels_from_numpy(l, l + 100, l + 50, np.arange(c) % 4,
                                        np.ones(c, bool),
                                        nr=np.arange(c) % 2 == 0, device=dev)
            state = pipe.init_state()
            rng = np.random.default_rng(SEED)
            audio = []
            for _ in range(8):
                n = (cfg.hop_batch + 1) * pipe.wire_per_hop
                raw = (rng.integers(-3000, 3000, n)
                       + 8000 * np.sin(0.13 * np.arange(n))
                       + 20000 * (rng.random(n) < 0.002)).astype(np.int16)
                state, out = pipe.step(state, torch.from_numpy(raw).to(dev),
                                       table, waterfall="off")
                audio.append(out.audio.cpu().numpy().astype(int))
            results[dev] = np.concatenate(audio)
        errs[algo] = int(np.abs(results["cuda"] - results["cpu"]).max())
        peaks[algo] = int(np.abs(results["cpu"]).max())
        if errs[algo] > 4 or peaks[algo] < 1000:
            raise AssertionError(f"small_nr {algo}: card vs CPU int16 "
                                 f"{errs[algo]} (peak {peaks[algo]})")
    emit({"phase": "small_nr", "audio_max_abs_int16": errs,
          "audio_peak_int16": peaks, "steps": 8, "opted_in_rows": "even"})


class NrScene:
    """Four listeners' audio, each for one noise processor, at the bench
    config's exact bins (display bin m is (m - N/2 + 1) * fs/N Hz), with
    in-band noise: complex Gaussian held for ``hold`` samples (a power of
    two near fs / 34 kHz: 1024 at 35 MSPS), shifted into the channel.

    - channel 0, USB, spectral NR: a 1 kHz tone, off for 1.2 s, then 1 s
      on / 1 s off (a steady tone is adapted into the noise floor by
      design),
    - channel 4, USB, LMS NR: a steady 1 kHz tone in noise,
    - channel 8, USB, auto-notch: a steady 800 Hz tone in weak noise,
    - channel 12, AM, noise blanker: a carrier modulated 50% by 600 Hz,
      and clicks on its envelope 5 a second, each 8 audio samples wide
      and 5 times the tone's height (tools/verify's capture notes: the
      LPC whitener nearly cancels 1-2-sample pulses; clicks that
      dominated the frame's residual would raise its threshold over
      them).
    The USB audio of a channel at m is the IQ content above freq(m); the
    AM audio is the carrier's envelope.
    """

    CHANNELS = (0, 4, 8, 12)
    ALGOS = ("spectral", "lms", "notch", "nb")      # one per channel

    def __init__(self, cfg):
        n, fs = cfg.fft_size, cfg.sps
        self.fs, self.n = fs, n
        self.df = fs / n
        self.audio_rate = cfg.audio_fft_size * self.df
        self.m = [int(f * n) for f in (0.30, 0.40, 0.60, 0.70)]
        self.width = 3000 * n // fs
        self.hold = 1 << round(math.log2(fs / 34000))
        half = cfg.audio_fft_size // 2
        m = self.m
        # (l, r, mid, mode) of the four listeners; the AM one hears the
        # whole audio band, so that its noise is white (the LPC model
        # of a band with an empty stretch has large coefficients, whose
        # power raises the blanker's threshold above every click)
        self.rows = [(m[0], m[0] + self.width, m[0], 0),
                     (m[1], m[1] + self.width, m[1], 0),
                     (m[2], m[2] + self.width, m[2], 0),
                     (m[3] - half, m[3] + half, m[3], 2)]

    def freq(self, m: float) -> float:
        return (m - self.n / 2 + 1) * self.df

    def iq(self, start: int, count: int, gen, device="cuda"):
        """Samples [start, start+count) as u8 interleaved IQ (count a
        multiple of ``hold``)."""
        import torch

        t = torch.arange(start, start + count, dtype=torch.float64,
                         device=device)
        secs = t / self.fs

        def tone(m, f_hz, amp):
            cyc = torch.remainder(t * ((self.freq(m) + f_hz) / self.fs), 1.0)
            return amp * torch.polar(torch.ones_like(t), 2 * math.pi * cyc)

        def noise(m, sigma):
            low = torch.randn((count // self.hold, 2), dtype=torch.float64,
                              device=device, generator=gen) * sigma
            held = torch.view_as_complex(low).repeat_interleave(self.hold)
            return held * tone(m, 1500.0, 1.0)

        m0, m1, m2, m3 = self.m
        gate = ((secs > 1.2) & (torch.floor(secs - 1.2) % 2 == 0)).double()
        x = tone(m0, 1000.0, 0.06) * gate + noise(m0, 0.03)
        x = x + tone(m1, 1000.0, 0.06) + noise(m1, 0.04)
        x = x + tone(m2, 800.0, 0.06) + noise(m2, 0.01)
        clicks = (torch.remainder(secs - 0.05, 0.2)
                  < 8 / self.audio_rate).double()
        env = (1.0 + 0.5 * torch.sin(2 * math.pi * 600.0 * secs)
               + 2.5 * clicks)
        x = x + tone(m3, 0.0, 0.05) * env + noise(m3, 0.005)
        iq = torch.stack([x.real, x.imag], dim=-1)
        return torch.clamp(torch.round(iq * 128 + 128), 0, 255).to(
            torch.uint8).reshape(-1)


def nr_metric(algo: str, off: np.ndarray, on: np.ndarray, rate: float):
    """tools/verify/client.py's judgement of each processor
    (client.py:443-510) on the listener's audio without and with the
    nr opt-in: (numbers, passed)."""
    if algo == "spectral":
        res = {}
        for name, x in (("off", off), ("on", on)):
            wins = np.array_split(x, max(1, len(x) // int(rate // 4)))
            res[name] = {"floor": min(float(np.sqrt(np.mean(w ** 2)))
                                      for w in wins),
                         "tone": tone_amp(x, 1000.0, rate)}
        drop = 20 * math.log10(res["off"]["floor"]
                               / max(res["on"]["floor"], 1e-30))
        tone = 20 * math.log10(res["on"]["tone"]
                               / max(res["off"]["tone"], 1e-30))
        return ({"floor_drop_db": drop, "tone_delta_db": tone, **res},
                drop > 4 and tone > -6)
    if algo == "lms":
        snr = {}
        for name, x in (("off", off), ("on", on)):
            spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
            freqs = np.fft.rfftfreq(len(x), 1.0 / rate)
            sig = (freqs > 970) & (freqs < 1030)
            noise = (freqs > 200) & (freqs < 4500) & ~sig
            snr[name] = 10 * math.log10(spec[sig].max()
                                        / max(np.mean(spec[noise]), 1e-30))
        return ({"snr_db": snr, "gain_db": snr["on"] - snr["off"]},
                snr["on"] - snr["off"] > 6)
    if algo == "notch":
        a_off, a_on = tone_amp(off, 800.0, rate), tone_amp(on, 800.0, rate)
        rej = 20 * math.log10(a_off / max(a_on, 1e-30))
        return {"tone_off": a_off, "tone_on": a_on, "rejection_db": rej}, \
            rej > 26
    counts = {name: int(np.sum(np.abs(x) > 4.0 * np.sqrt(np.mean(x ** 2))))
              for name, x in (("off", off), ("on", on))}
    return {"click_samples": counts}, (counts["off"] > 20 and counts["on"]
                                       < 0.6 * counts["off"])


NR_STEPS = 10


def phase_nr(kernels):
    """The bench config with [input] nr = true for each nr_algo, at full
    width (128 channels, 128 waterfall views, 'views' steps): every
    listener opted in (a server where everyone turned noise reduction
    on).  Per algo the same capture runs with the nr column off and then
    on; each processor is judged on its listener as tools/verify judges
    it; step times, the profiler's split and the device-busy share of
    the opted-in run.  Returns the launches of each algo's opted-in
    run."""
    import torch

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, WaterfallViews, channels_from_numpy, to_device,
    )

    base = config_from_dict(BENCH_CFG)
    scene = NrScene(base)
    tones = Tones(base)
    (l, rr, mid, modes, active), (starts, lengths) = bench_tables(base, tones)
    for k, row in zip(NrScene.CHANNELS, scene.rows):
        l[k], rr[k], mid[k], modes[k] = row
    c = base.max_channels
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    hop = base.hop_size
    blk = base.hop_batch * hop
    stream = torch.cat([scene.iq(s * blk, blk, gen) for s in range(NR_STEPS)]
                       + [scene.iq(NR_STEPS * blk, hop, gen)])
    wire = 2 * blk
    results, launches_by_algo = {}, {}
    for algo in NR_ALGOS:
        # the notch converges at two_mu 1e-3 within the run (the gain of
        # tests/test_nr.py's notch test); the others at the defaults
        extra = {"nr_two_mu": 1e-3} if algo == "notch" else {}
        cfg = config_from_dict({**BENCH_CFG, "input": {
            **BENCH_CFG["input"], "nr": True, "nr_algo": algo, **extra}})
        pipe = HopPipeline(cfg, device="cuda")
        views = WaterfallViews(start=to_device(starts, torch.int32, "cuda"),
                               length=to_device(lengths, torch.int32, "cuda"))
        audio, step_ms = {}, []
        for opted in (False, True):
            table = channels_from_numpy(l, rr, mid, modes, active,
                                        nr=np.full(c, opted), device="cuda")
            state = pipe.init_state()
            got = []
            torch.cuda.synchronize()
            if opted:
                for k in kernels:
                    k.launches = 0
            for s in range(NR_STEPS):
                raw = stream[s * wire: s * wire + wire + 2 * hop]
                t0 = time.perf_counter()
                state, out = pipe.step(state, raw, table, views, "views",
                                       due_idx=pipe.default_due_idx(
                                           s * cfg.hop_batch))
                torch.cuda.synchronize()
                if opted:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                got.append(out.audio[:, list(NrScene.CHANNELS)].cpu()
                           .numpy())
                if not bool(torch.isfinite(out.avg_power).all()):
                    raise AssertionError(f"nr {algo} step {s}: non-finite "
                                         f"channel power")
            audio[opted] = np.concatenate(got)          # [hops, 4, half]
        launches = {k.name: k.launches for k in kernels}
        launches_by_algo[algo] = launches
        ch = NrScene.ALGOS.index(algo)
        # judge from 1.2 s on (the AGC window, NR's start, the LMS
        # transient); LMS and notch on the second half, as tools/verify
        # lets them settle 2.5 s
        first = int(1.2 * scene.audio_rate) if algo in ("spectral", "nb") \
            else audio[False].shape[0] * audio[False].shape[2] // 2
        off = audio[False][:, ch].reshape(-1).astype(np.float64)[first:]
        on = audio[True][:, ch].reshape(-1).astype(np.float64)[first:]
        numbers, ok = nr_metric(algo, off, on, scene.audio_rate)
        need = {"spectral": ["nr"], "lms": ["anr"], "notch": ["anr"],
                "nb": ["nb_lpc", "nb_repair"]}[algo]
        if not ok or any(launches[k] <= 0 for k in need):
            raise AssertionError(f"nr {algo}: {numbers}, launches "
                                 f"{launches}")
        raw = stream[:wire + 2 * hop]
        table = channels_from_numpy(l, rr, mid, modes, active,
                                    nr=np.ones(c, bool), device="cuda")

        def one_step():
            pipe.step(state, raw, table, views, "views")
        split = split_device_us(one_step)
        med = float(np.median(step_ms[1:10]))
        results[algo] = {"check": numbers, "launches": launches,
                         "step_ms": step_ms, "step_ms_median": med,
                         "device_split": split,
                         "device_busy_share": split["total_us"] / 1e3 / med,
                         "msps": blk / (med * 1e-3) / 1e6}
        emit({"phase": "nr", "nr_algo": algo, **results[algo]})
    return launches_by_algo


def phase_wbfm(kernels):
    """The wideband profile with stereo, de-emphasis and Opus at full
    width (128 WBFM channels over four stations): 10 steps through
    HopPipeline.step, each ear's tone and its rejection of the other
    through the 48 kHz decimated stream, the launches, the step time,
    a profiler split of one step, and a short DSPDriver run."""
    import torch

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.pipeline import HopPipeline, channels_from_numpy

    cfg = config_from_dict(WIDEBAND_CFG)
    st = Stations(cfg)
    c = cfg.max_channels
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    hop = cfg.hop_size
    blk = cfg.hop_batch * hop
    steps = 10
    stream = torch.cat([st.iq(k * blk, blk, gen) for k in range(steps + 2)]
                       + [st.iq((steps + 2) * blk, hop, gen)])
    # channel i on station i % 4, i // 4 bins (19 Hz each) off its carrier
    mid = np.array([st.m[i % 4] + i // 4 for i in range(c)])
    table = channels_from_numpy(mid - st.off96, mid + st.off96, mid,
                                np.full(c, 3), np.ones(c, bool),
                                device="cuda")
    pipe = HopPipeline(cfg, device="cuda")
    state = pipe.init_state()
    wire = 2 * blk
    audio, step_ms = [], []
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    for s in range(steps):
        raw = stream[s * wire: s * wire + wire + 2 * hop]
        t0 = time.perf_counter()
        state, out = pipe.step(state, raw, table, waterfall="off")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        audio.append(out.audio.cpu().numpy())
        if not bool(torch.isfinite(out.avg_power).all()):
            raise AssertionError(f"wbfm step {s}: non-finite channel power")
    launches = {k.name: k.launches for k in kernels}
    want_shape = (c, 2 * cfg.hop_batch * cfg.audio_fft_size // 2 // 4)
    if audio[0].shape != want_shape:
        raise AssertionError(f"wbfm audio {audio[0].shape}, want "
                             f"{want_shape}")
    # each ear over the last 5 steps (1.05 s at 48 kHz)
    rate = cfg.opus_rate
    a = np.concatenate(audio[-5:], axis=1).astype(np.float64)
    sep = {}
    for ch in [ch for ch in (0, 1, 2, 3, 37, 127) if ch < c]:
        left, right = a[ch, 0::2], a[ch, 1::2]
        res = {"left_hz": peak_hz(left, rate), "right_hz": peak_hz(right, rate),
               "left_db": 20 * math.log10(tone_amp(left, 800, rate)
                                          / tone_amp(left, 1300, rate)),
               "right_db": 20 * math.log10(tone_amp(right, 1300, rate)
                                           / tone_amp(right, 800, rate)),
               "rms": float(np.sqrt(np.mean(a[ch] ** 2)))}
        sep[ch] = res
        if (abs(res["left_hz"] - 800) > 3 or abs(res["right_hz"] - 1300) > 3
                or res["left_db"] <= 20 or res["right_db"] <= 20
                or res["rms"] < 100):
            raise AssertionError(f"wbfm channel {ch}: {res}")
    for name in ("pilot", "deemph", "agc_float"):
        if launches[name] <= 0:
            raise AssertionError(f"wbfm: {name} not launched: {launches}")
    raw = stream[:wire + 2 * hop]

    def one_step():
        pipe.step(state, raw, table, waterfall="off")
    split = split_device_us(one_step)
    med = float(np.median(step_ms[1:]))
    drv = drive_driver(cfg, stream[:4 * wire].cpu().numpy().tobytes(),
                       st.m[0] - st.off96, st.m[0], st.m[0] + st.off96,
                       rds=False)
    emit({"phase": "wbfm", "steps": steps, "launches": launches,
          "separation": sep, "step_ms": step_ms,
          "step_ms_median": med, "device_split": split,
          "device_busy_share": split["total_us"] / 1e3 / med,
          "audio_shape": list(audio[0].shape),
          "samples_per_step": cfg.hop_batch * hop,
          "msps": cfg.hop_batch * hop / (med * 1e-3) / 1e6, "driver": drv})
    return launches


def phase_rds(kernels):
    """The soak profile (stereo + RDS + de-emphasis, 128 channels) at
    full width over an FM capture of the RDS MPX: the port's RDSDecoder,
    fed one opted-in channel, must assemble the exact PI and PS within
    RDS_STEPS steps; rows with the rds flag off come out as zeros; the
    shared pilot's stereo carries mirror the RDS ones."""
    import torch

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.pipeline import HopPipeline, channels_from_numpy
    from phantomsdr_tpu_torch.runtime.rds import RDSDecoder

    cfg = config_from_dict(SOAK_CFG)
    c = cfg.max_channels
    wph = cfg.hop_size * 2
    blk = cfg.hop_batch * wph
    up = cfg.sps // cfg.audio_sps
    n = (RDS_STEPS * blk + wph) // 2
    stream = fm_s16(rds_mpx(n // up + 1, cfg.audio_sps), up, cfg.sps, "cuda",
                    SEED + 3)[:2 * n]
    mid, off96 = cfg.fft_result_size // 2, 96000 * cfg.fft_result_size // cfg.sps
    mids = mid + np.arange(c) % 8               # a few bins off the carrier
    rds_flags = np.arange(c) % 2 == 0
    table = channels_from_numpy(mids - off96, mids + off96, mids,
                                np.full(c, 3), np.ones(c, bool),
                                rds=rds_flags, device="cuda")
    pipe = HopPipeline(cfg, device="cuda")
    state = pipe.init_state()
    dec = RDSDecoder(cfg.audio_sps / pipe.rds_params.decim)
    got_at, step_ms = None, []
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    for s in range(RDS_STEPS):
        raw = stream[s * blk: s * blk + blk + wph]
        t0 = time.perf_counter()
        state, out = pipe.step(state, raw, table, waterfall="off")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        rds8 = out.rds.cpu().numpy()
        if rds8[~rds_flags].any():
            raise AssertionError(f"rds step {s}: a row with rds off has "
                                 f"baseband")
        dec.feed(rds8[0])
        g = dec.group.status()
        if got_at is None and g["pi"] == f"{RDS_PI:04X}" and g["ps"] == RDS_PS:
            got_at = s + 1
    launches = {k.name: k.launches for k in kernels}
    a = state.audio
    if not (torch.equal(a.st.phase, a.rds.phase)
            and torch.equal(a.st.freq, a.rds.freq)):
        raise AssertionError("rds: the shared pilot's stereo carries do not "
                             "mirror the RDS ones")
    g = dec.group.status()
    if got_at is None:
        raise AssertionError(f"rds: PI/PS not decoded in {RDS_STEPS} steps: "
                             f"{g}")
    raw = stream[:blk + wph]

    def one_step():
        pipe.step(state, raw, table, waterfall="off")
    split = split_device_us(one_step)
    med = float(np.median(step_ms[1:]))
    drv = drive_driver(cfg, stream[:4 * blk].cpu().numpy().tobytes(),
                       mid - off96, mid, mid + off96, rds=True)
    emit({"phase": "rds", "steps": RDS_STEPS, "pi_ps_at_step": got_at,
          "decoder": g, "launches": launches, "step_ms": step_ms,
          "step_ms_median": med, "device_split": split,
          "device_busy_share": split["total_us"] / 1e3 / med,
          "rds_shape": list(out.rds.shape), "driver": drv})
    return launches


RDS_STEPS = 30        # 5.1 s of capture; PS comes in 0A groups every 1.75 s


def drive_driver(cfg, host_bytes: bytes, l: int, m: int, r: int,
                 rds: bool) -> dict:
    """DSPDriver over an in-memory capture with one FM listener (with
    the RDS opt-in where asked): every batch must reach the consumer in
    the decimated / stereo / RDS layout of the config."""
    from phantomsdr_tpu_torch.runtime.driver import DSPDriver, SampleSource
    from phantomsdr_tpu_torch.runtime.registry import ChannelRegistry

    src = SampleSource(cfg, io.BytesIO(host_bytes))
    channels = ChannelRegistry(cfg)
    slot = channels.acquire("smoke")
    channels.retune(slot, l, float(m), r)
    channels.set_mode(slot, "FM")
    channels.set_rds(slot, rds)
    got, bad, done = [], [], threading.Event()
    nblocks = len(host_bytes) // (cfg.hop_batch * cfg.hop_size * 2
                                  * (1 if cfg.input_format == "u8" else 2))

    def consumer(frame0, audio, pwr, wfv, due, wf_meta, audio_meta, rds8):
        per_ch = cfg.audio_channels * cfg.hop_batch * cfg.audio_fft_size // 2
        if cfg.device_decim:
            ok = audio.ndim == 2 and audio.shape[1] == per_ch // cfg.opus_decim
        else:
            ok = audio.shape[0] == cfg.hop_batch
        if rds:
            ok = ok and rds8 is not None and rds8.shape[1] == 2
        else:
            ok = ok and rds8 is None
        if not ok or not np.isfinite(pwr).all():
            bad.append((frame0, audio.shape,
                        None if rds8 is None else rds8.shape))
        got.append(frame0)
        if len(got) >= nblocks:
            done.set()

    drv = DSPDriver(cfg, src, channels, consumer,
                    waterfall_active=lambda: False, device="cuda")
    drv.start()
    ok = done.wait(timeout=300)
    drv.stop()
    snap = drv.metrics.snapshot(cfg)
    if not ok or bad or drv.metrics.device_errors:
        raise AssertionError(f"driver: {len(got)}/{nblocks} batches, bad "
                             f"{bad}, errors {drv.metrics.device_errors} "
                             f"{drv.metrics.last_device_error}")
    return {"batches": len(got), "step_ms_p50": snap["step_ms_p50"],
            "device_errors": drv.metrics.device_errors}


def phase_main(cfg, tones, stream, kernels):
    """Full width main path: 10 'views' + 2 'off' steps; ``kernels`` are
    the path's (K-WF, K-PLL, K-AGC)."""
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


REAL_STEPS = ["views"] * 8 + ["off"] * 2


def phase_real(cfg, tones, stream, kernels):
    """HopPipeline.step at REAL_CFG (bench.py's real profile: s16 real
    at 70 MSPS, 96 hops a step, 64 channels) over REAL_STEPS on
    ``tones``' capture; phase_main's criteria: each tone at its Hz within
    3 Hz over the last 6 steps, the waterfall peak of view 0 on the USB
    tone's bin in every 'views' step, and K-WF, K-PLL and K-AGC
    (``kernels``) launched; with the step times and the device-busy
    share of one 'views' step (torch.profiler)."""
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
    audio, wf, step_ms = [], [], []
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    for s, mode in enumerate(REAL_STEPS):
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
            raise AssertionError(f"real step {s}: non-finite channel power")
    launches = {k.name: k.launches for k in kernels}

    res = {}
    a = np.concatenate(audio)[-6 * cfg.hop_batch:]      # [hops, 4, half]
    for i, name in enumerate(tones.names):
        x = a[:, i].reshape(-1).astype(np.float64)
        want = tones.tone_bins[i] * tones.df
        got = peak_hz(x, tones.audio_rate)
        res[name] = {"want_hz": want, "got_hz": got,
                     "rms": float(np.sqrt(np.mean(x ** 2)))}
        if abs(got - want) > 3.0 or res[name]["rms"] < 100:
            raise AssertionError(f"real: {name} tone at {got} Hz (rms "
                                 f"{res[name]['rms']}), want {want}")
    # view 0 starts 500 bins below the USB tone (level 0)
    cents = [max_run_centroid(v[0, :cfg.waterfall_size])
             for step in wf for v in step]
    if any(abs(cc - 500) > 1 for cc in cents):
        raise AssertionError(f"real: waterfall peak off the carrier: "
                             f"{cents}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"real: a kernel was not launched: {launches}")
    raw = stream[:blk + pipe.wire_per_hop]

    def one_step():
        pipe.step(state, raw, table, views, "views", due_idx=due_idx)
    split = split_device_us(one_step)
    med = float(np.median(step_ms[1:8]))
    samples = cfg.hop_batch * cfg.hop_size
    emit({"phase": "real", "steps": REAL_STEPS, "launches": launches,
          "tones": res, "waterfall_peak_offsets": sorted(set(cents)),
          "step_ms": step_ms, "views_step_ms_median": med,
          "off_step_ms": step_ms[8:], "device_split": split,
          "device_busy_share": split["total_us"] / 1e3 / med,
          "msps": samples / (med * 1e-3) / 1e6,
          "samples_per_step": samples, "due_rows": len(due),
          "spectrum_bins": cfg.fft_result_size + 1,
          "levels": cfg.downsample_levels})
    return launches


MESH_STEPS = 6


def av1_roundtrip(rows: list[np.ndarray], width: int) -> dict:
    """Whether libaom loaded and, if it did, ``rows`` (int8 waterfall
    rows, a multiple of 8) through the port's AV1 encoder and decoder:
    lossless, so every decoded row must equal its row."""
    from phantomsdr_tpu_torch.runtime import av1

    if not av1.av1_available():
        return {"libaom": False, "why": av1._Aom.failure()}
    enc, dec = av1.AV1Encoder(width), av1.AV1Decoder()
    units, nbytes = 0, 0
    for i in range(0, len(rows), av1.WATERFALL_COALESCE):
        group = rows[i:i + av1.WATERFALL_COALESCE]
        blob = None
        for j, row in enumerate(group):
            blob = enc.send(row.tobytes(), i + j, 0, width)
        (got,) = dec.decode(blob)
        if not np.array_equal(got, np.stack(group)):
            raise AssertionError(f"AV1 round trip: unit {units} differs")
        units += 1
        nbytes += len(blob)
    enc.close()
    dec.close()
    return {"libaom": True, "units": units, "rows": len(rows),
            "bytes": nbytes, "lossless": True}


def phase_mesh(cfg, tones, stream, kernels):
    """Mesh server mode on one card: the bench config as 4 shards on
    cuda:0 (parallel.sharded through the hand kernels), MESH_STEPS
    'views' steps against the single-device step on the same stream
    (int16 audio within 4, power rtol 2e-4, waterfall rows within one
    step on < 0.1% of bytes); step times of both, their device-busy
    shares and peak device memory; the mesh's waterfall rows through
    the port's AV1 pair.  ``kernels`` are the path's (K-WF, K-PLL,
    K-AGC); returns their launches in the mesh steps."""
    import torch

    from phantomsdr_tpu_torch.parallel import (
        ShardedHopPipeline, make_mesh, unpack_outputs_sharded,
    )
    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, WaterfallViews, channels_from_numpy, to_device,
    )

    mesh = make_mesh(devices=["cuda:0"] * 4)
    sp = ShardedHopPipeline(cfg, mesh)
    pipe = HopPipeline(cfg, device="cuda")
    table_np, (starts, lengths) = bench_tables(cfg, tones)
    t1 = channels_from_numpy(*table_np, device="cuda")
    t4 = sp.channels_from_numpy(*table_np)
    views = WaterfallViews(start=to_device(starts, torch.int32, "cuda"),
                           length=to_device(lengths, torch.int32, "cuda"))
    wph = pipe.wire_per_hop
    blk = cfg.hop_batch * wph
    c, half, w = cfg.max_channels, cfg.audio_fft_size // 2, len(starts)

    def single_step(state, s):
        return pipe.step(state, stream[s * blk: s * blk + blk + wph], t1,
                         views, "views",
                         due_idx=pipe.default_due_idx(s * cfg.hop_batch))

    def mesh_step(state, s, due_idx):
        return sp.step(state, sp.shard_raw(stream[wph + s * blk:
                                                  wph + (s + 1) * blk]),
                       t4, views, "views", due_idx=due_idx)

    layouts = [sp.due_layout(s * cfg.hop_batch) for s in range(MESH_STEPS)]
    due_idx = [to_device(idx, torch.int32, "cuda") for idx, _ in layouts]
    # the single device's halo for step 0 is the stream's first hop:
    # the mesh carries it in its state
    st1 = pipe.init_state()
    st4 = sp.init_state()._replace(halo=stream[:wph].clone())
    single, ms1, ms4, rows = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base1 = torch.cuda.memory_allocated()
    for s in range(MESH_STEPS):
        t0 = time.perf_counter()
        st1, o1 = single_step(st1, s)
        torch.cuda.synchronize()
        ms1.append((time.perf_counter() - t0) * 1e3)
        single.append((o1.audio.cpu().numpy(), o1.avg_power.cpu().numpy(),
                       o1.wf.cpu().numpy()))
    peak1 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    base4 = torch.cuda.memory_allocated()
    for k in kernels:
        k.launches = 0
    for s in range(MESH_STEPS):
        t0 = time.perf_counter()
        st4, o4 = mesh_step(st4, s, due_idx[s])
        torch.cuda.synchronize()
        ms4.append((time.perf_counter() - t0) * 1e3)
        a1, p1, w1 = single[s]
        counts = layouts[s][1]
        a4, p4, w4, _ = unpack_outputs_sharded(
            torch.cat(o4.packed).cpu().numpy(), sp.n, cfg.hop_batch, c,
            half, w, sp.view_cap, sp.due_cap_local)
        w4 = w4[sp.due_row_selector(counts)]
        a_err = int(np.abs(a1.astype(int) - a4.astype(int)).max())
        if a_err > 4:
            raise AssertionError(f"mesh step {s}: int16 audio off by {a_err}")
        np.testing.assert_allclose(p4, p1, rtol=2e-4, atol=1e-12,
                                   err_msg=f"mesh step {s}: channel power")
        d = np.abs(w4.astype(int) - w1[:sum(counts)].astype(int))
        if d.max() > 1 or (d > 0).mean() >= 1e-3:
            raise AssertionError(f"mesh step {s}: waterfall rows differ "
                                 f"(max {d.max()}, share {(d > 0).mean()})")
        rows += [r[0, :cfg.waterfall_size] for r in w4]
    launches = {k.name: k.launches for k in kernels}
    peak4 = torch.cuda.max_memory_allocated()
    if min(launches.values()) <= 0:
        raise AssertionError(f"mesh: a kernel was not launched: {launches}")
    if int(np.abs(single[-1][0]).max()) < 1000:
        raise AssertionError("mesh: the compared audio is silent")

    split1 = split_device_us(lambda: single_step(st1, 0))
    split4 = split_device_us(lambda: mesh_step(st4, 0, due_idx[0]))
    med1, med4 = float(np.median(ms1[1:])), float(np.median(ms4[1:]))
    rows = rows[:len(rows) // 8 * 8]
    emit({"phase": "mesh", "devices": [str(d) for d in mesh],
          "steps": MESH_STEPS, "launches": launches,
          "step_ms": {"mesh": ms4, "single": ms1},
          "step_ms_median": {"mesh": med4, "single": med1},
          "mesh_over_single": med4 / med1,
          "device_split": {"mesh": split4, "single": split1},
          "device_busy_share": {"mesh": split4["total_us"] / 1e3 / med4,
                                "single": split1["total_us"] / 1e3 / med1},
          # the peak during each run, and above what was held before it
          # (the capture, both pipelines' tables and carries)
          "peak_device_bytes": {"mesh": peak4, "single": peak1},
          "peak_device_bytes_above_start": {"mesh": peak4 - base4,
                                            "single": peak1 - base1},
          "av1": av1_roundtrip(rows, cfg.waterfall_size)})
    return launches


MH_PROCESSES = 2
MH_STEPS = MESH_STEPS
MODE_NAMES = ("USB", "LSB", "AM", "FM")     # registry.MODE_CODES order


def mh_clients(cfg, tones, channels, waterfalls) -> None:
    """Fill every slot of the registries' ranges as that many clients
    would: listener s tuned to row s of bench_tables' channels with its
    mode; waterfall client w on a view waterfall_size points wide at
    level 7w mod levels, client 0 over the USB tone.  The same calls on
    full-range registries make the single device's tables."""
    (l, r, mid, mode, _), _ = bench_tables(cfg, tones)
    for _ in range(channels.slot_count):
        slot = channels.acquire("smoke")
        s = slot.slot
        if not channels.retune(slot, int(l[s]), float(mid[s]), int(r[s])):
            raise AssertionError(f"slot {s}: retune refused")
        channels.set_mode(slot, MODE_NAMES[mode[s]])
    for _ in range(waterfalls.slot_count):
        cid, ws = waterfalls.acquire()
        lev = (cid * 7) % cfg.downsample_levels
        span = cfg.waterfall_size << lev
        lo = ((cid * 131) << lev) % max(cfg.fft_result_size - span, 1)
        if cid == 0:
            lo = tones.usb_bin - 500
        waterfalls.retune(cid, ws, lo, lo + span)


def mh_tables(cfg, tones):
    """The global channel columns and view starts/lengths that
    mh_clients makes (full-range registries)."""
    from phantomsdr_tpu_torch.ops.quantize import pyramid_level_offsets
    from phantomsdr_tpu_torch.runtime.registry import (
        ChannelRegistry, WaterfallRegistry,
    )

    channels = ChannelRegistry(cfg)
    waterfalls = WaterfallRegistry(cfg, pyramid_level_offsets(
        cfg.fft_result_size, cfg.downsample_levels))
    mh_clients(cfg, tones, channels, waterfalls)
    _, tbl, _, _ = channels.snapshot()
    _, start, length, _ = waterfalls.snapshot()
    return tbl, start, length


class GatedCapture:
    """The ingest's capture file, read as SampleSource reads a stream:
    the first block at once (no client has joined, so the cluster skips
    it and the follower's clients ride upstream after the skip), the
    rest only after ``ready()``.  So every channel row and view is live,
    with its full reset, from the first block computed."""

    def __init__(self, path, first_bytes: int, ready):
        self.file = open(path, "rb")
        self.first = first_bytes
        self.ready = ready

    def read(self, n: int) -> bytes:
        if self.first <= 0 and self.ready is not None:
            self.ready()
            self.ready = None
        data = self.file.read(n if self.first <= 0 else min(n, self.first))
        self.first -= len(data)
        return data

    def close(self):
        self.file.close()


def join_after_followers(cfg, tones, server) -> None:
    """Ingest: wait until every follower's listeners and waterfall
    clients are in the global tables, then fill this host's ranges."""
    ch, wf = server.channels, server.waterfalls
    others = np.ones(cfg.max_channels, bool)
    others[ch.slot_offset:ch.slot_offset + ch.slot_count] = False
    deadline = time.monotonic() + 120
    while (ch.remote_count < others.sum()
           or not (wf.snapshot()[2][others] > 0).all()):
        if time.monotonic() > deadline:
            raise RuntimeError("the followers' clients never arrived")
        time.sleep(0.01)
    mh_clients(cfg, tones, ch, wf)


def mh_worker(pid: int, workdir: str, coord: int, link_port: int) -> int:
    """One process of the multihost phase (``--multihost-worker``): the
    CLI's cluster path on cuda:0 -- ``bootstrap``, then
    ``main.build_multihost`` -- with its registry ranges filled by
    mh_clients (the follower's before the stream starts, the ingest's
    as GatedCapture lets the first computed block through), whose
    MultihostDriver serves the stream in ``workdir`` to its end
    (process 0 reads it and ships process 1 its rows and the control
    block over the link).  What the driver hands the serving edge each
    step, with the time, the staging seconds and the kernels' launches
    at that moment, goes to ``workdir``; then one step on zero rows is
    profiled on both processes."""
    import torch
    import torch.distributed as dist

    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.main import build_multihost
    from phantomsdr_tpu_torch.ops.cuda import agc, pll, waterfall
    from phantomsdr_tpu_torch.parallel.multihost import bootstrap
    from phantomsdr_tpu_torch.pipeline import WaterfallViews, to_device

    out_dir = Path(workdir)
    cluster = bootstrap(f"127.0.0.1:{coord}", MH_PROCESSES, pid,
                        device="cuda")
    cfg = config_from_dict(BENCH_CFG)
    tones = Tones(cfg)
    stream = None
    if pid == 0:
        stream = GatedCapture(out_dir / "stream.u8",
                              cfg.hop_batch * 2 * cfg.hop_size,
                              lambda: join_after_followers(cfg, tones,
                                                           server))
    server, driver = build_multihost(cfg, stream, f"127.0.0.1:{link_port}",
                                     link_port, cluster)
    if pid != 0:
        mh_clients(cfg, tones, server.channels, server.waterfalls)
    kernels = [waterfall.KERNEL, pll.KERNEL, agc.KERNEL]
    comm = cluster.collectives
    steps = []
    serve = server.dispatch_threadsafe

    def dispatch(frame0, audio, pwr, wf, due, wf_meta, audio_meta, rds):
        # the serving edge's hand-off: keep what it is given
        steps.append({"t": time.monotonic(), "frame0": frame0,
                      "audio": audio, "power": pwr, "wf": wf,
                      "due": list(due), "chan_l": audio_meta[0].tolist(),
                      "view_r": wf_meta[1].tolist(),
                      "staging_s": dict(comm.seconds),
                      "launches": {k.name: k.launches for k in kernels}})
        serve(frame0, audio, pwr, wf, due, wf_meta, audio_meta, rds)

    server.dispatch_threadsafe = dispatch
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    driver.start()
    m = driver.metrics
    deadline = time.monotonic() + 240
    while not (m.eof or m.device_errors) and time.monotonic() < deadline:
        time.sleep(0.05)
    if not m.eof or m.device_errors or len(steps) != MH_STEPS:
        driver.stop()
        print(f"multihost worker {pid}: eof {m.eof}, {len(steps)} steps, "
              f"device errors {m.device_errors} {m.last_device_error}",
              flush=True)
        return 1
    peak = torch.cuda.max_memory_allocated()
    # the device work of one step alone, on both processes at once (its
    # collectives pair up); the follower reaches it only after the
    # ingest's eof, so stop() below closes idle links
    rt, sp = driver.rt, driver.rt.sp
    tbl, start, length = mh_tables(cfg, tones)
    table = sp.channels_from_numpy(*tbl[:5], am_env=tbl[7], rds=tbl[6],
                                   nr=tbl[5])
    views = WaterfallViews(start=to_device(start, torch.int32, sp.device),
                           length=to_device(length, torch.int32, sp.device))
    zrows = np.zeros((len(rt.local_shards), sp.raw_shard_len), np.uint8)
    idx, _ = sp.due_layout(0)
    state = sp.init_state()
    split = split_device_us(lambda: sp.step(state, rt.global_raw(zrows),
                                            table, views, "views",
                                            due_idx=idx))
    driver.stop()
    if stream is not None:
        stream.close()
    dist.destroy_process_group()
    np.save(out_dir / f"audio{pid}.npy", np.stack([s["audio"]
                                                   for s in steps]))
    np.save(out_dir / f"power{pid}.npy", np.stack([s["power"]
                                                   for s in steps]))
    wf = [s["wf"] for s in steps if s["wf"] is not None]
    np.save(out_dir / f"wf{pid}.npy", np.concatenate(wf))
    for s in steps:
        del s["audio"], s["power"], s["wf"]
    (out_dir / f"result{pid}.json").write_text(json.dumps({
        "process": pid, "backend": cluster.backend, "staged": comm.staged,
        "chan_offset": rt.chan_offset, "chan_count": rt.chan_count,
        "local_shards": rt.local_shards, "steps": steps,
        "driver_step_ms": [x * 1e3 for x in m.step_seconds],
        "metrics": m.snapshot(cfg), "device_split": split,
        "peak_device_bytes": peak}))
    return 0


def mh_reference(cfg, tones, stream, frame0: int):
    """The single device on the cluster's stream and tables: HopPipeline
    from a zero halo (SampleSource's) and the hop parity of ``frame0``,
    the first computed block's, over the same MH_STEPS blocks with every
    row and view of mh_tables live from the first.  Returns each step's
    (audio, power, waterfall rows of its due positions)."""
    import torch

    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, WaterfallViews, channels_from_numpy, to_device,
        waterfall_due_positions,
    )
    from phantomsdr_tpu_torch.runtime.registry import RESET_FULL

    pipe = HopPipeline(cfg, device="cuda")
    tbl, start, length = mh_tables(cfg, tones)
    table = channels_from_numpy(*tbl[:5], am_env=tbl[7], rds=tbl[6],
                                nr=tbl[5], device="cuda")
    views = WaterfallViews(start=to_device(start, torch.int32, "cuda"),
                           length=to_device(length, torch.int32, "cuda"))
    reset = to_device(np.full(cfg.max_channels, RESET_FULL, np.int32),
                      torch.int32, "cuda")
    wph = pipe.wire_per_hop
    blk = cfg.hop_batch * wph
    raw = torch.cat([torch.zeros(wph, dtype=stream.dtype,
                                 device=stream.device),
                     stream[:MH_STEPS * blk]])
    state = pipe.init_state(frame0)
    out = []
    for s in range(MH_STEPS):
        f0 = frame0 + s * cfg.hop_batch
        due = waterfall_due_positions(cfg, f0)
        state, o = pipe.step(state, raw[s * blk: s * blk + blk + wph],
                             table, views, "views",
                             reset=reset if s == 0 else None,
                             due_idx=pipe.default_due_idx(f0))
        out.append((o.audio.cpu().numpy(), o.avg_power.cpu().numpy(),
                    o.wf[:len(due)].cpu().numpy()))
    return out, tbl


def phase_multihost(cfg, tones, stream, kernels):
    """Multi-host server mode on this card: MH_PROCESSES processes of
    ``python3 chip_smoke.py --multihost-worker`` run the CLI's cluster
    path (bootstrap, build_multihost, MultihostDriver) on cuda:0, one
    shard each (they share the card, so gloo staged through pinned host
    memory), every channel slot a listener and every waterfall slot a
    client, over MH_STEPS blocks of the bench stream to its end.  Each
    host's channels and its waterfall replica are held against the
    single device on the same stream and tables (mh_reference) with the
    mesh phase's tolerances; each step's table must be the clients'.  The ingest's cycle -- one dispatch to the
    next: block read, ack barrier, control block, rows over the link,
    step -- is the cluster's time a step, beside the driver's step time
    and the real time of a block.  Returns each process's launches of
    ``kernels`` in the steps after the first."""
    import shutil

    from phantomsdr_tpu_torch.pipeline import waterfall_due_positions
    from phantomsdr_tpu_torch.runtime.codecs import _load_hostlib

    _load_hostlib()     # built here once, not by both processes at once
    workdir = Path(__file__).resolve().parent / "build" / "multihost" \
        / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    blk = cfg.hop_batch * 2 * cfg.hop_size
    # a block that no client hears (the cluster skips it), then MH_STEPS
    with open(workdir / "stream.u8", "wb") as f:
        f.write(bytes(blk))
        stream[:MH_STEPS * blk].cpu().numpy().tofile(f)
    coord, link = free_ports(2)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--multihost-worker", str(pid),
         str(workdir), str(coord), str(link)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(MH_PROCESSES)]
    logs, failed = wait_all(procs, 300)
    if failed:
        raise AssertionError(f"multihost: {failed}\n"
                             + "\n".join(x[-3000:] for x in logs))
    res = [json.loads((workdir / f"result{pid}.json").read_text())
           for pid in range(MH_PROCESSES)]
    ref, tbl = mh_reference(cfg, tones, stream, cfg.hop_batch)
    err, wf0 = 0, None
    for r in res:
        pid, o, c = r["process"], r["chan_offset"], r["chan_count"]
        a = np.load(workdir / f"audio{pid}.npy")
        p = np.load(workdir / f"power{pid}.npy")
        w = np.load(workdir / f"wf{pid}.npy")
        wf0 = w if wf0 is None else wf0
        if not np.array_equal(w, wf0):
            raise AssertionError("multihost: waterfall replicas differ")
        rows = 0
        for s, ((a1, p1, w1), rec) in enumerate(zip(ref, r["steps"])):
            f0 = (s + 1) * cfg.hop_batch
            if rec["frame0"] != f0 \
                    or rec["due"] != waterfall_due_positions(cfg, f0) \
                    or rec["chan_l"] != tbl[0].tolist() \
                    or 0 in rec["view_r"]:
                raise AssertionError(
                    f"multihost process {pid} step {s}: frame0 "
                    f"{rec['frame0']}, due rows or tables not the clients'")
            e = int(np.abs(a[s].astype(int)
                           - a1[:, o:o + c].astype(int)).max())
            err = max(err, e)
            if e > 4:
                raise AssertionError(f"multihost process {pid} step {s}: "
                                     f"int16 audio off by {e}")
            np.testing.assert_allclose(
                p[s], p1[:, o:o + c], rtol=2e-4, atol=1e-12,
                err_msg=f"multihost process {pid} step {s}: power")
            d = np.abs(w[rows:rows + len(w1)].astype(int) - w1.astype(int))
            rows += len(w1)
            if d.size and (d.max() > 1 or (d > 0).mean() >= 1e-3):
                raise AssertionError(
                    f"multihost process {pid} step {s}: waterfall rows "
                    f"differ (max {d.max()}, share {(d > 0).mean()})")
        if rows != len(w):
            raise AssertionError(f"multihost process {pid}: {len(w)} "
                                 f"waterfall rows, {rows} due")
    if int(np.abs(ref[-1][0]).max()) < 1000:
        raise AssertionError("multihost: the compared audio is silent")
    shutil.rmtree(workdir, ignore_errors=True)

    def per_process(fn):
        return {r["process"]: fn(r) for r in res}

    def steps_after_first(r, key):
        a, b = r["steps"][0][key], r["steps"][-1][key]
        return {k: b[k] - a[k] for k in a}

    launches = per_process(lambda r: steps_after_first(r, "launches"))
    for pid, n in launches.items():
        if min(n.get(k.name, 0) for k in kernels) <= 0:
            raise AssertionError(f"multihost process {pid}: a kernel was "
                                 f"not launched: {n}")
    t = [s["t"] for s in res[0]["steps"]]
    cycle_ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    staging = per_process(lambda r: [
        {k: (b["staging_s"][k] - a["staging_s"][k]) * 1e3
         for k in a["staging_s"]}
        for a, b in zip(r["steps"], r["steps"][1:])])
    block_s = cfg.hop_batch * cfg.hop_size / cfg.sps
    cycle_med = float(np.median(cycle_ms))
    emit({"phase": "multihost", "processes": MH_PROCESSES,
          "device": "cuda:0 shared", "backend": res[0]["backend"],
          "staged": res[0]["staged"], "steps": MH_STEPS,
          "audio_max_abs_int16": err,
          "ingest_cycle_ms": cycle_ms, "ingest_cycle_ms_median": cycle_med,
          "real_time_ms_per_block": block_s * 1e3,
          "real_time_share": cycle_med / (block_s * 1e3),
          "driver_step_ms": per_process(lambda r: r["driver_step_ms"]),
          "driver_step_ms_p50": per_process(
              lambda r: r["metrics"]["step_ms_p50"]),
          "staging_ms": staging,
          "staging_ms_median": {
              pid: {k: float(np.median([x[k] for x in v])) for k in v[0]}
              for pid, v in staging.items()},
          "device_split": per_process(lambda r: r["device_split"]),
          "device_busy_share_of_cycle": per_process(
              lambda r: r["device_split"]["total_us"] / 1e3 / cycle_med),
          "peak_device_bytes": per_process(lambda r: r["peak_device_bytes"]),
          "launches_after_first_step": launches})
    return launches


def free_ports(k: int) -> list[int]:
    """``k`` distinct free TCP ports on localhost."""
    socks = [socket.socket() for _ in range(k)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def wait_all(procs, timeout: float):
    """Each process's output and the failures (a non-zero exit, or no
    exit within ``timeout`` seconds in all, which kills them all)."""
    logs, failed = [], []
    deadline = time.monotonic() + timeout
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            failed.append(f"process {pid} timed out")
        logs.append(out or "")
        if p.returncode != 0:
            failed.append(f"process {pid} exited {p.returncode}")
    return logs, failed


def phase_driver(cfg, tones, host_bytes, mesh=None, tone_from=None):
    """DSPDriver over an in-memory capture with the USB tone's listener
    and one waterfall client (on ``mesh`` in mesh mode); with
    ``tone_from`` the listener's audio of the batches from that one on
    must carry its tone."""
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
        got.append((frame0, audio[:, slot.slot].copy()))
        if len(got) >= nblocks:
            done.set()

    drv = DSPDriver(cfg, src, channels, consumer, waterfall_registry=wf,
                    waterfall_active=lambda: True, device="cuda", mesh=mesh)
    drv.start()
    ok = done.wait(timeout=300)
    drv.stop()
    snap = drv.metrics.snapshot(cfg)
    name = "mesh_driver" if mesh else "driver"
    if not ok or bad or drv.metrics.device_errors:
        raise AssertionError(f"{name}: {len(got)}/{nblocks} batches, bad "
                             f"{bad}, errors {drv.metrics.device_errors} "
                             f"{drv.metrics.last_device_error}")
    tone = None
    if tone_from is not None:
        x = np.concatenate([a for _, a in got[tone_from:]]).reshape(-1)
        tone = {"want_hz": tones.tone_bins[0] * tones.df,
                "got_hz": peak_hz(x.astype(np.float64), tones.audio_rate),
                "rms": float(np.sqrt(np.mean(x.astype(np.float64) ** 2)))}
        if abs(tone["got_hz"] - tone["want_hz"]) > 3.0 or tone["rms"] < 100:
            raise AssertionError(f"{name}: USB tone {tone}")
    emit({"phase": name, "batches": len(got),
          "device_errors": drv.metrics.device_errors,
          "step_ms_p50": snap["step_ms_p50"],
          "msps_device": snap["msps_device"], "tone": tone,
          "devices": [str(d) for d in drv.devices]})


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


def phase_server(cfg, tones, host_bytes, mesh=None):
    try:
        from aiohttp import web
    except ImportError:
        emit({"server_phase": "skipped: aiohttp not installed"})
        return
    from phantomsdr_tpu_torch.main import build

    server, driver = build(cfg, io.BytesIO(host_bytes), loop_file=True,
                           device="cuda", mesh=mesh)
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
    name = "mesh_server" if mesh else "server"
    if res["audio_packets"] < 3 or res["waterfall_packets"] < 2:
        raise AssertionError(f"{name}: {res}")
    if driver.metrics.device_errors:
        raise AssertionError(f"{name}: device errors "
                             f"{driver.metrics.last_device_error}")
    emit({"phase": name, **res,
          "device_errors": driver.metrics.device_errors})


def toml_text(cfg: dict) -> str:
    """``cfg`` (BENCH_CFG's form: tables of scalars and sub-tables) as
    the text of a config file."""
    lines = []

    def table(name, d):
        lines.append(f"[{name}]")
        subs = [(f"{name}.{k}", v) for k, v in d.items()
                if isinstance(v, dict)]
        lines.extend(f"{k} = {json.dumps(v)}" for k, v in d.items()
                     if not isinstance(v, dict))
        lines.append("")
        for sub in subs:
            table(*sub)

    for name, d in cfg.items():
        table(name, d)
    return "\n".join(lines)


def http_json(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return json.loads(r.read())


def phase_multihost_server(tones, host_bytes: bytes):
    """The CLI as a cluster on this card: MH_PROCESSES processes of
    ``python -m phantomsdr_tpu_torch --device cuda --coordinator ...
    --num-processes 2 --process-id i`` serve the bench config from a
    looped capture; websocket clients on the follower's /audio (its own
    slot, tuned to the USB tone) and /waterfall must receive packets,
    /metrics on every process must show no device error, and SIGTERM
    must end every process within 30 s (skipped only when aiohttp is
    not installed)."""
    import shutil

    try:
        import aiohttp  # noqa: F401
    except ImportError:
        emit({"multihost_server_phase": "skipped: aiohttp not installed"})
        return
    workdir = Path(__file__).resolve().parent / "build" / "multihost" \
        / "chip_smoke_cli"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    (workdir / "capture.u8").write_bytes(host_bytes)
    coord, link, *ports = free_ports(2 + MH_PROCESSES)
    procs = []
    for pid, port in enumerate(ports):
        conf = workdir / f"config{pid}.toml"
        conf.write_text(toml_text({"server": {"port": port}, **BENCH_CFG}))
        role = (["--link-port", str(link)] if pid == 0
                else ["--link-addr", f"127.0.0.1:{link}"])
        with open(workdir / f"p{pid}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "phantomsdr_tpu_torch", "-c",
                 str(conf), "--device", "cuda", "--coordinator",
                 f"127.0.0.1:{coord}", "--num-processes",
                 str(MH_PROCESSES), "--process-id", str(pid),
                 "--input-file", str(workdir / "capture.u8"), "--loop"]
                + role, stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL,
                cwd=Path(__file__).resolve().parent))

    def logs():
        return "\n".join((workdir / f"p{i}.log").read_text(errors="replace")[-3000:]
                         for i in range(MH_PROCESSES))

    try:
        deadline = time.monotonic() + 240
        up = set()
        while len(up) < MH_PROCESSES:
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in procs):
                raise AssertionError(f"multihost_server: not serving "
                                     f"({sorted(up)} up)\n{logs()}")
            for pid, port in enumerate(ports):
                try:
                    http_json(port, "/metrics")
                    up.add(pid)
                except OSError:
                    pass
            time.sleep(0.5)
        res = asyncio.run(_server_clients(ports[1], tones))
        metrics = {pid: http_json(port, "/metrics")
                   for pid, port in enumerate(ports)}
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        ended = []
        for p in procs:
            try:
                ended.append(p.wait(timeout=30))
            except subprocess.TimeoutExpired:
                p.kill()
                ended.append(f"killed: {p.wait()}")
    if res["audio_packets"] < 3 or res["waterfall_packets"] < 2 \
            or any(m["device_errors"] for m in metrics.values()) \
            or not all(isinstance(rc, int) for rc in ended):
        raise AssertionError(f"multihost_server: {res}, {metrics}, "
                             f"exits {ended}\n{logs()}")
    backend = [ln for ln in logs().splitlines()
               if ln.startswith("multihost: process")]
    shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "multihost_server", "processes": MH_PROCESSES,
          "follower_port_clients": res, "bootstrap": backend,
          "exit_codes_after_sigterm": ended,
          "metrics": {pid: {k: m[k] for k in
                            ("frames", "idle_frames", "step_ms_p50",
                             "device_errors", "eof")}
                      for pid, m in metrics.items()}})


# ------------------------------------------- the entry points and tools

REPO = Path(__file__).resolve().parent
ENTRY_STEPS = 10    # the example step, then 9 seeded blocks


def phase_entry(kernels) -> dict:
    """``entry.entry()`` on cuda:0 stepped ENTRY_STEPS times (the
    example arguments, then seeded blocks of a tone and noise) against
    ``entry(device="cpu")`` on the same inputs, with the small phase's
    tolerances; then ``entry.dryrun_multichip(4)`` as 4 shards on this
    card.  Returns the kernels' launches in the card's steps."""
    import torch

    from phantomsdr_tpu_torch.entry import dryrun_multichip, entry, small_cfg

    cfg = small_cfg()
    n = (cfg.hop_batch + 1) * cfg.hop_size * 2
    rng = np.random.default_rng(SEED)
    t = np.arange(n)
    seeded = [(rng.integers(-3000, 3000, n)
               + 8000 * np.sin(0.13 * (t + s * n))).astype(np.int16)
              for s in range(ENTRY_STEPS - 1)]
    got = {}
    launches = {}
    for dev in ("cuda", "cpu"):
        fn, (state, raw, table, views, reset, due) = entry(device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
        outs = []
        # the example block, then seeded blocks past the AGC's 200 ms
        # look-ahead (5 steps), so that the audio is not silence
        for blk in [raw] + [torch.from_numpy(x).to(dev) for x in seeded]:
            state, out = fn(state, blk, table, views, reset, due)
            outs.append((out.audio.cpu().numpy().astype(int),
                         out.avg_power.cpu().numpy(),
                         out.wf.cpu().numpy().astype(int)))
        if dev == "cuda":
            launches = {k.name: k.launches for k in kernels}
        got[dev] = outs
    a_err = max(int(np.abs(c[0] - p[0]).max())
                for c, p in zip(got["cuda"], got["cpu"]))
    p_rel = max(float(np.max(np.abs(c[1] - p[1])
                             / np.maximum(np.abs(p[1]), 1e-30)))
                for c, p in zip(got["cuda"], got["cpu"]) if p[1].any())
    w_err = max(int(np.abs(c[2] - p[2]).max())
                for c, p in zip(got["cuda"], got["cpu"]))
    peak = int(max(np.abs(p[0]).max() for p in got["cpu"]))
    if a_err > 4 or peak < 1000 or p_rel > 2e-4 or w_err > 1 \
            or min(launches.values()) <= 0:
        raise AssertionError(f"entry: card vs CPU audio {a_err} (peak "
                             f"{peak}), power "
                             f"rtol {p_rel}, waterfall {w_err}, launches "
                             f"{launches}")
    d = dryrun_multichip(4, devices=["cuda:0"] * 4)
    emit({"phase": "entry", "steps": ENTRY_STEPS,
          "audio_max_abs_int16": a_err, "audio_peak_int16": peak,
          "power_max_rel": p_rel, "waterfall_max_steps": w_err,
          "launches": launches,
          "dryrun_multichip": {
              "devices": ["cuda:0"] * 4,
              "audio_shapes": [list(a.shape) for a in d.outputs[1].audio],
              "wf_rows": [int(w.shape[0]) for w in d.outputs[1].wf]}})
    return launches


# each kernel of a stage, launched inside it (tools/torch_profile.py)
PROFILE_STAGE_KERNELS = {
    "waterfall_pyramid": ("waterfall",), "channelizer_demod": ("pll",),
    "dc_agc": ("agc",), "stereo_decode": ("pilot",), "nr_spectral": ("nr",),
    "nr_lms": ("anr",), "nb_blanker": ("nb_lpc", "nb_repair"),
    "rds_downmix": ("pilot",), "stereo_plus_rds_shared": ("pilot",)}


def phase_profile() -> dict:
    """tools/torch_profile.py's stage table at the bench config (2^20,
    36 hops, 128 channels) with the opt-in stages; the stages' sum and
    the step must be finite and positive and each stage must launch its
    kernels.  Returns the launches of every kernel over the stages."""
    import argparse

    from tools.torch_profile import MAIN_STAGES, OPTIN_STAGES, profile

    p = profile(argparse.Namespace(
        fft_log2=20, hops=BENCH_CFG["tpu"]["hop_batch"],
        channels=BENCH_CFG["tpu"]["max_channels"], kbig=32, device="cuda",
        optin=True, mesh=0, devices=None))
    total = sum(p["stages_ms"][k] for k in MAIN_STAGES)
    missing = [(stage, k) for stage, ks in PROFILE_STAGE_KERNELS.items()
               for k in ks if p["launches_by_stage"][stage].get(k, 0) <= 0]
    if not (math.isfinite(total) and total > 0
            and math.isfinite(p["step_ms_e2e_p50"])
            and p["step_ms_e2e_p50"] > 0 and p["step_device_ms"] > 0
            and all(p["optin_stages_ms"][k] > 0 for k in OPTIN_STAGES)) \
            or missing:
        raise AssertionError(f"profile: stages {p['stages_ms']}, step "
                             f"{p['step_ms_e2e_p50']}, not launched in "
                             f"their stage: {missing}")
    emit({"phase": "profile", **{k: p[k] for k in (
        "config", "method", "stages_ms", "substages_ms",
        "outside_stages_ms", "stages_issue_ms", "optin_stages_ms",
        "optin_stages_issue_ms", "launches_by_stage", "step_launches",
        "step_ms_e2e_p50", "step_device_ms", "step_issue_ms",
        "step_split_ms", "views_step_device_ms", "views_due_rows",
        "device_compute_ms_total",
        "stages_and_outside_ms", "stages_and_outside_over_step_device",
        "device_msps_ceiling", "fft_sol")}})
    out = {}
    for per in p["launches_by_stage"].values():
        for k, n in per.items():
            out[k] = out.get(k, 0) + n
    return out


def metrics_launches(port: int) -> dict:
    return http_json(port, "/metrics")["kernel_launches"]


def phase_verify_tone() -> dict:
    """.claude/skills/verify/SKILL.md recipe 1 on the card: captures.py's
    tone capture, ``python -m phantomsdr_tpu_torch --device cuda`` on a
    free port (killed by PID), then tools/verify/client.py's tone check
    for 8 s through tools/torch_clients.tone_check.  client.py itself is
    not run here: its FLAC decoder (tests/test_codecs.py) imports the
    JAX package, and without python-zstandard (absent here) it counts
    the waterfall rows without checking their peak; tone_check decodes
    through the port's codecs (the system libzstd, a copy of the
    from-spec FLAC decoder) and checks both.  The tone's Hz, the
    waterfall rows on the carrier, and the CLI's kernel launches during
    the check (its /metrics).  Returns those launches."""
    import shutil

    from tools.torch_clients import tone_check

    workdir = REPO / "build" / "verify_tone"
    shutil.rmtree(workdir, ignore_errors=True)
    port = free_ports(1)[0]
    subprocess.run([sys.executable, "tools/verify/captures.py", "--variant",
                    "tone", "--out", str(workdir), "--port", str(port)],
                   check=True, cwd=REPO, capture_output=True, timeout=120)
    truth = json.loads((workdir / "truth.json").read_text())
    log = open(workdir / "server.log", "wb")
    srv = subprocess.Popen(
        [sys.executable, "-m", "phantomsdr_tpu_torch", "-c",
         str(workdir / "config.toml"), "--input-file",
         str(workdir / "capture.s16"), "--loop", "--throttle", "--device",
         "cuda"], stdout=log, stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL, cwd=REPO)
    try:
        deadline = time.monotonic() + 240
        while True:
            try:
                if http_json(port, "/metrics")["frames"] > 0:
                    break
            except OSError:
                pass
            if srv.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("verify_tone: the CLI never served\n"
                                     + (workdir / "server.log").read_text(
                                         errors="replace")[-3000:])
            time.sleep(0.5)
        before = metrics_launches(port)
        res = asyncio.run(tone_check(f"http://127.0.0.1:{port}", truth,
                                     8.0))
        after = http_json(port, "/metrics")
    finally:
        srv.terminate()
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
        log.close()
    launches = {k: n - before.get(k, 0)
                for k, n in after["kernel_launches"].items()}
    if after["device_errors"] or min(launches[k] for k in
                                     ("waterfall", "pll", "agc")) <= 0:
        raise AssertionError(f"verify_tone: device errors "
                             f"{after['device_errors']}, launches "
                             f"{launches}")
    shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "verify_tone", "tone_hz": res["tone"]["f_peak_hz"],
          "want_hz": truth["tone_hz"], **res, "launches": launches,
          "server_step_ms_p50": after["step_ms_p50"],
          "device_errors": after["device_errors"]})
    return launches


# tools/verify's variant checks through the CLI: (run, variant, audio
# compression, the client's --secs, the kernels the config turns on).
# --secs: client.py's 8 s default, the RDS recipes' 25 s (PS and RT
# fill over 1.75 s group cycles, resynced at each loop of the 6 s
# capture), the card's 20 s for the noise processors (SKILL.md 1c).
# Not run: ``both`` over Opus, as the card's machine has no libopus.so.0
# (the server's OpusChunkEncoder cannot load it), and ``nb``, whose bar
# lies inside the blanker's threshold flips (F1)
VERIFY_RUNS = (
    ("am", "am", "flac", 8.0, ("pll", "agc")),
    ("stereo", "stereo", "flac", 8.0, ("pilot", "agc_float")),
    ("rds", "rds", "flac", 25.0, ("pilot", "agc_float")),
    ("both", "both", "flac", 25.0, ("pilot", "agc_float")),
    ("de", "de", "flac", 8.0, ("deemph", "agc_float")),
    ("soak", "soak", "flac", 25.0, ("pilot", "agc_float", "deemph")),
    ("nr", "nr", "flac", 20.0, ("pll", "agc_float", "nr")),
    ("lms", "lms", "flac", 20.0, ("pll", "agc_float", "anr")),
)
VERIFY_PARALLEL = 3     # servers on the card at a time
VERIFY_PORTS: set = set()
VERIFY_PORTS_LOCK = threading.Lock()


def verify_run(run: str, variant: str, comp: str, secs: float,
               need: tuple) -> dict:
    """One run of the verify_variants phase: the capture into
    build/verify_<run>/, the CLI on a port taken just before it starts
    (so no earlier run's client sockets can have taken it) until
    /metrics counts frames, then ``tools/torch_verify.py check`` with the kernels'
    launches read before and after.  Raises on a miss, a time-out, a
    server that exits early, a device error or a kernel of ``need`` not
    launched; the directory, with its server.log, stays on a failure."""
    import shutil

    from tools.torch_verify import BARS, make

    workdir = REPO / "build" / f"verify_{run}"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.monotonic()
    with VERIFY_PORTS_LOCK:     # a port no other run of the phase holds
        port = free_ports(1)[0]
        while port in VERIFY_PORTS:
            port = free_ports(1)[0]
        VERIFY_PORTS.add(port)
    make(variant, workdir, port, 6.0, audio_compression=comp)

    def fail(what: str):
        return AssertionError(
            f"verify_variants {run}: {what}\n" + (
                workdir / "server.log").read_text(errors="replace")[-3000:])

    log = open(workdir / "server.log", "wb")
    srv = subprocess.Popen(
        [sys.executable, "-m", "phantomsdr_tpu_torch", "-c",
         str(workdir / "config.toml"), "--input-file",
         str(workdir / "capture.s16"), "--loop", "--throttle", "--device",
         "cuda"], stdout=log, stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL, cwd=REPO)
    try:
        deadline = time.monotonic() + 240
        while True:
            try:
                if http_json(port, "/metrics")["frames"] > 0:
                    break
            except OSError:
                pass
            if srv.poll() is not None or time.monotonic() > deadline:
                raise fail("the CLI never served")
            time.sleep(0.5)
        t_serving = time.monotonic() - t0
        before = metrics_launches(port)
        chk = subprocess.run(
            [sys.executable, "tools/torch_verify.py", "check", "--dir",
             str(workdir), "--secs", str(secs)], capture_output=True,
            text=True, cwd=REPO, timeout=4 * secs + 300)
        after = http_json(port, "/metrics")
        stat = proc_stat(srv.pid)
        if srv.poll() is not None:
            raise fail(f"the CLI exited {srv.returncode} during the check")
    finally:
        srv.terminate()
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
        log.close()
    if chk.returncode != 0:
        raise fail(f"check exited {chk.returncode}\n{chk.stdout[-2000:]}"
                   f"{chk.stderr[-3000:]}")
    res = json.loads(chk.stdout.strip().splitlines()[-1])
    launches = {k: n - before.get(k, 0)
                for k, n in after["kernel_launches"].items()}
    if after["device_errors"] or not res["pass"] \
            or min(launches[k] for k in need) <= 0:
        raise fail(f"device errors {after['device_errors']} "
                   f"({after.get('last_device_error')}), launches "
                   f"{launches}, need {need}, result {res}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"phase": "verify_variants", "run": run, "variant": variant,
            "audio_compression": comp, "secs": secs,
            "figures": {k: v for k, v in res.items()
                        if k not in ("variant", "pass")},
            "bars": BARS[variant], "pass": res["pass"],
            "launched": sorted(k for k, n in launches.items() if n > 0),
            "need": list(need), "launches": launches,
            "server_step_ms_p50": after["step_ms_p50"],
            "server_rss_kb": stat["rss_kb"],
            "device_errors": after["device_errors"],
            "seconds_to_serve": t_serving,
            "seconds": time.monotonic() - t0}


def phase_verify_variants() -> dict:
    """VERIFY_RUNS through verify_run, VERIFY_PARALLEL at a time (each
    run's client decodes its stream in a process of its own), one line
    each in VERIFY_RUNS' order; any failed run fails the phase after
    every run has ended.  Returns each run's launches as
    {"verify <run>": launches}."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.monotonic()
    with ThreadPoolExecutor(VERIFY_PARALLEL) as pool:
        futs = [pool.submit(verify_run, *r) for r in VERIFY_RUNS]
    failed = []
    out = {}
    for r, f in zip(VERIFY_RUNS, futs):
        try:
            row = f.result()
        except Exception as e:      # reported, and the phase fails below
            failed.append(f"{r[0]}: {e!r}")
            continue
        emit(row)
        out[f"verify {r[0]}"] = row["launches"]
    emit({"phase": "verify_variants", "runs": len(VERIFY_RUNS),
          "failed": len(failed), "seconds": time.monotonic() - t0})
    if failed:
        raise AssertionError("verify_variants:\n" + "\n\n".join(failed))
    return out


def phase_soak_smoke() -> dict:
    """tools/torch_soak.py for 60 s on the card with tests/test_soak.py's
    loosened bars (no hourly RSS budget, latency within 4x): at least
    100 audio and 100 waterfall packets, no device, client or decode
    error, and the CLI's launches of the main path's kernels.  Returns
    those launches."""
    import shutil

    workdir = REPO / "build" / "soak_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    res = subprocess.run(
        [sys.executable, "tools/torch_soak.py", "--secs", "60",
         "--sample-secs", "10", "--audio", "6", "--wf", "3", "--churn",
         "20", "--rss-budget-pct", "1e9", "--lat-factor", "4", "--dir",
         str(workdir)], capture_output=True, text=True, cwd=REPO,
        timeout=400)
    try:
        v = json.loads(res.stdout)
    except ValueError:
        v = None
    launches = (v or {}).get("kernel_launches") or {}
    if res.returncode != 0 or not v or not v["pass"] \
            or v["audio_pkts"] < 100 or v["wf_pkts"] < 100 \
            or v["client_errors"] or v["decode_errors"] \
            or v["device_errors"] \
            or min(launches.get(k, 0) for k in ("waterfall", "pll",
                                                "agc")) <= 0:
        raise AssertionError(f"soak_smoke: rc {res.returncode}\n"
                             f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
    shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "soak_smoke", **v})
    return launches


# --------------------------------- the north-star deployment, served

BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]


def phase_bench() -> dict:
    """``python -m phantomsdr_tpu_torch.bench --profile iq``, then
    ``--profile real``, as subprocesses in build/bench/ at bench.py's
    window lengths: each last stdout line must parse with bench.py's
    four keys and a value > 0, and each details file must show K-WF,
    K-PLL and K-AGC launched in the timed windows.  Returns the timed
    windows' launches by path ("bench iq", "bench real")."""
    import os
    import shutil

    from phantomsdr_tpu_torch.bench import DETAILS

    workdir = REPO / "build" / "bench"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = {}
    for profile in ("iq", "real"):
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, "-m", "phantomsdr_tpu_torch.bench",
             "--profile", profile], capture_output=True, text=True,
            cwd=workdir, env=env, timeout=300)
        if res.returncode:
            raise AssertionError(f"bench {profile}: rc {res.returncode}\n"
                                 f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        det = json.loads((workdir / DETAILS[profile]).read_text())
        emit({"phase": "bench", "profile": profile, **line,
              **{k: det[k] for k in ("windows_msps", "ingest_msps",
                                     "ingest_msps_windows", "step_ms",
                                     "hop_batch", "channels", "card",
                                     "launches", "ingest_launches")},
              "stderr": [x for x in res.stderr.splitlines()
                         if x.startswith("#")],
              "seconds": time.monotonic() - t0})
        if list(line) != BENCH_KEYS or not line["value"] > 0:
            raise AssertionError(f"bench {profile}: last line {line}")
        if min(det["launches"][k] for k in ("waterfall", "pll", "agc")) <= 0:
            raise AssertionError(f"bench {profile}: a kernel was not "
                                 f"launched: {det['launches']}")
        out[f"bench {profile}"] = det["launches"]
    return out


def phase_ingest() -> dict:
    """tools/torch_ingest_bench.py on the card at the bench config's
    block (36 hops of 2^19 IQ pairs, u8): the read, upload and overlap
    legs and the upload's split.  The overlap leg must sustain 35 MSPS
    (its meets_target)."""
    out = REPO / "build" / "ingest" / "INGEST_torch.json"
    res = subprocess.run(
        [sys.executable, "tools/torch_ingest_bench.py", "--hop-batch",
         str(BENCH_CFG["tpu"]["hop_batch"]), "--out", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    if res.returncode:
        raise AssertionError(f"ingest: rc {res.returncode}\n"
                             f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
    v = json.loads(out.read_text())
    emit({"phase": "ingest", **v})
    if not v["meets_target"]:
        raise AssertionError(f"ingest: the overlap leg at "
                             f"{v['overlap']['msps']} MSPS, under 35")
    return v


SERVE_SECS = 60             # the stress window
SERVE_WARM_SECS = 10        # the feed's warm-up before the window
SERVE_STRESS = ["--audio", "100", "--wf", "28", "--churn", "45",
                "--wf-deflate-frac", "0.5", "--decode-every", "10"]
SERVE_SETTLE_SECS = 2.0     # steady listeners' audio skipped (the AGC)


def proc_stat(pid: int) -> dict:
    """The process's CPU seconds (user + system), threads and RSS."""
    import os

    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    tick = os.sysconf("SC_CLK_TCK")
    with open(f"/proc/{pid}/status") as f:
        rss = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    return {"cpu_s": (int(fields[11]) + int(fields[12])) / tick,
            "threads": int(fields[17]), "rss_kb": rss}


async def steady_listener(session, url: str, tune, mode: str | None, stop,
                          rec):
    """One listener from its session's start: tuned to ``tune(info)``
    ((l, r, m) from the server's basic_info) in ``mode``, or left on the
    server's default window and mode where ``tune`` gives None; every
    audio payload with its arrival time into ``rec``."""
    import aiohttp

    from tools.torch_clients import cbor_decode

    async with session.ws_connect(url + "/audio",
                                  max_msg_size=1 << 22) as ws:
        info = json.loads((await ws.receive(timeout=60)).data)
        chan = rec["window"] = tune(info)
        if chan is not None:
            l, r, m = chan
            await ws.send_str(json.dumps({"cmd": "window", "l": int(l),
                                          "m": float(m), "r": int(r)}))
            await ws.send_str(json.dumps({"cmd": "demodulation",
                                          "demodulation": mode}))
        while not stop.is_set():
            try:
                msg = await ws.receive(timeout=1)
            except asyncio.TimeoutError:
                continue
            if msg.type == aiohttp.WSMsgType.BINARY:
                rec["pkts"].append((time.monotonic(),
                                    bytes(cbor_decode(msg.data)["data"])))
            elif msg.type != aiohttp.WSMsgType.TEXT:
                rec["closed"] = True
                return


async def steady_waterfall(session, url: str, tune, width: int, stop,
                           rec):
    """One waterfall client on [l, l + width) at full resolution, l =
    ``tune(info)`` from the server's basic_info: each row's decoded bytes
    with its labelled l into ``rec``."""
    import aiohttp

    from phantomsdr_tpu_torch.runtime.codecs import ZstdDecompressStream
    from tools.torch_clients import cbor_decode

    dec = ZstdDecompressStream()
    async with session.ws_connect(url + "/waterfall",
                                  max_msg_size=1 << 22) as ws:
        info = json.loads((await ws.receive(timeout=60)).data)
        l = rec["l"] = int(tune(info))
        await ws.send_str(json.dumps({"cmd": "window", "l": l,
                                      "r": l + width}))
        while not stop.is_set():
            try:
                msg = await ws.receive(timeout=1)
            except asyncio.TimeoutError:
                continue
            if msg.type == aiohttp.WSMsgType.BINARY:
                pkt = cbor_decode(dec.decompress(msg.data))
                rec["rows"].append((pkt["l"], pkt["r"], np.frombuffer(
                    bytes(pkt["data"]), np.int8)))
            elif msg.type != aiohttp.WSMsgType.TEXT:
                rec["closed"] = True
                return


def flac_samples(payloads: list[bytes]) -> np.ndarray:
    from tools.torch_clients import decode_flac

    return decode_flac(b"".join(payloads))[1]


class Steady(NamedTuple):
    """A steady listener of a served deployment: ``tune(basic_info)``
    gives its (l, r, m), or None for the default window and mode; its
    audio must carry ``want_hz``."""

    name: str
    mode: str | None
    tune: object
    want_hz: float


async def serve_window(port: int, feeder, srv, steady, wf_tune,
                       wf_width: int, secs: float) -> dict:
    """The clients of a served deployment against the server at
    ``port``: the ``steady`` listeners and the waterfall client on
    ``wf_tune(basic_info)``, ``wf_width`` bins wide, then
    tools/torch_stress.py in its own process for ``secs``; /metrics,
    the feeder and the server process read at the window's start and
    end."""
    import concurrent.futures
    import multiprocessing

    import aiohttp

    from tools.torch_clients import loop_lag, percentile
    from tools.torch_soak import device_mem_mb

    url = f"http://127.0.0.1:{port}"
    stop = asyncio.Event()
    lags: list[float] = []
    recs = [{"pkts": [], "closed": False} for _ in steady]
    wf_rec = {"rows": [], "closed": False}
    samples = []
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as s:

        async def metrics():
            async with s.get(url + "/metrics") as r:
                return await r.json()

        tasks = [asyncio.create_task(loop_lag(stop, lags))]
        tasks += [asyncio.create_task(steady_listener(
            s, url, st.tune, st.mode, stop, rec))
            for st, rec in zip(steady, recs)]
        tasks.append(asyncio.create_task(steady_waterfall(
            s, url, wf_tune, wf_width, stop, wf_rec)))
        t_feed = time.monotonic()
        await asyncio.sleep(SERVE_WARM_SECS - 2)
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "tools/torch_stress.py", "--url",
            f"ws://127.0.0.1:{port}", "--secs", str(secs),
            *SERVE_STRESS, cwd=REPO, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE)
        stress_err = []
        while True:      # the stress clients' window starts here
            line = await asyncio.wait_for(proc.stderr.readline(), 120)
            if not line or b"clients started" in line:
                break
            stress_err.append(line.decode(errors="replace"))
        await asyncio.sleep(max(t_feed + SERVE_WARM_SECS
                                - time.monotonic(), 0))
        feeder.mark()
        t0 = time.monotonic()
        m0, p0 = await metrics(), proc_stat(srv.pid)
        while time.monotonic() - t0 < secs - 0.5:
            await asyncio.sleep(min(5.0, secs - 0.5
                                    - (time.monotonic() - t0)))
            samples.append(await metrics())
        m1, p1 = await metrics(), proc_stat(srv.pid)
        t1 = time.monotonic()
        fed = feeder.stats()
        dev_mb, dev_read = device_mem_mb(srv.pid)
        stop.set()
        out, err = await asyncio.wait_for(proc.communicate(), 240)
        await asyncio.gather(*tasks, return_exceptions=True)
        errors = [repr(t.exception()) for t in tasks
                  if t.done() and not t.cancelled() and t.exception()]
    try:
        res = json.loads(out)
    except ValueError:
        raise AssertionError(f"serve: torch_stress rc "
                             f"{proc.returncode}\n{out[-3000:]!r}\n"
                             f"{''.join(stress_err)}{err[-3000:]!r}")
    # each steady stream decoded from its session's start, in parallel
    with concurrent.futures.ProcessPoolExecutor(
            len(recs), mp_context=multiprocessing.get_context("spawn")) \
            as pool:
        futs = [pool.submit(flac_samples, [p for _, p in rec["pkts"]])
                for rec in recs]
        decoded = []
        for f in futs:
            try:
                decoded.append(f.result(timeout=240))
            except ValueError as e:
                decoded.append(e)
    return {"m0": m0, "m1": m1, "p0": p0, "p1": p1, "t0": t0, "t1": t1,
            "fed": fed, "samples": samples, "stress": res,
            "stress_rc": proc.returncode, "recs": recs, "wf": wf_rec,
            "decoded": decoded, "client_errors": errors,
            "device_mem_mb": dev_mb, "device_mem_read": dev_read,
            "loop_lag_ms": {"p50": percentile(lags, 0.5),
                            "max": max(lags, default=None)}}


def serve_cli(name: str, config_text: str, cfg, tones, pool: bytes,
              steady: list[Steady], wf_tune, secs: float,
              feed_mbps_bar: float, lag_bar_ms: float) -> dict:
    """A deployment through the CLI on the card: ``python -m
    phantomsdr_tpu_torch --device cuda`` on ``config_text`` (written to
    build/<name>/config.toml; a free port in its [server] table, the
    wire read from stdin) fed at the config's wire rate by a PipeFeeder
    from ``pool`` (whole blocks of ``tones``), served to serve_window's
    clients for ``secs``.  It must hold: the feed at >= ``feed_mbps_bar``
    MB/s with its longest lag under ``lag_bar_ms``, the config's rate
    within 2% from /metrics over the window, no device error, no
    dropped encode, a dispatch p99 under a block's real time, no client
    or decode error, each steady listener at >= 0.95 of the packet rate
    the step cadence implies with its tone at its Hz within 3 Hz (rms >=
    100), the waterfall peak on the USB carrier in every row, and K-WF,
    K-PLL and K-AGC launched in the window.  Emits the phase line (the
    server's CPU seconds a second, threads, RSS, device memory, step
    time, device-busy share and encode queue depth beside the bars) and
    returns the kernels' launches in the window."""
    import inspect
    import shutil

    from phantomsdr_tpu_torch.ops.convert import wire_dtype
    from phantomsdr_tpu_torch.runtime.codecs import FlacEncoder
    from tools.torch_clients import PipeFeeder

    workdir = REPO / "build" / name
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    (workdir / "config.toml").write_text(config_text)
    port = cfg.port
    wire_rate = (cfg.sps * (1 if cfg.is_real else 2)
                 * wire_dtype(cfg.input_format).itemsize)
    log = open(workdir / "server.log", "wb")
    t_start = time.monotonic()
    srv = subprocess.Popen(
        [sys.executable, "-m", "phantomsdr_tpu_torch", "-c",
         str(workdir / "config.toml"), "--device", "cuda"],
        stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT,
        cwd=REPO)
    feeder = PipeFeeder(srv.stdin, pool, wire_rate).start()
    try:
        deadline = time.monotonic() + 240
        while True:
            try:
                if http_json(port, "/metrics")["frames"] > 0:
                    break
            except OSError:
                pass
            if srv.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"{name}: the CLI never served\n" + (
                        workdir / "server.log").read_text(
                        errors="replace")[-3000:])
            time.sleep(0.25)
        t_serving = time.monotonic() - t_start
        feeder.mark()           # no catch-up burst for the start's lag
        w = asyncio.run(serve_window(port, feeder, srv, steady, wf_tune,
                                     cfg.waterfall_size, secs))
    finally:
        feeder.stop()
        srv.stdin.close()       # EOF: the reader thread ends
        srv.terminate()
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
        log.close()

    m0, m1, wall = w["m0"], w["m1"], w["t1"] - w["t0"]
    steps_s = cfg.sps / (cfg.hop_batch * cfg.hop_size)
    per_step = cfg.hop_batch * cfg.audio_fft_size // 2
    blocksize = inspect.signature(FlacEncoder).parameters[
        "blocksize"].default
    want_pkts = steps_s * per_step / blocksize   # one packet a FLAC frame
    msps = ((m1["samples_in"] - m0["samples_in"])
            / (m1["elapsed_s"] - m0["elapsed_s"]) / 1e6)
    steps = (m1["frames"] - m0["frames"]) / cfg.hop_batch
    launches = {k: n - m0["kernel_launches"].get(k, 0)
                for k, n in m1["kernel_launches"].items()}
    failed = []
    fed = w["fed"]
    if fed["mbps"] < feed_mbps_bar or fed["error"]:
        failed.append(f"feeder at {fed['mbps']:.3f} MB/s ({fed['error']})")
    if fed["max_lag_ms"] >= lag_bar_ms:
        failed.append(f"feeder lag {fed['max_lag_ms']:.1f} ms")
    if abs(msps - cfg.sps / 1e6) > 0.02 * cfg.sps / 1e6:
        failed.append(f"sustained {msps:.4f} MSPS")
    if m1["device_errors"] or m1["encode_dropped"]:
        failed.append(f"device errors {m1['device_errors']} "
                      f"({m1['last_device_error']}), encode dropped "
                      f"{m1['encode_dropped']}")
    if m1.get("dispatch_ms_p99", 0) >= 1e3 / steps_s:
        failed.append(f"dispatch p99 {m1['dispatch_ms_p99']} ms")
    st = w["stress"]
    if st["errors"] or st["decode_errors"] or w["client_errors"] \
            or w["stress_rc"] or st["decoded_audio_samples"] <= 0 \
            or st["decoded_wf_rows"] <= 0:
        failed.append(f"clients: stress rc {w['stress_rc']}, errors "
                      f"{st['errors']}, decode errors "
                      f"{st['decode_errors']} ({st.get('last_error')}), "
                      f"decoded {st['decoded_audio_samples']} samples "
                      f"{st['decoded_wf_rows']} rows, steady "
                      f"{w['client_errors']}")
    tones_out = {}
    rate = tones.audio_rate     # the stream's true rate (basic_info: 12000)
    for lis, rec, x in zip(steady, w["recs"], w["decoded"]):
        n_win = sum(w["t0"] <= t <= w["t1"] for t, _ in rec["pkts"])
        pkts_s = n_win / wall
        row = {"pkts_per_s": pkts_s, "want_pkts_per_s": want_pkts,
               "closed": rec["closed"], "window": rec.get("window")}
        if isinstance(x, Exception):
            row["decode_error"] = repr(x)
            failed.append(f"{lis.name}: FLAC stream {x!r}")
        else:
            a = x.astype(np.float64)[int(SERVE_SETTLE_SECS * rate):]
            row.update(want_hz=lis.want_hz,
                       got_hz=peak_hz(a, rate) if a.size else None,
                       rms=float(np.sqrt(np.mean(a ** 2))) if a.size
                       else 0.0, samples=int(x.size))
            if row["got_hz"] is None \
                    or abs(row["got_hz"] - row["want_hz"]) > 3.0 \
                    or row["rms"] < 100:
                failed.append(f"{lis.name} tone {row}")
        if pkts_s < 0.95 * want_pkts or rec["closed"]:
            failed.append(f"{lis.name}: {pkts_s:.3f} packets/s of "
                          f"{want_pkts:.3f}")
        tones_out[lis.name] = row
    wl = w["wf"].get("l")
    rows = [r for l, _, r in w["wf"]["rows"] if l == wl and r.size]
    cents = sorted({max_run_centroid(r) for r in rows})
    wf_ok = sum(abs(max_run_centroid(r) - 500) <= 1 for r in rows)
    if not rows or wf_ok < len(rows) or w["wf"]["closed"]:
        failed.append(f"waterfall: {wf_ok}/{len(rows)} rows on the "
                      f"carrier, centroids {cents[:8]}")
    if min(launches.get(k, 0) for k in ("waterfall", "pll", "agc")) <= 0:
        failed.append(f"kernel launches {launches}")
    cpu = (w["p1"]["cpu_s"] - w["p0"]["cpu_s"]) / wall
    depth = [m.get("encode_queue_depth", 0) for m in w["samples"] + [m1]]
    r = {
        "config": {"sps": cfg.sps, "fft_size": cfg.fft_size,
                   "signal": "real" if cfg.is_real else "iq",
                   "hop_batch": cfg.hop_batch,
                   "max_channels": cfg.max_channels,
                   "audio_sps": cfg.audio_sps,
                   "waterfall_size": cfg.waterfall_size,
                   "format": cfg.input_format, "skip_num": cfg.skip_num,
                   "levels": cfg.downsample_levels,
                   "threads": cfg.threads},
        "seconds_to_serve": t_serving,
        "window_s": wall, "feeder": fed,
        "wire_mbps_target": wire_rate / 1e6,
        "feed_mbps_bar": feed_mbps_bar, "lag_bar_ms": lag_bar_ms,
        "block_ms": 1e3 / steps_s,
        "msps_window": msps, "msps_sustained": m1["msps_sustained"],
        "msps_device": m1["msps_device"],
        "step_ms_p50": m1["step_ms_p50"], "steps": steps,
        "device_busy_share": m1["step_ms_p50"] * 1e-3 * steps / wall,
        "dispatch_ms_p50": m1.get("dispatch_ms_p50"),
        "dispatch_ms_p99": m1.get("dispatch_ms_p99"),
        "device_errors": m1["device_errors"],
        "encode_dropped": m1["encode_dropped"],
        "encode_dropped_by_sample": [m0["encode_dropped"]] + [
            m["encode_dropped"] for m in w["samples"] + [m1]],
        "encode_queue_depth": {"end": m1["encode_queue_depth"],
                               "max": max(depth), "samples": depth},
        "audio_clients_end": m1["audio_clients"],
        "waterfall_clients_end": m1["waterfall_clients"],
        "server_cpu_s_per_s": cpu, "server_threads": w["p1"]["threads"],
        "server_rss_mb": w["p1"]["rss_kb"] / 1024,
        "device_mem_mb": w["device_mem_mb"],
        "device_mem_read": w["device_mem_read"],
        "audio_MBps": st["audio_MBps"], "wf_MBps": st["wf_MBps"],
        "stress": {k: v for k, v in st.items() if k != "server_metrics"},
        "smoke_loop_lag_ms": w["loop_lag_ms"],
        "steady": tones_out,
        "waterfall": {"l": wl, "rows": len(rows), "on_carrier": wf_ok,
                      "centroids": cents[:8]},
        "launches": launches, "failed": failed}
    emit({"phase": name, **r})
    if failed:
        raise AssertionError(f"{name}: {failed}")
    return launches


def phase_serve_full(tones, pool: bytes) -> dict:
    """The north-star deployment through the CLI on the card: the bench
    config (u8 IQ at 35 MSPS, 2^20-point FFT, 36 hops a step, 128
    channels, 12 kHz FLAC audio, zstd waterfall 1024) fed at 70 MB/s
    from ``pool`` (4 blocks of ``tones``), served for SERVE_SECS to
    tools/torch_stress.py's 100 churning audio and 28 waterfall clients
    (half on deflate, every 10th decoding) and beside them a steady
    listener on each tone (USB, LSB, AM with the PLL, FM) and a
    waterfall client on the USB carrier; serve_cli's bars, the feed at
    >= 69 MB/s with no lag of a block (539 ms).  Returns the kernels'
    launches in the window."""
    from phantomsdr_tpu_torch.config import config_from_dict

    port = free_ports(1)[0]
    conf = {"server": {"port": port}, **BENCH_CFG,
            "input": {**BENCH_CFG["input"], "audio_compression": "flac",
                      "waterfall_compression": "zstd",
                      "driver": {"name": "stdin", "format": "u8"}}}
    cfg = config_from_dict(conf)
    steady = [Steady(name, name, lambda info, c=chan: c,
                     tones.tone_bins[i] * tones.df)
              for i, (name, chan) in enumerate(zip(MODE_NAMES,
                                                   tones.chans))]
    block_ms = 1e3 * cfg.hop_batch * cfg.hop_size / cfg.sps
    return serve_cli("serve_full", toml_text(conf), cfg, tones, pool,
                     steady, lambda info: tones.usb_bin - 500, SERVE_SECS,
                     feed_mbps_bar=2 * cfg.sps / 1e6 * 69 / 70,
                     lag_bar_ms=block_ms)


RX888_SECS = 30             # serve_rx888's stress window


def phase_serve_rx888(tones, pool: bytes) -> dict:
    """The RX888 deployment the repository ships through the CLI on the
    card: configs/config.example.rx888.toml as shipped (s16 real at 70
    MSPS, 2^20-point FFT, 12 hops a step, 128 channels, waterfall 2048,
    the LSB default at 7.1 MHz), copied to build/serve_rx888/ only to set
    a free port, read from stdin and fed at 140 MB/s from ``pool`` (4
    blocks of ``tones``, RealTones); for RX888_SECS tools/torch_stress.py's
    100 churning audio and 28 waterfall clients, beside them one steady
    listener per tone tuned by the real-input mapping
    (tools/torch_clients.hz_to_bin on basic_info), one on the default
    LSB window, which holds the LSB tone, and a waterfall client on the
    USB carrier.  serve_cli's bars with serve_full's numbers taken over:
    the feed at >= 138.6 MB/s (99%) with its longest lag under 539 ms,
    70 MSPS within 2%, the dispatch p99 under one block (89.9 ms).
    Returns the kernels' launches in the window."""
    import re

    from phantomsdr_tpu_torch.config import load_config
    from tools.torch_clients import hz_to_bin, hz_to_bins

    shipped = (REPO / "configs" / "config.example.rx888.toml").read_text()
    port = free_ports(1)[0]
    text, k = re.subn(r"(?m)^port\s*=\s*\d+$", f"port={port}", shipped)
    if k != 1:
        raise AssertionError("serve_rx888: no [server] port line")
    cfg = load_config(str(REPO / "configs" / "config.example.rx888.toml"))
    cfg.port = port

    def tuned(mode: str, f_hz: float):
        def tune(info):
            m = hz_to_bin(info, f_hz)
            if mode == "USB":
                return int(m), int(hz_to_bin(info, f_hz + 3000)), m
            if mode == "LSB":
                return int(hz_to_bin(info, f_hz - 3000)), int(m), m
            off = hz_to_bins(info, 5000)
            return int(m - off), int(m + off), m
        return tune

    steady = [Steady(name, name, tuned(name, tones.m[i] * tones.df),
                     tones.tone_bins[i] * tones.df)
              for i, name in enumerate(MODE_NAMES)]
    # the server's own default: LSB at 7.1 MHz, no window command
    steady.append(Steady("LSB default", None, lambda info: None,
                         tones.tone_bins[1] * tones.df))

    def wf_tune(info):
        return round(hz_to_bin(info, tones.usb_bin * tones.df)) - 500

    return serve_cli("serve_rx888", text, cfg, tones, pool, steady,
                     wf_tune, RX888_SECS,
                     feed_mbps_bar=2 * cfg.sps / 1e6 * 0.99,
                     lag_bar_ms=1e3 * 36 * (1 << 19) / 35_000_000)


def main() -> int:
    import torch

    t_main = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--multihost-worker"]:
        pid, workdir, coord, link_port = sys.argv[2:6]
        return mh_worker(int(pid), workdir, int(coord), int(link_port))
    from phantomsdr_tpu_torch.config import config_from_dict, load_config
    from phantomsdr_tpu_torch.ops.cuda import (
        agc, anr, deemph, nb, nr, pilot, pll, waterfall,
    )

    torch.manual_seed(SEED)
    main_kernels = [waterfall.KERNEL, pll.KERNEL, agc.KERNEL]
    wbfm_kernels = [pilot.KERNEL, deemph.KERNEL, agc.FLOAT_KERNEL]
    nr_kernels = [nr.KERNEL, anr.KERNEL, nb.LPC_KERNEL, nb.REPAIR_KERNEL]
    kernels = main_kernels + wbfm_kernels + nr_kernels
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
    phase_small_wbfm()
    phase_small_nr()
    phase_small_real()
    launches = phase_main(cfg, tones, stream, main_kernels)
    # the real-input path at full width: bench.py's real profile
    real_cfg = config_from_dict(REAL_CFG)
    real_tones = RealTones(real_cfg)
    rgen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rblk = real_cfg.hop_batch * real_cfg.hop_size
    real_stream = torch.cat(
        [real_tones.real(s * rblk, rblk, rgen)
         for s in range(len(REAL_STEPS))]
        + [real_tones.real(len(REAL_STEPS) * rblk, real_cfg.hop_size,
                           rgen)])
    real_launches = phase_real(real_cfg, real_tones, real_stream,
                               main_kernels)
    del real_stream
    # mesh server mode: the bench config as 4 shards on this card
    mesh_cfg = config_from_dict({"input": BENCH_CFG["input"],
                                 "tpu": {**BENCH_CFG["tpu"],
                                         "mesh_devices": 4}})
    mesh_launches = phase_mesh(mesh_cfg, tones, stream, main_kernels)
    # multi-host server mode: two processes sharing this card
    mh_launches = phase_multihost(cfg, tones, stream, main_kernels)
    host_bytes = stream[:4 * 2 * blk].cpu().numpy().tobytes()
    mesh_bytes = stream[:8 * 2 * blk].cpu().numpy().tobytes()
    del stream
    phase_driver(cfg, tones, host_bytes)
    phase_server(cfg, tones, host_bytes)
    phase_driver(mesh_cfg, tones, mesh_bytes, mesh=["cuda:0"] * 4,
                 tone_from=4)
    phase_server(mesh_cfg, tones, host_bytes, mesh=["cuda:0"] * 4)
    phase_multihost_server(tones, host_bytes)
    nr_launches = phase_nr(kernels)
    wbfm_launches = phase_wbfm(kernels)
    rds_launches = phase_rds(kernels)
    # the JAX side's entry points and tools, ported: the graft entry
    # and dryrun, the stage profiler, tools/verify's checks and a soak
    # through the CLI
    tool_launches = {"entry": phase_entry(main_kernels),
                     "profile": phase_profile(),
                     "verify_tone": phase_verify_tone(),
                     **phase_verify_variants(),
                     "soak_smoke": phase_soak_smoke()}
    # the north-star deployment: the host's ingest legs, then the CLI
    # fed on stdin at 35 MSPS, serving 100 listeners and 28 waterfalls
    phase_ingest()
    tool_launches["serve_full"] = phase_serve_full(tones, host_bytes)
    # the port's bench.py, both profiles, then the RX888 deployment the
    # repository ships, fed at 70 MSPS of s16 real
    tool_launches.update(phase_bench())
    rx_cfg = load_config(str(REPO / "configs" /
                             "config.example.rx888.toml"))
    rx_tones = RealTones(rx_cfg)
    rx_pool = rx_tones.real(0, 4 * rx_cfg.hop_batch * rx_cfg.hop_size,
                            rgen).cpu().numpy().tobytes()
    tool_launches["serve_rx888"] = phase_serve_rx888(rx_tones, rx_pool)

    # each kernel's launches on its path: the bench-config main phase
    # for K-WF, K-PLL and K-AGC (beside them, the mesh phase's), the
    # wideband WBFM phase for K-PILOT,
    # K-DEEMPH and K-AGC float, the nr phase's opted-in run of spectral
    # (K-NR), lms (K-ANR) and nb (K-NB: both its launchers)
    nr_path = {"nr": "spectral", "anr": "lms", "nb_repair": "nb"}
    for row in rows:
        k = row.pop("kernel")
        launchers = row.pop("kernels", [k])
        if k in main_kernels:
            path, counts = "main", launches
        elif k in wbfm_kernels:
            path, counts = "wbfm", wbfm_launches
        else:
            path = f"nr {nr_path[k.name]}"
            counts = nr_launches[nr_path[k.name]]
        row["launches"] = min(counts[x.name] for x in launchers)
        row["launches_path"] = path
        row["launches_by_path"] = {
            "main": launches.get(k.name, 0),
            "real": real_launches.get(k.name, 0),
            "mesh": mesh_launches.get(k.name, 0),
            **{f"multihost p{p}": n.get(k.name, 0)
               for p, n in mh_launches.items()},
            "wbfm": wbfm_launches[k.name],
            "rds": rds_launches[k.name],
            **{f"nr {a}": nr_launches[a][k.name] for a in NR_ALGOS},
            **{path: n.get(k.name, 0) for path, n in tool_launches.items()}}
        if len(launchers) > 1:
            row["launches_by_launcher"] = {x.name: counts[x.name]
                                           for x in launchers}
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']}: not launched on its path")
        row["checked"] = True
    emit({"phase": "total", "seconds": time.monotonic() - t_main})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
