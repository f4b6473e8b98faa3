"""Per-stage device-time profiler for the PyTorch port's hop step.

The counterpart of tools/profile.py for ``phantomsdr_tpu_torch``: the
same stages and keys (``fft_batch``, ``waterfall_pyramid``,
``channelizer_demod``, ``dc_agc``; with ``--optin`` the 192 kHz
WBFM-profile stages), built from the port's own functions at the same
shapes, then the end-to-end step.  The port runs as separate launches
what XLA fused into one stage, so it also reports each stage's parts:

- ``substages_ms``: inside ``fft_batch`` the framed, windowed copy and
  cuFFT; inside ``channelizer_demod`` the three bin gathers, the
  IFFTs, K-PLL and the rest of the demod math; inside ``dc_agc`` the
  DC blocker with the stream layout, and K-AGC;
- ``outside_stages_ms``: the ingest (wire u8 to complex,
  ``ops/convert.py``) and the packing of the step's outputs (the
  power into the packed buffer), which the stages leave out;
- ``launches_by_stage``: each kernel's launches inside each stage.

Method (CUDA events, not torch.profiler, which drops records of the
port's ctypes-launched kernels in some runs):

- ``stages_ms``: the device time of one call: the device is kept busy
  by a spin (``torch.cuda._sleep``, twice the call's host issue time
  and 0.5 ms more) while the call is issued, then CUDA events around
  the call; the median of 10.  The substages are the intervals
  between events recorded around the tapped functions in such a run.
- ``stages_issue_ms``: per call over ``--kbig`` calls back to back,
  the host's issue included (the wall time the stage costs a caller
  who issues it from Python).
- Every call takes the next input of a pool at least 100 MB in all
  (over the card's 50 MB L2), so the cache does not flatter a stage.
- ``step_ms_e2e_p50``: host clock around one step and the fetch of its
  packed output (tools/profile.py's fence); ``step_device_ms``: the
  step's device time, measured as ``stages_ms``; ``step_split_ms``: the
  step's own device time between its stages' calls (``other``: what
  lies outside them: the output allocation and packing).

With ``--device cpu`` every stage, substage and step runs once on the
plain PyTorch versions, and every time is null (a CPU run gives no
device time).  ``--mesh N`` measures the sharded end-to-end step only;
``--devices cuda:0`` given N times places the N shards on one card.

Usage:
    python tools/torch_profile.py [--fft-log2 20] [--hops 18]
        [--channels 128] [--kbig 64] [--optin] [--out PROFILE_torch.json]
    python tools/torch_profile.py --mesh 4 --devices cuda:0 cuda:0 \\
        cuda:0 cuda:0
    python tools/torch_profile.py --device cpu --fft-log2 12 --hops 4 \\
        --channels 16 --kbig 2
Writes one JSON artifact and prints it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from phantomsdr_tpu_torch.bench import card_line  # noqa: E402

H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA H100 SXM data sheet
POOL_BYTES = 100 << 20          # twice the H100's 50 MB L2
REPS = 10                       # spun single calls whose median is a time
SEED = 0
MAIN_STAGES = ("fft_batch", "waterfall_pyramid", "channelizer_demod",
               "dc_agc")
OPTIN_STAGES = ("stereo_decode", "nr_spectral", "nr_lms", "nb_blanker",
                "rds_downmix", "stereo_plus_rds_shared")


class Pool:
    """Distinct inputs made by ``make(i)``, enough of them to hold
    POOL_BYTES in all (2 to 32); ``next()`` cycles through them."""

    def __init__(self, make, device):
        first = make(0)
        size = first.numel() * first.element_size()
        n = 1 if device.type == "cpu" else int(
            min(32, max(2, -(-POOL_BYTES // max(size, 1)))))
        self.items = [first] + [make(i) for i in range(1, n)]
        self.i = 0

    def next(self):
        self.i = (self.i + 1) % len(self.items)
        return self.items[self.i]


class Tap:
    """While active, wraps ``owner.attr`` for each (owner, attr, label)
    so that every call records a CUDA event before and after it (on the
    CPU: only the label), in ``marks``."""

    def __init__(self, targets, cuda: bool):
        self.targets = targets
        self.cuda = cuda
        self.marks: list = []
        self._saved: list = []

    def _wrap(self, fn, label):
        def tapped(*args, **kwargs):
            start = end = None
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            out = fn(*args, **kwargs)
            if self.cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            self.marks.append((label, start, end))
            return out
        return tapped

    def __enter__(self):
        for owner, attr, label in self.targets:
            orig = getattr(owner, attr)
            self._saved.append((owner, attr, orig))
            setattr(owner, attr, self._wrap(orig, label))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()


class Clock:
    """Device timing by CUDA events on the current stream (``cuda``), or
    on the CPU a runner that calls each function and times nothing."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.cycles_per_ms = self._cycles_per_ms() if self.cuda else 0.0

    @staticmethod
    def _cycles_per_ms() -> float:
        spin = 2_000_000
        times = []
        for _ in range(6):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            torch.cuda._sleep(spin)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return spin / float(np.median(times[1:]))

    def _issue_ms(self, call) -> float:
        """Host milliseconds to issue one call to an idle device."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        dt = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return dt

    def _spun(self, call, issue_ms: float):
        """One call behind a device spin; (start, end) events around it."""
        torch.cuda._sleep(int((2 * issue_ms + 0.5) * self.cycles_per_ms))
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        return s, e

    def device_ms(self, call) -> float | None:
        """Median device milliseconds of one call (host issue hidden)."""
        if not self.cuda:
            call()
            return None
        call()
        issue = max(self._issue_ms(call) for _ in range(2))
        times = []
        for _ in range(REPS):
            s, e = self._spun(call, issue)
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    def issue_ms(self, call, k: int) -> float | None:
        """Milliseconds a call over k calls back to back, issue
        included."""
        if not self.cuda:
            return None
        call()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(k):
            call()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / k

    def substages_ms(self, call, targets, rest: str) -> dict:
        """Median device milliseconds of each tapped label in one call
        (summed over its calls), and ``rest``: the call's time outside
        every tapped label."""
        runs = []
        if not self.cuda:
            with Tap(targets, False) as tap:
                call()
            labels = {m[0] for m in tap.marks}
            return {**{lab: None for lab in labels}, rest: None}
        with Tap(targets, True):  # the taps' own host work included
            call()
            issue = max(self._issue_ms(call) for _ in range(2))
        for _ in range(REPS):
            with Tap(targets, True) as tap:
                s, e = self._spun(call, issue)
            e.synchronize()
            got = {}
            for label, a, b in tap.marks:
                got[label] = got.get(label, 0.0) + a.elapsed_time(b)
            got[rest] = s.elapsed_time(e) - sum(got.values())
            runs.append(got)
        return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def counted(kernels, fn):
    """Run fn(); return each kernel's launches during it (by name)."""
    before = {k.name: k.launches for k in kernels}
    fn()
    return {k.name: k.launches - before[k.name] for k in kernels
            if k.launches - before[k.name]}


def bench_cfg(fft_log2: int, hops: int, channels: int):
    from phantomsdr_tpu_torch.config import config_from_dict

    return config_from_dict({
        "input": {
            "sps": 35_000_000, "frequency": 100_000_000,
            "fft_size": 1 << fft_log2, "signal": "iq",
            "audio_sps": 12000, "waterfall_size": 1024,
            "driver": {"format": "u8"},
        },
        "tpu": {"hop_batch": hops, "max_channels": channels},
    })


def table_columns(cfg) -> dict:
    """tools/profile.py's table: C slices of min(A, 300) bins spread
    over the band, modes cycling USB/LSB/AM/FM, all active."""
    c, r = cfg.max_channels, cfg.fft_result_size
    a = cfg.audio_max_fft_size
    l = np.linspace(1000, r - 2000, c).astype(np.int32)
    w = min(a, 300)
    return dict(l=l, r=l + w, m_idx=l + w // 2, mode=np.arange(c) % 4,
                active=np.ones(c, bool))


def profile_mesh(args, cfg, device, gen) -> dict:
    """The sharded end-to-end step only (tools/profile.py --mesh)."""
    from phantomsdr_tpu_torch.parallel.sharded import (
        ShardedHopPipeline, make_mesh,
    )

    mesh = make_mesh(args.mesh, device, args.devices)
    sp = ShardedHopPipeline(cfg, mesh)
    table = sp.channels_from_numpy(**table_columns(cfg))
    b = cfg.hop_batch
    raws = [sp.shard_raw(torch.randint(0, 256, (b * sp.wire_per_hop,),
                                       dtype=torch.uint8, generator=gen,
                                       device=device))
            for _ in range(2)]
    state = sp.init_state()
    state, out = sp.step(state, raws[0], table, waterfall="views")
    torch.cat([p.cpu() for p in out.packed])
    times = []
    for i in range(8):
        t0 = time.perf_counter()
        state, out = sp.step(state, raws[i % 2], table, waterfall="views")
        torch.cat([p.cpu() for p in out.packed])   # the fence
        times.append(time.perf_counter() - t0)
    times.sort()
    timed = device.type == "cuda"
    return {"config": {
        "fft_size": cfg.fft_size, "hop_batch": b,
        "channels": cfg.max_channels, "mesh_devices": args.mesh,
        "devices": [str(d) for d in mesh], "card": card_line()},
        "step_ms_sharded_p50": times[len(times) // 2] * 1e3 if timed else None,
        "step_ms_sharded_min": times[0] * 1e3 if timed else None,
        "samples_per_step": b * cfg.hop_size}


def profile(args) -> dict:
    """The per-stage table (or with ``args.mesh`` the sharded step) as a
    dict; see the module docstring."""
    from phantomsdr_tpu_torch import pipeline
    from phantomsdr_tpu_torch.ops import channelizer, convert
    from phantomsdr_tpu_torch.ops.agc import (
        dc_blocker, dc_blocker_delay, init_agc_state, init_dc_state,
        make_agc_params,
    )
    from phantomsdr_tpu_torch.ops.cuda import agc as cuda_agc
    from phantomsdr_tpu_torch.ops.cuda import all_kernels
    from phantomsdr_tpu_torch.ops.fft import forward_spectrum, frame_hops
    from phantomsdr_tpu_torch.pipeline import (
        HopPipeline, WaterfallViews, alloc_packed, channels_from_numpy,
        waterfall_from_spectra,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_profile: no CUDA device; pass --device "
                           "cpu to run the plain versions (no times)")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    cfg = bench_cfg(args.fft_log2, args.hops, args.channels)
    gen = torch.Generator(device=device).manual_seed(SEED)
    if args.mesh:
        return profile_mesh(args, cfg, device, gen)

    clock = Clock(device)
    kernels = all_kernels()
    b, c = cfg.hop_batch, cfg.max_channels
    r, a = cfg.fft_result_size, cfg.audio_max_fft_size
    half = a // 2
    pipe = HopPipeline(cfg, device=device)
    table = channels_from_numpy(**table_columns(cfg), device=device)
    all_rows = torch.arange(b, dtype=torch.int32, device=device)
    chan0 = pipe.init_state().audio.chan
    agc_params = make_agc_params(cfg.audio_sps)
    dc_delay = dc_blocker_delay(cfg.audio_sps)
    dc0 = init_dc_state(c, dc_delay, device)
    agc0 = init_agc_state(c, agc_params.window, device)
    wph = pipe.wire_per_hop
    n_cplx = (b + 1) * cfg.hop_size

    def cnormal(shape, scale=1.0):
        return torch.complex(
            torch.randn(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device)) * scale

    raw_pool = Pool(lambda i: torch.randint(
        0, 256, ((b + 1) * wph,), dtype=torch.uint8, generator=gen,
        device=device), device)
    x_pool = Pool(lambda i: cnormal((n_cplx,)), device)
    spec_pool = Pool(lambda i: cnormal((b, r), 1e-3), device)
    audio_pool = Pool(lambda i: torch.randn((b, c, half), generator=gen,
                                            device=device), device)
    _, out16, pwr_out, _, _ = alloc_packed(b, c, half, 0, 1, pipe.view_cap,
                                           device)

    def s_ingest():
        x = convert.to_float(raw_pool.next(), cfg.input_format)
        return convert.iq_to_complex(x)

    def s_fft():
        frames = frame_hops(x_pool.next(), b, cfg.fft_size)
        return forward_spectrum(frames, pipe.window, cfg.is_real)

    def s_waterfall():
        return waterfall_from_spectra(cfg, spec_pool.next(), all_rows)

    def s_demod():
        return channelizer.demodulate_batch(
            spec_pool.next(), table, chan0, 0, audio_fft_size=a,
            fft_result_size=r, base_idx=cfg.base_idx, is_real=cfg.is_real,
            am_sync=cfg.am_sync, carrier_cutoff=500 * a // cfg.audio_sps)

    def s_dcagc():
        # the served step's order: the [B, C, A/2] audio as each
        # channel's continuous stream, the DC blocker, K-AGC into int16
        stream = audio_pool.next().permute(1, 0, 2).reshape(c, b * half)
        _, stream = dc_blocker(dc0, stream, dc_delay)
        return cuda_agc.agc_int16(agc0, stream.contiguous(), agc_params,
                                  out16)

    pwr = s_demod()[2]

    def s_pack():
        _, _, pw, _, _ = alloc_packed(b, c, half, 0, 1, pipe.view_cap, device)
        pw.copy_(pwr)

    stages = {"fft_batch": s_fft, "waterfall_pyramid": s_waterfall,
              "channelizer_demod": s_demod, "dc_agc": s_dcagc}
    outside = {"ingest": s_ingest, "pack": s_pack}
    fft_mod = torch.fft
    taps = {
        "fft_batch": ([(fft_mod, "fft", "cufft")], "window"),
        "channelizer_demod": ([
            (channelizer, "gather_channel_bins", "gathers"),
            (fft_mod, "irfft", "iffts"), (fft_mod, "ifft", "iffts"),
            (channelizer, "am_sync_detect", "k_pll")], "demod_math"),
        "dc_agc": ([(cuda_agc, "agc_int16", "k_agc")],
                   "dc_blocker_and_layout"),
    }
    # the stage functions look these up at call time, so the taps see
    # them (s_dcagc calls cuda_agc.agc_int16 by its module)

    results: dict = {"config": {
        "fft_size": cfg.fft_size, "hop_batch": b, "channels": c,
        "sps": cfg.sps, "audio_fft_size": a, "device": str(device),
        "kind": (torch.cuda.get_device_name(device) if clock.cuda
                 else "cpu"),
        "card": card_line() if clock.cuda else None,
        "torch": torch.__version__, "am_sync": cfg.am_sync},
        "method": ("CUDA events: stages_ms one call behind a device spin, "
                   f"median of {REPS}; stages_issue_ms over "
                   f"{args.kbig} calls back to back" if clock.cuda else
                   "CPU run: every stage run once, no device times"),
        "stages_ms": {}, "stages_issue_ms": {}, "substages_ms": {},
        "outside_stages_ms": {}, "launches_by_stage": {}}
    for name, fn in {**stages, **outside}.items():
        key = "stages_ms" if name in stages else "outside_stages_ms"
        launches = counted(kernels, fn)
        results[key][name] = clock.device_ms(fn)
        if name in stages:
            results["stages_issue_ms"][name] = clock.issue_ms(fn, args.kbig)
            results["launches_by_stage"][name] = launches
        if name in taps:
            results["substages_ms"][name] = clock.substages_ms(fn,
                                                               *taps[name])

    if args.optin:
        optin(args, cfg, device, gen, clock, kernels, results)

    # ---- end-to-end step (tools/profile.py: 'full', packed fetched) ----
    state = pipe.init_state()

    def step():
        nonlocal state
        state, out = pipe.step(state, raw_pool.next(), table,
                               waterfall="full")
        return out

    step().packed.cpu()
    times = []
    for _ in range(6 if clock.cuda else 1):
        t0 = time.perf_counter()
        step().packed.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    results["step_launches"] = counted(kernels, step)
    results["step_ms_e2e_p50"] = times[len(times) // 2] if clock.cuda \
        else None
    results["step_device_ms"] = clock.device_ms(step)
    results["step_issue_ms"] = clock.issue_ms(step, max(2, args.kbig // 8))
    # the step itself split at its stages' calls (its inputs made by the
    # stage before, not taken from a pool)
    results["step_split_ms"] = clock.substages_ms(step, [
        (pipeline, "spectra_from_raw", "ingest_and_fft_batch"),
        (pipeline, "waterfall_from_spectra", "waterfall_pyramid"),
        (pipeline, "demodulate_batch", "channelizer_demod"),
        (pipeline, "dc_blocker", "dc_blocker"),
        (pipeline, "agc_int16", "k_agc")], "other")

    # ---- the served 'views' step: 128 client views at level 0 ----
    nv = 128
    starts = np.linspace(0, r - cfg.waterfall_size, nv).astype(np.int32)
    views = WaterfallViews(
        start=torch.from_numpy(starts).to(device),
        length=torch.full((nv,), cfg.waterfall_size, dtype=torch.int32,
                          device=device))
    due_idx = pipe.default_due_idx()

    def vstep():
        nonlocal state
        state, out = pipe.step(state, raw_pool.next(), table, views,
                               "views", due_idx=due_idx)
        return out

    results["views_step_device_ms"] = clock.device_ms(vstep)
    results["views_due_rows"] = int(due_idx.numel())

    if clock.cuda:
        compute = sum(results["stages_ms"].values())
        parts = compute + sum(results["outside_stages_ms"].values())
        results["device_compute_ms_total"] = compute
        results["stages_and_outside_ms"] = parts
        results["stages_and_outside_over_step_device"] = (
            parts / results["step_device_ms"])
        results["device_msps_ceiling"] = b * cfg.hop_size / (compute / 1e3) \
            / 1e6
    results["samples_per_step"] = b * cfg.hop_size

    # ---- the FFT's speed of light at the H100's HBM3 rate ----
    # 2^20 c2c f32: ~3 passes x 16 B/point r+w over B*N points
    n = cfg.fft_size
    bytes_moved = 3 * 2 * 8 * b * n
    results["fft_sol"] = {
        "assumed_hbm_gbps": H100_BYTES_PER_S / 1e9,
        "bytes_moved_est": bytes_moved,
        "sol_ms": bytes_moved / H100_BYTES_PER_S * 1e3,
        "measured_ms": results["stages_ms"]["fft_batch"],
        "cufft_ms": results["substages_ms"]["fft_batch"].get("cufft"),
    }
    return results


def optin(args, cfg, device, gen, clock, kernels, results) -> None:
    """The opt-in stages at the 192 kHz WBFM-profile block shape
    [C, B * 2048] (tools/profile.py:275-361)."""
    from phantomsdr_tpu_torch.ops.anr import (
        init_anr_state, make_anr_params, anr_process,
    )
    from phantomsdr_tpu_torch.ops.cuda.pilot import pilot_mix
    from phantomsdr_tpu_torch.ops.nb import (
        init_nb_state, make_nb_params, nb_process,
    )
    from phantomsdr_tpu_torch.ops.nr import (
        init_nr_state, make_nr_params, nr_process,
    )
    from phantomsdr_tpu_torch.ops.rds import (
        init_rds_state, make_rds_params, rds_baseband, rds_process,
    )
    from phantomsdr_tpu_torch.ops.stereo import (
        delay_stream, init_stereo_state, make_stereo_params, pilot_bandpass,
        stereo_decode,
    )

    b, c = cfg.hop_batch, cfg.max_channels
    fs = 192000
    t_len = b * 2048
    kb = min(32, args.kbig)
    pool = Pool(lambda i: torch.randn((c, t_len), generator=gen,
                                      device=device), device)
    fm_mask = torch.ones(c, dtype=torch.bool, device=device)
    results["optin_config"] = {"fs": fs, "block": [c, t_len], "kbig": kb}
    for key in ("optin_stages_ms", "optin_stages_issue_ms"):
        results[key] = {}

    sp = make_stereo_params(fs)
    st0 = init_stereo_state(c, sp, device)
    nrp = make_nr_params(2048)
    nst0 = init_nr_state(c, 2048, device)
    anp = make_anr_params(notch=False)
    ast0 = init_anr_state(c, anp, device)
    nbp = make_nb_params()
    bst0 = init_nb_state(c, nbp, device)
    rp = make_rds_params(fs, 2048)
    rst0 = init_rds_state(c, rp, device)

    def s_both():
        # the pipeline's shared-pilot path (pipeline.audio_from_spectra):
        # one bandpass and one K-PILOT launch feed the stereo demix and
        # the 57 kHz downmix
        x = pool.next()
        _, y = pilot_bandpass(rst0.bp_tail, rp.bp_taps, x)
        _, xd = delay_stream(rst0.mpx_tail, x)
        _, xm = delay_stream(st0.mono_tail, x)
        _, _, _, lr, iq = pilot_mix(rst0.phase, rst0.freq, rp.f_nom, y,
                                    xs=xm, fm_mask=fm_mask, xr=xd)
        return lr, rds_baseband(rst0.dec_tail, rp, iq, fm_mask)

    stages = {
        "stereo_decode": lambda: stereo_decode(st0, sp, pool.next(), fm_mask),
        "nr_spectral": lambda: nr_process(nst0, nrp, pool.next(), b),
        "nr_lms": lambda: anr_process(ast0, anp, pool.next()),
        "nb_blanker": lambda: nb_process(bst0, nbp, pool.next()),
        "rds_downmix": lambda: rds_process(rst0, rp, pool.next(), fm_mask),
        "stereo_plus_rds_shared": s_both,
    }
    for name, fn in stages.items():
        results["launches_by_stage"][name] = counted(kernels, fn)
        results["optin_stages_ms"][name] = clock.device_ms(fn)
        results["optin_stages_issue_ms"][name] = clock.issue_ms(fn, kb)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fft-log2", type=int, default=20)
    ap.add_argument("--hops", type=int, default=18)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--kbig", type=int, default=64,
                    help="calls back to back for stages_issue_ms")
    ap.add_argument("--out", default="PROFILE_torch.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--optin", action="store_true",
                    help="also profile the opt-in stages (WBFM stereo, "
                         "the three noise processors, RDS) at the "
                         "192 kHz WBFM-profile block shape")
    ap.add_argument("--mesh", type=int, default=0,
                    help="measure the sharded e2e step on an N-shard "
                         "mesh instead of the per-stage table (hops and "
                         "channels must divide by N)")
    ap.add_argument("--devices", nargs="+", default=None,
                    help="the mesh's devices, e.g. cuda:0 four times for "
                         "four shards on one card")
    args = ap.parse_args()
    if args.kbig < 2:
        ap.error("--kbig must be >= 2")
    if Path(args.out).name == "PROFILE.json":
        ap.error("PROFILE.json is the JAX package's record; write "
                 "another file")
    res = profile(args)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
