#!/usr/bin/env python3
"""Where K-AGC's and K-WF's time goes on the card, at chip_smoke.py's
bench shapes.

    python3 tools/torch_kernel_breakdown.py [--host-only]

Prints one JSON line each:

- ``agc_phases``: cycles (clock64, from the block's start) at which
  csrc/agc.cu's phases end -- y loaded and split into block maxes, the
  sparse table built, the chain's first chunk ready -- and the chain's
  cycles per sample, by warm-up point, beside the chain probe's, at
  [128, 6480] float32 streams, window 2400, seen mixed over 0, W/2, W-1
  and W.  They come from an instrumented copy of csrc/agc.cu: this script
  adds the stamps to the source text and builds it with nvcc into
  build/torch_kernels/ (the kernel the package runs stays as it is).
- ``wf_variants``: K-WF at its bench shape ([36, 2^20] complex64 spectra
  with |X|^2 spread over the int8 range, 6 due rows, 11 levels), device
  us per call (torch.profiler) of the kernel as built and of copies of
  csrc/waterfall.cu that take the accurate log2f for every output
  (``accurate_log2``) or no log2 at all (``no_log2``, its output wrong:
  the rest of the kernel alone); and, from a copy that counts, the
  outputs quantized (p > 0), those whose dB lay within 2^-10 of an
  integer and went to log2f, and of those the ones where lg2.approx
  alone would have given another int8 (``differ_at_edge``), and
  elsewhere (``differ_elsewhere``, which must be 0).
- ``host_us``: microseconds of host time of one call of each wrapper
  and of its parts, each call made on an idle card (the time in which a
  lone call leaves the card waiting), and ``events_only_ms``:
  chip_smoke.py's one-call timing of an empty function, the timing's own
  cost.  ``waterfall_rows`` is K-WF's wrapper at its bench shape.

``--host-only`` prints only ``host_us``: copied into another checkout's
tools/, the script then times that checkout's wrappers (their
signatures have not changed).

Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (anchor in csrc/agc.cu, text, whether the text goes before the anchor
# rather than after it): the kernel's stamps 0-3 and its t0 at slot 5
STAMPS = [
    ("namespace {\n", "__device__ long long g_stamps[8 * 4096];\n", True),
    ("    if (threadIdx.x == 0) ready = done = 0;\n",
     "    const long long stamp0 = clock64();\n"
     "    long long* stamps = g_stamps + 8 * c;\n", False),
    ("    __syncthreads();\n    const int levels = table_levels(window);\n",
     "    if (threadIdx.x == 0) stamps[0] = clock64() - stamp0;\n", False),
    ("    const int chunks = (len + kChunk - 1) / kChunk;\n",
     "    if (threadIdx.x == 0) stamps[1] = clock64() - stamp0;\n", False),
    ("            while (load_flag(&ready) <= k) {\n            }\n",
     "            if (k == t0 / kChunk) stamps[2] = clock64() - stamp0;\n", False),
    ("        seen_out[c] = seen + len < window ? seen + len : window;\n",
     "        stamps[3] = clock64() - stamp0;\n        stamps[5] = t0;\n", False),
    ("    const int c = blockIdx.x;\n    float g = gain0[c];\n",
     "    const long long stamp0 = clock64();\n", False),
]
# the probe's chain cycles, at slot 6
PROBE_END = "    gain_out[c] = g;\n}\n"


# K-WF: the line of quantize() that sends an output near an integer dB
# to the accurate log2f, and what each variant puts in its place
WF_EDGE = ("    if (p < 1.17549435e-38f || fabsf(db - rintf(db)) < kEdgeDb) "
           "db = db_of(log2f(p), l2db, off_db);\n")
WF_VARIANTS = {
    "accurate_log2": "    db = db_of(log2f(p), l2db, off_db);\n",
    "no_log2": "    db = p;\n",
    "counted": """    {
        const float exact = db_of(log2f(p), l2db, off_db);
        const bool edge = p < 1.17549435e-38f || fabsf(db - rintf(db)) < kEdgeDb;
        const float ta = fminf(fmaxf(truncf(db), -128.0f), 127.0f);
        const float te = fminf(fmaxf(truncf(exact), -128.0f), 127.0f);
        atomicAdd(&g_wf_counts[0], 1ULL);
        if (edge) atomicAdd(&g_wf_counts[1], 1ULL);
        if (ta != te) atomicAdd(&g_wf_counts[edge ? 2 : 3], 1ULL);
        db = exact;
    }
""",
}
WF_COUNTS = ["quantized", "to_log2f", "differ_at_edge", "differ_elsewhere"]


def waterfall_variant(name: str) -> str:
    src = (ROOT / "phantomsdr_tpu_torch/csrc/waterfall.cu").read_text()
    if src.count(WF_EDGE) != 1 or src.count("namespace {\n") != 1:
        raise RuntimeError("csrc/waterfall.cu changed: quantize()'s edge line")
    src = src.replace(WF_EDGE, WF_VARIANTS[name])
    if name != "counted":
        return src
    src = src.replace("namespace {\n", "__device__ unsigned long long g_wf_counts[4];\n"
                      "namespace {\n")
    return src + """
extern "C" int read_counts(unsigned long long* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_wf_counts, sizeof(g_wf_counts)));
}
"""


def instrumented_source() -> str:
    src = (ROOT / "phantomsdr_tpu_torch/csrc/agc.cu").read_text()
    for anchor, text, before in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"csrc/agc.cu changed: anchor {anchor!r}")
        src = src.replace(anchor, text + anchor if before else anchor + text)
    if src.count(PROBE_END) != 1:
        raise RuntimeError("csrc/agc.cu changed: the probe's end")
    src = src.replace(PROBE_END, "    g_stamps[8 * c + 6] = clock64() - stamp0;\n"
                      + PROBE_END)
    return src + """
extern "C" int read_stamps(long long* host, int channels) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps,
                                                 sizeof(long long) * 8 * channels));
}
"""


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Build each {name: CUDA source} into build/torch_kernels/ at once."""
    from phantomsdr_tpu_torch.ops.cuda.build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = BUILD_DIR / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(BUILD_DIR / f"lib{name}.so"),
             str(cu)])
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name}")
    return {name: ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            for name in sources}


def host_us(fn, calls: int = 50) -> float:
    """Median host microseconds of one fn() call on an idle card."""
    import torch

    times = []
    for _ in range(calls + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return float(np.median(times[1:])) * 1e6


def agc_phases(state, x, params, out, args, gain, dev, stream) -> None:
    """Print K-AGC's phase stamps from its instrumented copy."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import agc
    from phantomsdr_tpu_torch.ops.cuda.build import I, P

    c, n = x.shape
    lib = build({"agc_stamped": instrumented_source()})["agc_stamped"]
    lib.agc_launch.argtypes = agc.KERNEL.argtypes
    lib.agc_chain_probe_launch.argtypes = agc.KERNEL.probe_argtypes
    lib.read_stamps.argtypes = [P, I]
    stamps = np.zeros((c, 8), np.int64)
    for _ in range(3):
        assert lib.agc_launch(*args) == 0
    torch.cuda.synchronize()
    lib.read_stamps(stamps.ctypes.data, c)
    want = torch.empty_like(out)
    agc.agc_int16_plain(state, x, params, want)
    if not torch.equal(out, want):
        raise AssertionError("instrumented K-AGC differs from the plain version")
    for _ in range(3):
        assert lib.agc_chain_probe_launch(x.data_ptr(), state.gain.data_ptr(),
                                          gain.data_ptr(), c, n,
                                          *agc._coeffs(params)[:2], dev,
                                          stream) == 0
    torch.cuda.synchronize()
    probe = np.zeros((c, 8), np.int64)
    lib.read_stamps(probe.ctypes.data, c)
    chain = {}
    for t0 in sorted(set(stamps[:, 5].tolist())):
        sel = stamps[:, 5] == t0
        cyc = stamps[sel, 3] - stamps[sel, 2]
        chain[str(t0)] = float(np.median(cyc)) / max(n - t0, 1)
    print(json.dumps({"agc_phases": {
        "cycles_median": {name: float(np.median(stamps[:, k]))
                          for k, name in enumerate(
                              ["loaded", "table", "chain_start", "chain_end"])},
        "cycles_max": {"chain_end": int(stamps[:, 3].max())},
        "chain_cycles_per_sample_by_t0": chain,
        "probe_cycles_per_sample": float(np.median(probe[:, 6])) / n}}),
        flush=True)


def wf_variants(spec, rows, kw, dev, stream) -> dict:
    """K-WF's device us per call as built and in its variants, and the
    counted copy's counts; each variant but no_log2 must equal the plain
    version."""
    import torch

    from chip_smoke import device_us_by_kernel
    from phantomsdr_tpu_torch.ops.cuda import waterfall

    libs = build({f"waterfall_{name}": waterfall_variant(name)
                  for name in WF_VARIANTS})
    want = waterfall.waterfall_rows_plain(spec, rows, **kw)
    r = kw["fft_result_size"]
    out = torch.empty_like(want)
    args = (spec.data_ptr(), spec.stride(0), rows.data_ptr(), rows.shape[0],
            r, kw["base_idx"] % r, kw["levels"], kw["size_log2"],
            waterfall._L2DB, waterfall._DPO, out.data_ptr(), out.shape[1],
            None, dev, stream)
    res = {"as_built_us": sum(device_us_by_kernel(
        lambda: waterfall.waterfall_rows(spec, rows, **kw)).values())}
    for name, lib in libs.items():
        name = name.removeprefix("waterfall_")
        fn = lib.waterfall_launch
        fn.argtypes = waterfall.KERNEL.argtypes
        fn.restype = ctypes.c_int
        if fn(*args) != 0:
            raise RuntimeError(f"K-WF {name} did not launch")
        torch.cuda.synchronize()
        if name != "no_log2" and not torch.equal(out, want):
            raise AssertionError(f"K-WF {name} differs from the plain version")
        if name == "counted":
            counts = (ctypes.c_ulonglong * len(WF_COUNTS))()
            lib.read_counts.argtypes = [ctypes.c_void_p]
            lib.read_counts(counts)
            res["counts"] = dict(zip(WF_COUNTS, map(int, counts)))
            if res["counts"]["differ_elsewhere"]:
                raise AssertionError(f"lg2.approx differs away from an edge: "
                                     f"{res['counts']}")
        else:
            res[f"{name}_us"] = sum(device_us_by_kernel(lambda: fn(*args)).values())
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from phantomsdr_tpu_torch.ops.agc import AGCState, make_agc_params
    from phantomsdr_tpu_torch.ops.cuda import agc, pll, waterfall
    from phantomsdr_tpu_torch.ops.cuda.build import require_cuda, stream_and_device

    c, b, half = 128, 36, 180
    n = b * half
    params = make_agc_params(12000)
    w = params.window
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(c, n, device="cuda", generator=gen) * 0.05
    x[:, ::97] *= 8.0
    state = AGCState(
        tail=torch.randn(c, w - 1, device="cuda", generator=gen) * 0.05,
        gain=torch.rand(c, device="cuda", generator=gen) * 5.0,
        seen=torch.tensor([0, w // 2, w - 1, w] * (c // 4),
                          dtype=torch.int32, device="cuda"))
    out = torch.empty(b, c, half, dtype=torch.int16, device="cuda")
    tail, gain = torch.empty_like(state.tail), torch.empty_like(state.gain)
    seen = torch.empty_like(state.seen)
    stream, dev = stream_and_device(x)
    args = (x.data_ptr(), state.tail.data_ptr(), state.gain.data_ptr(),
            state.seen.data_ptr(), c, n, w, *agc._coeffs(params), half,
            out.data_ptr(), tail.data_ptr(), gain.data_ptr(),
            seen.data_ptr(), None, dev, stream)

    host_only = "--host-only" in sys.argv[1:]
    if not host_only:
        agc_phases(state, x, params, out, args, gain, dev, stream)

    carrier = torch.randn(c, n, dtype=torch.complex64, device="cuda",
                          generator=gen)
    zero = torch.zeros(c, device="cuda")
    raw = agc.KERNEL.lib().agc_launch
    from chip_smoke import time_ms

    r, levels = 1 << 20, 11
    spec = (torch.randn(b, r, dtype=torch.complex64, device="cuda",
                        generator=gen)
            * 10 ** (torch.rand(b, r, device="cuda", generator=gen) * 10 - 12))
    rows = torch.arange(0, b, b // 6, dtype=torch.int32, device="cuda")
    wf_kw = dict(fft_result_size=r, base_idx=r // 2 + 1, levels=levels,
                 size_log2=20)
    if not host_only:
        print(json.dumps({"wf_variants": wf_variants(spec, rows, wf_kw, dev,
                                                     stream)}), flush=True)
    wf_out = waterfall.waterfall_rows(spec, rows, **wf_kw)
    wf_args = (spec.data_ptr(), r, rows.data_ptr(), rows.shape[0], r,
               r // 2 + 1, levels, 20, 6.0206, 6.0206, wf_out.data_ptr(),
               wf_out.shape[1], None, dev, stream)
    wf_raw = waterfall.KERNEL.lib().waterfall_launch

    print(json.dumps({"host_us": {
        "waterfall_rows": host_us(lambda: waterfall.waterfall_rows(
            spec, rows, **wf_kw)),
        "waterfall_launch_ctypes": host_us(lambda: wf_raw(*wf_args)),
        "agc_int16": host_us(lambda: agc.agc_int16(state, x, params, out)),
        "am_sync_detect": host_us(lambda: pll.am_sync_detect(
            carrier, carrier, zero, zero)),
        "require_cuda": host_us(lambda: require_cuda(x, "x", torch.float32, 2)),
        "empty_like": host_us(lambda: torch.empty_like(state.tail)),
        "stream_and_device": host_us(lambda: stream_and_device(x)),
        "agc_launch_ctypes": host_us(lambda: raw(*args)),
    }, "events_only_ms": time_ms(lambda: None, 50)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
