#!/usr/bin/env python3
"""Where K-AGC's time goes on the card, at chip_smoke.py's bench shape
([128, 6480] float32 streams, window 2400, seen mixed over 0, W/2, W-1
and W).

    python3 tools/torch_kernel_breakdown.py

Prints one JSON line each:

- ``agc_phases``: cycles (clock64, from the block's start) at which
  csrc/agc.cu's phases end -- y loaded and split into block maxes, the
  sparse table built, the chain's first chunk ready -- and the chain's
  cycles per sample, by warm-up point, beside the chain probe's.  They
  come from an instrumented copy of csrc/agc.cu: this script adds the
  stamps to the source text and builds it with nvcc into
  build/torch_kernels/ (the kernel the package runs stays as it is).
- ``host_us``: microseconds of host time of one call of each wrapper
  and of its parts, each call made on an idle card (the time in which a
  lone call leaves the card waiting), and ``events_only_ms``:
  chip_smoke.py's one-call timing of an empty function, the timing's own
  cost.

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


def build(src: str) -> ctypes.CDLL:
    from phantomsdr_tpu_torch.ops.cuda.build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / "agc_stamped.cu"
    so = BUILD_DIR / "libagc_stamped.so"
    cu.write_text(src)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True)
    return ctypes.CDLL(str(so))


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from phantomsdr_tpu_torch.ops.agc import AGCState, make_agc_params
    from phantomsdr_tpu_torch.ops.cuda import agc, pll
    from phantomsdr_tpu_torch.ops.cuda.build import (
        I, P, require_cuda, stream_and_device,
    )

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

    lib = build(instrumented_source())
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

    carrier = torch.randn(c, n, dtype=torch.complex64, device="cuda",
                          generator=gen)
    zero = torch.zeros(c, device="cuda")
    raw = agc.KERNEL.lib().agc_launch
    from chip_smoke import time_ms

    print(json.dumps({"host_us": {
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
