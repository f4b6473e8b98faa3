#!/usr/bin/env python3
"""Where K-AGC's, K-PILOT's, K-WF's, K-NR's, K-ANR's and K-NB's time goes
on the card, at chip_smoke.py's shapes.

    python3 tools/torch_kernel_breakdown.py [--host-only | --only LINES]
        [--parent CSRC_DIR] [--sass-dir DIR]

Prints one JSON line each:

- ``agc_phases``: cycles (clock64, from the block's start) at which
  csrc/agc.cu's phases end -- y read and split into block maxes, the
  sparse table built, the chain's first chunk ready, the chain done --
  and the chain's cycles per sample, by warm-up point, beside the chain
  probe's, at two shapes: ``bench_int16`` ([128, 6480] float32 streams,
  window 2400, int16 out) and ``wbfm_float`` ([128, 40,272], window
  38,400, float32 out, the WBFM step's), seen mixed over 0, W/2, W-1 and
  W.  They come from an instrumented copy of csrc/agc.cu: this script
  adds the stamps to the source text and builds it with nvcc into
  build/torch_kernels/ (the kernel the package runs stays as it is); its
  output must equal the package kernel's.
- ``pilot_sass``: for csrc/pilot.cu, each kernel's registers and stack
  frame (``nvcc -Xptxas -v``) and, for each chain probe, the
  instructions of its loop (four steps) by opcode, from ``cuobjdump
  -sass``; the whole SASS goes to ``--sass-dir`` (default
  build/torch_kernels/).
- ``pilot_depths``: K-PILOT's kernel ms at the WBFM shape with its
  register ring of pilot samples 2, 4, 8 (as built) and 16 groups deep,
  from copies of csrc/pilot.cu.
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
- ``nr_phases``: K-NR's cycles a frame by part at [36, 128, 180] (lane
  0 of each warp, median over the warps), from an instrumented copy of
  csrc/nr.cu whose outputs must equal the package kernel's: the
  ``groups`` design's load wait, xt head, hk tail, range test + vote +
  exact redo, and stores (each part waited for before the next stamp, so
  the parts run one after the other there); the first ``frame``
  design's load wait, frame and stores; the share of warp-frames redone on
  the exact path; and the cycles a frame of a copy stamped only at the
  loop's ends.  On the bench case and with every third channel silent
  from a fresh state; and the latter copy's cycles a frame for one warp
  alone on the card, with a timing-only copy without the hk tails (its
  gains wrong) beside it: what the xt chain alone costs.
- ``nr_shapes``: K-NR's kernel ms and chain floor at that shape in copies
  of csrc/nr.cu with other threads a block and frames a group; each
  copy's outputs must equal the package kernel's.
- ``issue_rates``: cycles a warp-instruction of FFMA, FMNMX, FMNMX.NAN
  and an FSETP + FSEL pair takes its scheduler (8 independent chains a
  thread, 2 warps a scheduler): what K-NR's loop costs by instruction.
- ``anr_phases``: K-ANR's cycles a block by phase (thread 0's clock64
  between stamps that sit after block barriers, median over the 128
  channels of [128, 6480], LMS NR at taps 64, delay 8, blocks of 256),
  beside its chain probe's, from an instrumented copy of csrc/anr.cu
  whose outputs must equal the package kernel's.  The ``slide`` design
  (a block staged at a time, the history slid): stage, predict, update,
  combine, slide; the ``ring`` design: the segment hand-over, the
  prediction's sums and its outputs + barrier, the update's sums and
  its stores + barrier, combine, and its first producer's cycles a
  segment; ``other`` is the rest (the prologue).
- ``nb_phases``: K-NB's cycles by phase of each launch at [128, 6554]
  (clicks in a tone, order 32, il 11): lags, Levinson, the recursions
  (the ``tiles`` design: forward and backward apart); the repair
  launch's statistics, ballot, search (+ copy in ``tiles``; + spans in
  ``spans``), backward predictions, repairs and writeback (``spans``),
  and the same for its chain probe; instrumented likewise.
- ``anr_variants``: K-ANR's kernel ms at that shape in copies of
  csrc/anr.cu: each chain thread running 1, 2, 3 (as built) or 5
  adjacent chains, the group loops kept from further unrolling; each
  copy's outputs must equal the package kernel's.
- ``host_us``: microseconds of host time of one call of each wrapper
  and of its parts, each call made on an idle card (the time in which a
  lone call leaves the card waiting), and ``events_only_ms``:
  chip_smoke.py's one-call timing of an empty function, the timing's own
  cost.  ``waterfall_rows`` is K-WF's wrapper at its bench shape,
  ``gain_frames`` K-NR's at [36, 128, 180] (with ``--parent``, beside
  the parent checkout's wrapper in turns); ``nr_launches_per_call``
  counts the kernels the spectral NR stages around K-NR launch a call
  (frame_spectra, its |z|^2, smooth_gains).

``--parent CSRC_DIR`` (the ``phantomsdr_tpu_torch/csrc`` of another
checkout, e.g. unpacked with ``git archive`` into build/archive/) adds
that checkout's K-AGC, K-PILOT, K-NR, K-ANR and K-NB beside the
package's: its ``agc_phases``, ``pilot_sass``, ``nr_phases``,
``anr_phases`` and ``nb_phases``, and a ``compare`` line that holds its
outputs equal to the package kernels' bit for bit on the same inputs
(K-NR also at the card tests' edge shapes and with silent and subnormal
channels) and times both in turns (parent, package, package, parent:
kernel_ms, the device work of one call) with their chain probes.  The
parent's C interfaces must be the package's.

``--only LINES`` (comma-separated names of the lines above) prints only
those.  ``--host-only`` prints only ``host_us``: copied into another
checkout's tools/, the script then times that checkout's wrappers
(their signatures have not changed).

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


def instrumented_source(src: str) -> str:
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


def build(sources: dict[str, str], include: Path | None = None,
          verbose: bool = False) -> dict[str, ctypes.CDLL]:
    """Build each {name: CUDA source} into build/torch_kernels/ at once,
    with ``include`` (default: the package's csrc/) on the include path;
    ``verbose`` keeps ptxas's register and stack lines in ``PTXAS[name]``."""
    from phantomsdr_tpu_torch.ops.cuda.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = BUILD_DIR / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(include or CSRC),
             *(["-Xptxas", "-v"] if verbose else []),
             "-o", str(BUILD_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        PTXAS[name] = log
    return {name: ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            for name in sources}


PTXAS: dict[str, str] = {}


def kernel_launches(fn) -> int:
    """CUDA kernels that one fn() call launches (torch.profiler's records;
    for PyTorch's own kernels, which it keeps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(ev.count for ev in prof.key_averages() if ev.device_time_total > 0))


def nr_fusion_launches() -> dict:
    """Launches a call of the spectral NR step's stages around K-NR at
    [36, 128, 180]: frame_spectra, its |z|^2 alone, smooth_gains (the
    fusions queued beside K-NR)."""
    import torch

    from phantomsdr_tpu_torch.ops.nr import frame_spectra, smooth_gains

    carries, p, xp, _, _ = nr_case()
    n, c, f = xp.shape
    x = torch.randn(c, n * f, device="cuda")
    win = torch.from_numpy(p.window).to("cuda")
    _, z, _ = frame_spectra(carries[1], win, x, n)
    g = torch.rand_like(xp)
    running = torch.ones(n, c, dtype=torch.bool, device="cuda")

    def abs2():
        zf = z[..., :f]
        return (zf.real ** 2 + zf.imag ** 2).contiguous()

    return {"frame_spectra": kernel_launches(lambda: frame_spectra(carries[1], win, x, n)),
            "x_pow_abs2": kernel_launches(abs2),
            "smooth_gains": kernel_launches(lambda: smooth_gains(g, xp, running))}


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


def agc_launcher(lib, float_mode: bool):
    from phantomsdr_tpu_torch.ops.cuda import agc

    kernel = agc.FLOAT_KERNEL if float_mode else agc.KERNEL
    fn = lib.agc_float_launch if float_mode else lib.agc_launch
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    return fn


def agc_case(name: str):
    """(state, x, params, float_mode) of one of agc_phases' shapes."""
    import torch

    from phantomsdr_tpu_torch.ops.agc import AGCState, make_agc_params

    c, n, sr, float_mode = {"bench_int16": (128, 36 * 180, 12000, False),
                            "wbfm_float": (128, 8 * 5034, 192000, True)}[name]
    params = make_agc_params(sr)
    w = params.window
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(c, n, device="cuda", generator=gen) * 0.05
    x[:, ::97] *= 8.0
    state = AGCState(
        tail=torch.randn(c, w - 1, device="cuda", generator=gen) * 0.05,
        gain=torch.rand(c, device="cuda", generator=gen) * 5.0,
        seen=torch.tensor([0, w // 2, w - 1, w] * (c // 4),
                          dtype=torch.int32, device="cuda"))
    return state, x, params, float_mode


def agc_call(fn, state, x, params, float_mode: bool):
    """A callable that launches K-AGC's ``fn`` (a ctypes launcher) on the
    case, and its outputs (out, tail, gain, seen)."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import agc
    from phantomsdr_tpu_torch.ops.cuda.build import stream_and_device

    c, n = x.shape
    w = params.window
    if float_mode:
        out = torch.empty_like(x)
        head = ()
    else:
        half = 180
        out = torch.empty(n // half, c, half, dtype=torch.int16, device="cuda")
        head = (half,)
    tail, gain = torch.empty_like(state.tail), torch.empty_like(state.gain)
    seen = torch.empty_like(state.seen)
    stream, dev = stream_and_device(x)
    args = (x.data_ptr(), state.tail.data_ptr(), state.gain.data_ptr(),
            state.seen.data_ptr(), c, n, w, *agc._coeffs(params), *head,
            out.data_ptr(), tail.data_ptr(), gain.data_ptr(), seen.data_ptr(),
            dev, stream)

    def run():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"K-AGC launch failed: {rc}")

    return run, (out, tail, gain, seen)


def package_agc(state, x, params, float_mode: bool):
    """The package kernel's (out, tail, gain, seen) on the case."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import agc

    if float_mode:
        st, out = agc.agc_float(state, x, params)
    else:
        c, n = x.shape
        out = torch.empty(n // 180, c, 180, dtype=torch.int16, device="cuda")
        st = agc.agc_int16(state, x, params, out)
    return (out, st.tail, st.gain, st.seen)


def same(a, b) -> bool:
    import torch

    return all(torch.equal(u, v) for u, v in zip(a, b))


def agc_phases(src: str, include: Path, tag: str) -> dict:
    """K-AGC's phase stamps at both shapes from an instrumented copy of
    the source text ``src``; its outputs must equal the package
    kernel's."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import agc
    from phantomsdr_tpu_torch.ops.cuda.build import I, P, stream_and_device

    lib = build({f"agc_stamped_{tag}": instrumented_source(src)},
                include)[f"agc_stamped_{tag}"]
    lib.agc_chain_probe_launch.argtypes = agc.KERNEL.probe_argtypes
    lib.read_stamps.argtypes = [P, I]
    res = {}
    for case in ("bench_int16", "wbfm_float"):
        state, x, params, float_mode = agc_case(case)
        c, n = x.shape
        run, got = agc_call(agc_launcher(lib, float_mode), state, x, params,
                            float_mode)
        stamps = np.zeros((c, 8), np.int64)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        lib.read_stamps(stamps.ctypes.data, c)
        if not same(got, package_agc(state, x, params, float_mode)):
            raise AssertionError(f"instrumented K-AGC ({tag}, {case}) differs "
                                 f"from the package kernel")
        gain = torch.empty_like(state.gain)
        stream, dev = stream_and_device(x)
        for _ in range(3):
            assert lib.agc_chain_probe_launch(
                x.data_ptr(), state.gain.data_ptr(), gain.data_ptr(), c, n,
                *agc._coeffs(params)[:2], dev, stream) == 0
        torch.cuda.synchronize()
        probe = np.zeros((c, 8), np.int64)
        lib.read_stamps(probe.ctypes.data, c)
        chain = {}
        for t0 in sorted(set(stamps[:, 5].tolist())):
            sel = stamps[:, 5] == t0
            cyc = stamps[sel, 3] - stamps[sel, 2]
            chain[str(t0)] = float(np.median(cyc)) / max(n - t0, 1)
        res[case] = {
            "shape": [c, n], "window": params.window,
            "cycles_median": {name: float(np.median(stamps[:, k]))
                              for k, name in enumerate(
                                  ["loaded", "table", "chain_start",
                                   "chain_end"])},
            "cycles_max": {"chain_end": int(stamps[:, 3].max())},
            "chain_cycles_per_sample_by_t0": chain,
            "probe_cycles_per_sample": float(np.median(probe[:, 6])) / n,
            "equal_to_package_kernel": True}
    return {"source": tag, **res}


PILOT_FUNCTIONS = ("pilot_chain_kernel", "pilot_mix_kernel", "pilot_chain_probe",
                   "pilot_sin_check", "wrap_fmod")


def short_name(mangled: str) -> str:
    """pilot.cu's function name in a mangled one, with its template
    argument (the probe's loop body: 0 the kernel's, 1 the earlier
    design's)."""
    import re

    for name in PILOT_FUNCTIONS:
        if name in mangled:
            m = re.search(name + r"IL[ib](\d)E", mangled)
            return name + (f"<{m.group(1)}>" if m else "")
    return mangled


def sass_loops(sass: str, dump: Path) -> dict:
    """For each chain probe function in a cuobjdump -sass listing: the
    instructions of its longest backward-branch loop (its group of four
    steps), counted by opcode; the listing is written to ``dump``."""
    import re

    dump.write_text(sass)
    out = {}
    for fn in sass.split("Function : ")[1:]:
        name = short_name(fn.split("\n", 1)[0].strip())
        if not name.startswith("pilot_chain_probe"):
            continue
        insns = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                           r"([A-Z][A-Z0-9_.]*)([^;]*);", fn)
        addr = {int(a, 16): k for k, (a, _, _) in enumerate(insns)}
        best = None
        for k, (a, op, rest) in enumerate(insns):
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m:
                lo = addr.get(int(m.group(1), 16))
                if lo is not None and lo < k and (best is None
                                                  or k - lo > best[1] - best[0]):
                    best = (lo, k)
        if best is None:
            continue
        ops = {}
        for _, op, _ in insns[best[0]:best[1] + 1]:
            key = op.split(".")[0]
            ops[key] = ops.get(key, 0) + 1
        out[name] = {"loop_instructions": best[1] - best[0] + 1,
                     "steps_per_loop": 4, "by_opcode": ops}
    return out


def pilot_sass(src: str, include: Path, tag: str, sass_dir: Path) -> dict:
    """Registers and stack frames of csrc/pilot.cu's kernels and the
    loop of each chain probe."""
    import re

    from phantomsdr_tpu_torch.ops.cuda.build import BUILD_DIR, nvcc_path

    name = f"pilot_sass_{tag}"
    build({name: src}, include, verbose=True)
    cuobjdump = str(Path(nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(BUILD_DIR / f"lib{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    sass_dir.mkdir(parents=True, exist_ok=True)
    ptxas = {}
    current = None
    for line in PTXAS[name].splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and current:
            ptxas.setdefault(current, {})["stack_frame_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            ptxas.setdefault(current, {})["registers"] = int(m.group(1))
    # convergence barriers (BSSY) per function: a data-dependent branch
    # that the compiler keeps able to reconverge costs the chain cycles
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        ptxas.setdefault(name, {})["convergence_barriers"] = fn.count("BSSY")
    return {"source": tag,
            "ptxas": {short_name(k): v for k, v in ptxas.items()},
            "probe_loops": sass_loops(sass, sass_dir / f"pilot_{tag}.sass")}


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


def pilot_case():
    """K-PILOT at the wideband WBFM step's shape: 128 channels of 40,272
    MPX-like samples at 192 kHz (pilot, stereo DSB, noise; every third
    channel not FM), the pilot bandpassed from them, phases in [0, 6)."""
    import math

    import torch

    from phantomsdr_tpu_torch.ops.polyphase import fir
    from phantomsdr_tpu_torch.ops.stereo import make_stereo_params

    c, n, fs = 128, 8 * 5034, 192000
    gen = torch.Generator(device="cuda").manual_seed(11)
    t = torch.arange(n, device="cuda", dtype=torch.float32) / fs
    th = 2 * math.pi * 19000.0 * t + torch.rand(c, 1, device="cuda",
                                                generator=gen) * 6
    x = (0.3 * torch.sin(2 * math.pi * 800 * t) + 0.09 * torch.cos(th)
         + 0.2 * torch.sin(2 * math.pi * 1300 * t) * torch.cos(2 * th)
         + 0.02 * torch.randn(c, n, device="cuda", generator=gen))
    sp = make_stereo_params(fs)
    y = fir(torch.cat([torch.zeros(c, sp.taps.shape[0] - 1, device="cuda"),
                       x], 1), sp.taps).contiguous()
    fm = torch.arange(c, device="cuda") % 3 != 1
    phase0 = torch.rand(c, device="cuda", generator=gen) * 6
    return y, x.contiguous(), fm, phase0, torch.zeros(c, device="cuda"), sp.f_nom


def compare(parent: Path) -> dict:
    """The parent's K-AGC, K-PILOT, K-NR, K-ANR and K-NB against the package's
    on the same inputs (equal bit for bit), and both timed in turns."""
    import torch

    from chip_smoke import device_ms, kernel_ms
    from phantomsdr_tpu_torch.ops.cuda import pilot
    from phantomsdr_tpu_torch.ops.cuda.build import stream_and_device

    libs = build({f"parent_{name}": (parent / f"{name}.cu").read_text()
                  for name in ("agc", "pilot", "anr", "nb", "nr")}, parent)
    res = {"nr": compare_nr(libs["parent_nr"]), "anr": compare_anr(libs["parent_anr"]),
           "nb": compare_nb(libs["parent_nb"])}
    for case in ("bench_int16", "wbfm_float"):
        state, x, params, fm = agc_case(case)
        run_parent, got = agc_call(agc_launcher(libs["parent_agc"], fm), state,
                                   x, params, fm)
        run_parent()
        torch.cuda.synchronize()
        if not same(got, package_agc(state, x, params, fm)):
            raise AssertionError(f"K-AGC {case}: the parent's output differs")

        def run_package():
            package_agc(state, x, params, fm)

        t = [kernel_ms(f) for f in (run_parent, run_package, run_package,
                                    run_parent)]
        res[f"agc_{case}"] = {"equal_bit_for_bit": True,
                              "parent_kernel_ms": [t[0], t[3]],
                              "kernel_ms": [t[1], t[2]]}

    y, xs, fm, phase0, freq0, f_nom = pilot_case()
    c, n = y.shape
    raw = libs["parent_pilot"].pilot_launch
    raw.argtypes = pilot.KERNEL.argtypes
    raw.restype = ctypes.c_int
    out = [torch.empty_like(y), torch.empty_like(phase0), torch.empty_like(freq0),
           y.new_empty((2 * c, n))]
    stream, dev = stream_and_device(y)

    def run_parent():
        rc = raw(y.data_ptr(), phase0.data_ptr(), freq0.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                 xs.data_ptr(), fm.data_ptr(), out[3].data_ptr(), None, None, c,
                 n, *pilot._loop_args(f_nom), dev, stream)
        if rc != 0:
            raise RuntimeError(f"parent pilot_launch failed: {rc}")

    def run_package():
        return pilot.pilot_mix(phase0, freq0, f_nom, y, xs=xs, fm_mask=fm)

    run_parent()
    phase, freq, ph, lr, _ = run_package()
    torch.cuda.synchronize()
    if not (torch.equal(out[0], ph) and torch.equal(out[1], phase)
            and torch.equal(out[2], freq) and torch.equal(out[3], lr)):
        raise AssertionError("K-PILOT: the parent's output differs")
    probe = libs["parent_pilot"].pilot_chain_probe_launch
    probe.argtypes = pilot.KERNEL.probe_argtypes
    probe.restype = ctypes.c_int
    pp, pf = torch.empty_like(phase0), torch.empty_like(freq0)

    def parent_probe():
        assert probe(y.data_ptr(), phase0.data_ptr(), freq0.data_ptr(),
                     pp.data_ptr(), pf.data_ptr(), c, n,
                     *pilot._loop_args(f_nom), pilot.BODY_KERNEL, dev,
                     stream) == 0

    def body(b):
        return lambda: pilot.chain_probe(y, phase0, freq0, f_nom, b)

    t = [kernel_ms(f) for f in (run_parent, run_package, run_package,
                                run_parent)]
    floors = {"parent": [], "earlier": [], "kernel": []}
    order = [("parent", parent_probe), ("earlier", body(pilot.BODY_EARLIER)),
             ("kernel", body(pilot.BODY_KERNEL))]
    for name, fn in order + order[::-1]:
        floors[name].append(device_ms(fn))
    res["pilot"] = {"shape": [c, n], "equal_bit_for_bit": True,
                    "parent_kernel_ms": [t[0], t[3]], "kernel_ms": [t[1], t[2]],
                    "chain_floor_ms": floors}
    return res


def in_turns(parent_fn, package_fn) -> tuple[list, list]:
    """kernel_ms of the parent's and the package's calls in turns
    (parent, package, package, parent)."""
    from chip_smoke import kernel_ms

    t = [kernel_ms(f) for f in (parent_fn, package_fn, package_fn, parent_fn)]
    return [t[0], t[3]], [t[1], t[2]]


def compare_anr(lib) -> dict:
    """The parent's K-ANR against the package's at chip_smoke.py's shape
    over two calls that carry the state (outputs and carries equal bit
    for bit), then both and their chain probes timed in turns."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import anr

    state, x, lms = anr_case()
    c, t = x.shape
    x2 = torch.roll(x, 1000, 1).contiguous()
    st = state
    for k, xs in enumerate((x, x2)):
        run, got = anr_raw_call(lib.anr_launch, st, xs, lms)
        run()
        new, out = anr.lms_blocks(*st, xs, *lms)
        torch.cuda.synchronize()
        if not same(got, (*new, out)):
            raise AssertionError(f"K-ANR call {k + 1}: the parent's output differs")
        st = new
    run_parent, _ = anr_raw_call(lib.anr_launch, state, x, lms)
    probe_parent, _ = anr_raw_call(lib.anr_chain_probe_launch, state, x, lms)
    parent_ms, package_ms = in_turns(run_parent, lambda: anr.lms_blocks(*state, x, *lms))
    parent_floor, floor = in_turns(probe_parent, lambda: anr.chain_probe(*state, x, *lms))
    return {"shape": [c, t], "equal_bit_for_bit": True, "chained_calls": 2,
            "parent_kernel_ms": parent_ms, "kernel_ms": package_ms,
            "parent_chain_floor_ms": parent_floor, "chain_floor_ms": floor}


def compare_nb(lib) -> dict:
    """The parent's K-NB launches against the package's at chip_smoke.py's
    shape (lpcs, coef_f, coef_b_rev, the repaired buffer, count,
    positions and thr equal bit for bit), then both timed in turns: the
    two launches of a call, and the repair chain probes."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import nb

    case = nb_case()
    wb, temp, lpcs, cf, cb, t, order, il, thresh = case
    runs, got = nb_raw_calls(lib, case)
    for fn in runs:
        fn()
    want = package_nb(case)
    torch.cuda.synchronize()
    for name, a, b in (("LPC fit", got[0], want[0]), ("repairs", got[1], want[1])):
        if not same(a, b):
            raise AssertionError(f"K-NB {name}: the parent's output differs")
    counts = got[1][1]

    def run_parent():
        runs[0]()
        runs[1]()

    def run_lpc():
        nb.lpc_coeffs(wb, t, order, il)

    def run_repair():
        nb.repair(wb, temp, lpcs, cf, cb, thresh, order, il)

    def run_package():
        run_lpc()
        run_repair()

    parent_ms, package_ms = in_turns(run_parent, run_package)
    lpc_parent, lpc_ms = in_turns(runs[0], run_lpc)
    rep_parent, rep_ms = in_turns(runs[1], run_repair)
    parent_floor, floor = in_turns(runs[2], lambda: nb.repair_chain_probe(
        wb, temp, lpcs, cf, cb, order, il))
    return {"shape": list(wb.shape), "equal_bit_for_bit": True,
            "impulses": [int(counts.min()), int(counts.max())],
            "parent_kernel_ms": parent_ms, "kernel_ms": package_ms,
            "parent_lpc_ms": lpc_parent, "lpc_ms": lpc_ms,
            "parent_repair_ms": rep_parent, "repair_ms": rep_ms,
            "parent_chain_floor_ms": parent_floor, "chain_floor_ms": floor}


ANR_RUN = "constexpr int kRun = 3;"
ANR_LOOPS = ("    for (; j + kGroup <= taps; j += kGroup) {\n",
             "    for (; n + kGroup <= len; n += kGroup) {\n")
# copies of csrc/anr.cu: (text, its replacement) pairs
ANR_VARIANTS = {
    **{f"krun_{k}": [(ANR_RUN, f"constexpr int kRun = {k};")] for k in (1, 2, 3, 4, 5, 6, 8)},
    "loops_not_unrolled": [(loop, "#pragma unroll 1\n" + loop) for loop in ANR_LOOPS],
}


def anr_variants() -> dict:
    """K-ANR's kernel ms (kernel_ms) at chip_smoke.py's shape in copies
    of csrc/anr.cu: kRun adjacent chains a thread (1, 2, 3 as built,
    5), and the group loops kept from further unrolling; each copy's
    outputs must equal the package kernel's (every sum keeps its
    order)."""
    import torch

    from chip_smoke import kernel_ms
    from phantomsdr_tpu_torch.ops.cuda import anr
    from phantomsdr_tpu_torch.ops.cuda.build import CSRC

    src = (CSRC / "anr.cu").read_text()
    texts = {}
    for name, subs in ANR_VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"csrc/anr.cu changed: {old!r}")
            text = text.replace(old, new)
        texts[f"anr_{name}"] = text
    libs = build(texts)
    state, x, lms = anr_case()
    new, out = anr.lms_blocks(*state, x, *lms)
    res = {}
    for name in ANR_VARIANTS:
        run, got = anr_raw_call(libs[f"anr_{name}"].anr_launch, state, x, lms)
        run()
        torch.cuda.synchronize()
        if not same(got, (*new, out)):
            raise AssertionError(f"K-ANR {name} differs")
        res[f"{name}_kernel_ms"] = kernel_ms(run)
    return res


PILOT_DEPTH = "constexpr int kAhead = 8;"


def pilot_depths(depths=(2, 4, 8, 16)) -> dict:
    """K-PILOT's kernel ms (kernel_ms, one call's device work) at the
    WBFM shape with its register ring kAhead groups deep, from copies of
    csrc/pilot.cu; each copy's outputs must equal the package kernel's."""
    import torch

    from chip_smoke import kernel_ms
    from phantomsdr_tpu_torch.ops.cuda import pilot
    from phantomsdr_tpu_torch.ops.cuda.build import CSRC, stream_and_device

    src = (CSRC / "pilot.cu").read_text()
    if src.count(PILOT_DEPTH) != 1:
        raise RuntimeError("csrc/pilot.cu changed: its ring depth line")
    libs = build({f"pilot_ahead{k}": src.replace(
        PILOT_DEPTH, f"constexpr int kAhead = {k};") for k in depths})
    y, _, _, phase0, freq0, f_nom = pilot_case()
    c, n = y.shape
    phase, freq, ph, _, _ = pilot.pilot_mix(phase0, freq0, f_nom, y)
    stream, dev = stream_and_device(y)
    res = {}
    for k in depths:
        fn = libs[f"pilot_ahead{k}"].pilot_launch
        fn.argtypes = pilot.KERNEL.argtypes
        fn.restype = ctypes.c_int
        out = [torch.empty_like(y), torch.empty_like(phase0), torch.empty_like(freq0)]

        def run(fn=fn, out=out):
            assert fn(y.data_ptr(), phase0.data_ptr(), freq0.data_ptr(),
                      *(o.data_ptr() for o in out), None, None, None, None,
                      None, c, n, *pilot._loop_args(f_nom), dev, stream) == 0

        run()
        torch.cuda.synchronize()
        if not (torch.equal(out[0], ph) and torch.equal(out[1], phase)
                and torch.equal(out[2], freq)):
            raise AssertionError(f"K-PILOT with kAhead {k} differs")
        res[f"kahead_{k}_kernel_ms"] = kernel_ms(run)
    return res


# K-ANR's and K-NB's phase stamps: threads 0 and 96 of each block
# accumulate the clock64 cycles between their stamps into the phase
# named by the stamp (the phases end at barriers, so thread 0's clock is
# its block's or its chain's; thread 96 is K-ANR's first producer).
# STAMP_END stores them at slot ``off`` + the block (+ 1024 for thread
# 96; 8 values a slot, the 8th the total).
NOISE_MACROS = r"""
__device__ long long g_stamps[8 * 8192];
#define STAMP_INIT const long long stamp0_ = clock64(); long long ph_[7] = {0, 0, 0, 0, 0, 0, 0}; long long tp_ = stamp0_;
#define PH(k) { const long long tn_ = clock64(); ph_[k] += tn_ - tp_; tp_ = tn_; }
#define STAMP_END(off) if (threadIdx.x % 32 == 0 && (threadIdx.x == 0 || threadIdx.x == STAMP_SECOND)) { long long* st_ = g_stamps + 8 * ((off) + (threadIdx.x ? 1024 : 0) + blockIdx.x); for (int k_ = 0; k_ < 7; ++k_) st_[k_] = ph_[k_]; st_[7] = clock64() - stamp0_; }
#ifndef STAMP_SECOND
#define STAMP_SECOND 96
#endif
"""
NOISE_READ = """
extern "C" int read_stamps(long long* host, int slots) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, sizeof(long long) * 8 * slots));
}
"""
# slots: K-ANR's kernel from 0, its probe from 4096; K-NB's LPC launch
# from 0, its repair launch from 2048, the repair probe from 4096
ANR_PROBE_SLOT, NB_REPAIR_SLOT, NB_PROBE_SLOT = 4096, 2048, 4096

# (anchor, text, before): one list per design of each source; the
# script takes the list whose anchors the source holds
ANR_STAMPS = {
    "slide": (["stage", "predict", "update", "combine", "slide"], [
        ("    const int tid = threadIdx.x;\n    const int hl = taps + a.delay;\n",
         "    STAMP_INIT\n", False),
        ("        n_last = nb;\n", "        PH(0);\n", False),
        ("        if (!kProbe || s == 0)\n"
         "            for (int n = tid; n < nb; n += kThreads) seg[lkeep + n] = "
         "a.x[row + s + n];\n        __syncthreads();\n", "        PH(1);\n", False),
        ("        if (__syncthreads_or(trig)) lidx = 120.0f;\n", "        PH(2);\n", False),
        ("            part[k] = g;\n        }\n        __syncthreads();\n",
         "        PH(3);\n", False),
        ("            w[t] = __fadd_rn(__fmul_rn(lam_b, w[t]), g);\n        }\n",
         "        PH(4);\n", False),
        ("    }\n    // carries: the newest", "        PH(5);\n", True),
        ("    if (tid == 0) {\n        a.lidx1[c] = lidx;\n",
         "    STAMP_END(kProbe ? 4096 : 0)\n", True),
    ]),
    "ring": (["segment hand-over", "predict: outputs + barrier", "update: stores + barrier",
             "combine", "predict: sums", "update: sums"], [
        ("    const float* xrow = a.x + row;\n", "    STAMP_INIT\n", False),
        ("    if (nsegs > 0) powers(0, tid, kThreads);\n    __syncthreads();\n",
         "    PH(0);\n", False),
        ("        if (chain_sync_or(trig)) lidx = 120.0f;\n", "        PH(2);\n", False),
        ("                if (t0 + j < taps) part[p * taps + t0 + j] = g[j];\n"
         "        }\n        chain_sync();\n", "        PH(3);\n", False),
        ("            w[t] = __fadd_rn(__fmul_rn(lam_b, w[t]), g);\n        }\n"
         "        chain_sync();\n", "        PH(4);\n", False),
        ("                powers(k + 1, rank, kProducers);\n", "                PH(5);\n", False),
        ("            sliding_sums<kRun, false>(seg + boff + taps - 1 + n0, w, taps, y);\n",
         "            PH(5);\n", False),
        ("            sliding_update<kRun>(c1 + p * cstride, seg + boff + taps - 1 - t0 + n0, "
         "n1 - n0, g);\n", "            PH(6);\n", False),
        ("        if (kProbe) break;\n    }\n", "        PH(1);\n", True),
        ("    // carries: the newest", "    STAMP_END(kProbe ? 4096 : 0)\n", True),
    ]),
}
NB_STAMPS = {
    "tiles": (["lags", "levinson", "forward", "backward"],
            ["statistics", "ballot", "search + copy", "repairs"], [
        ("    const float* base = wb + static_cast<long long>(c) * wlen + order + pl;\n",
         "    STAMP_INIT\n", False),
        ("        r[tid] = s;\n    }\n    __syncthreads();\n", "    PH(0);\n", False),
        ("            alfa = __fmul_rn(alfa, __fsub_rn(1.0f, __fmul_rn(k, k)));\n"
         "        }\n    }\n    __syncthreads();\n", "    PH(1);\n", False),
        ("            cf[i * order + tid] = v;\n        }\n        __syncthreads();\n    }\n",
         "    PH(2);\n", False),
        ("            cb[(il - 1 - i) * order + tid] = v;\n        }\n"
         "        __syncthreads();\n    }\n", "    PH(3);\n    STAMP_END(0)\n", False),
        ("    const int nwords = t > lo ? (t - lo + 31) / 32 : 0;\n",
         "    STAMP_INIT\n", False),
        ("            thr_s = __fmul_rn(thresh, __fsqrt_rn(__fmul_rn(sigma2, power)));\n"
         "        }\n        __syncthreads();\n", "        PH(0);\n", False),
        ("            if (lane == 0) masks[w] = m;\n        }\n        __syncthreads();\n",
         "        PH(1);\n", False),
        ("        for (int n = tid; n < wlen; n += kThreads) out[n] = orig[n];\n"
         "        __syncthreads();\n    }\n    __syncthreads();\n", "    PH(2);\n", False),
        ("    if (!kProbe) {\n        if (tid < kSlots)",
         "    PH(3);\n    STAMP_END(kProbe ? 4096 : 2048)\n", True),
    ]),
    "spans": (["lags", "levinson", "recursions"],
            ["statistics", "ballot", "search + spans", "backward", "repairs", "writeback"], [
        ("    const float* base = wb + static_cast<long long>(c) * wlen + order + pl;\n",
         "    STAMP_INIT\n", False),
        ("        r[tid] = s;\n    }\n    __syncthreads();\n", "    PH(0);\n", False),
        ("                out[m] = L[m];\n            }\n    }\n    __syncthreads();\n",
         "    PH(1);\n", False),
        ("            if (lane + 32 < order) row[lane + 32] = v1;\n        }\n    }\n",
         "    PH(2);\n    STAMP_END(0)\n", False),
        ("    float* res_s = with_res ? smem + lay.res : nullptr;\n", "    STAMP_INIT\n", False),
        ("            if (lane == 0) thr_s = __fmul_rn(thresh, __fsqrt_rn(__fmul_rn(sigma2, power)));\n"
         "        }\n        __syncthreads();\n", "        PH(0);\n", False),
        ("            if (lane == 0) masks[w] = m;\n        }\n        __syncthreads();\n",
         "        PH(1);\n", False),
        ("        cur_c[off_s[j] + e] = v;\n    }\n    __syncthreads();\n", "    PH(2);\n", False),
        ("        bpatch[k] = bp;\n    }\n    __syncthreads();\n", "    PH(3);\n", False),
        ("    // 7. the repaired buffer in one pass", "    PH(4);\n", True),
        ("    if (!kProbe) {\n        if (tid < kSlots)",
         "    PH(5);\n    STAMP_END(kProbe ? 4096 : 2048)\n", True),
    ]),
}


def stamped(src: str, designs: dict, what: str, macros: str = NOISE_MACROS
            ) -> tuple[str, str, tuple]:
    """The source with the stamps of the design whose anchors it holds:
    (design, instrumented source, phase names).  An anchor's third item
    says where its text goes: before it (True), after it (False), or in
    its place ("replace")."""
    for design, spec in designs.items():
        anchors = spec[-1]
        if all(src.count(a) == 1 for a, _, _ in anchors):
            for anchor, text, before in anchors:
                src = src.replace(anchor, text if before == "replace"
                                  else text + anchor if before else anchor + text)
            src = src.replace("namespace {\n", macros + "namespace {\n", 1)
            return design, src + NOISE_READ, spec[:-1]
    raise RuntimeError(f"{what}: no stamp design matches the source")


def anr_case():
    """K-ANR at chip_smoke.py's shape: 128 channels of 6480 samples (an
    800 Hz tone in noise, int16 scale), LMS NR at the defaults (taps 64,
    delay 8, 25 blocks of 256 and one of 80), the state of a first call."""
    import math

    import torch

    from phantomsdr_tpu_torch.ops.anr import block_size, init_anr_state, make_anr_params

    c, t = 128, 6480
    pa = make_anr_params(notch=False)
    gen = torch.Generator(device="cuda").manual_seed(13)
    tt = torch.arange(t, device="cuda") / 12000.0
    x = (3000 * torch.sin(2 * math.pi * 800 * tt
                          + torch.rand(c, 1, device="cuda", generator=gen))
         + 1000 * torch.randn(c, t, device="cuda", generator=gen)).contiguous()
    lms = (pa.taps, pa.delay, pa.two_mu, pa.gamma, pa.notch, block_size(pa, t))
    return tuple(init_anr_state(c, pa, "cuda")), x, lms


def anr_raw_call(fn, state, x, lms):
    """A callable that calls the ctypes launcher ``fn`` (K-ANR's C
    interface) on the case, and its outputs (hist, w, lidx, ngamma, out)."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import anr
    from phantomsdr_tpu_torch.ops.cuda.build import stream_and_device

    taps, delay, two_mu, gamma, notch, bsz = lms
    c, t = x.shape
    out = torch.empty_like(x)
    new = tuple(torch.empty_like(v) for v in state)
    stream, dev = stream_and_device(x)
    fn.argtypes = anr.KERNEL.argtypes
    fn.restype = ctypes.c_int
    args = (x.data_ptr(), *(v.data_ptr() for v in state), out.data_ptr(),
            *(v.data_ptr() for v in new), c, t, taps, delay, bsz, int(notch),
            float(np.float32(two_mu)), float(np.float32(gamma)), dev, stream)

    def run():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"K-ANR launch failed: {rc}")

    return run, (*new, out)


def nb_case():
    """K-NB at chip_smoke.py's shape: 128 channels, a frame of 6480
    samples with clicks (chip_smoke.click_rows), order 32, il 11, the
    state of a first call; the residual from the package's launch 1 and
    FIRs.  (wb, temp, lpcs, coef_f, coef_b_rev, t, order, il, thresh)."""
    import torch

    from chip_smoke import click_rows
    from phantomsdr_tpu_torch.ops import nb as nbm
    from phantomsdr_tpu_torch.ops.cuda import nb

    c, t = 128, 6480
    pn = nbm.make_nb_params()
    order, il = pn.taps, pn.impulse_len
    lo = order + (il - 1) // 2
    gen = torch.Generator(device="cuda").manual_seed(17)
    xs = click_rows(c, t, gen)
    wb = torch.cat([nbm.init_nb_state(c, pn, "cuda").tail, xs], 1).contiguous()
    lpcs, cf, cb = nb.lpc_coeffs(wb, t, order, il)
    temp = nbm.fir_fresh(lpcs, nbm.fir_fresh(lpcs.flip(1), wb[:, lo:lo + t])).contiguous()
    return wb, temp, lpcs, cf, cb, t, order, il, pn.thresh


def nb_raw_calls(lib, case):
    """Callables that call a library's K-NB launchers (the package's C
    interfaces) on the case: (run_lpc, run_repair, run_probe) and their
    outputs ((lpcs, coef_f, coef_b_rev), (wbf, count, positions, thr),
    probe buffer)."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import nb
    from phantomsdr_tpu_torch.ops.cuda.build import stream_and_device

    wb, temp, lpcs, cf, cb, t, order, il, thresh = case
    c, wlen = wb.shape
    stream, dev = stream_and_device(wb)
    fl, fr, fp = lib.nb_lpc_launch, lib.nb_repair_launch, lib.nb_repair_chain_probe_launch
    for fn, kernel, probe in ((fl, nb.LPC_KERNEL, False), (fr, nb.REPAIR_KERNEL, False),
                              (fp, nb.REPAIR_KERNEL, True)):
        fn.argtypes = kernel.probe_argtypes if probe else kernel.argtypes
        fn.restype = ctypes.c_int
    lout = (torch.empty_like(lpcs), torch.empty_like(cf), torch.empty_like(cb))
    rout = (torch.empty_like(wb), torch.empty(c, dtype=torch.int32, device="cuda"),
            torch.empty(c, nb.N_IMPULSE_COUNT, dtype=torch.int32, device="cuda"),
            torch.empty(c, device="cuda"))
    pout = wb.clone()

    def checked(rc, what):
        if rc != 0:
            raise RuntimeError(f"K-NB {what} failed: {rc}")

    def run_lpc():
        checked(fl(wb.data_ptr(), *(v.data_ptr() for v in lout), c, wlen, t, order, il,
                   dev, stream), "nb_lpc_launch")

    def run_repair():
        checked(fr(wb.data_ptr(), temp.data_ptr(), lpcs.data_ptr(), cf.data_ptr(),
                   cb.data_ptr(), *(v.data_ptr() for v in rout), c, wlen, t, order, il,
                   float(np.float32(thresh)), dev, stream), "nb_repair_launch")

    def run_probe():
        checked(fp(wb.data_ptr(), cf.data_ptr(), cb.data_ptr(), pout.data_ptr(),
                   temp.data_ptr(), c, wlen, t, order, il, dev, stream),
                "nb_repair_chain_probe_launch")

    return (run_lpc, run_repair, run_probe), (lout, rout, pout)


def package_nb(case):
    """The package kernels' outputs on the case: ((lpcs, coef_f,
    coef_b_rev), (wbf, count, positions, thr), probe buffer)."""
    from phantomsdr_tpu_torch.ops.cuda import nb

    wb, temp, lpcs, cf, cb, t, order, il, thresh = case
    return (nb.lpc_coeffs(wb, t, order, il),
            nb.repair(wb, temp, lpcs, cf, cb, thresh, order, il),
            nb.repair_chain_probe(wb, temp, lpcs, cf, cb, order, il))


def phase_table(stamps: np.ndarray, names, per: float = 1.0) -> dict:
    """Median over the blocks of each named phase's cycles (divided by
    ``per``), and of the total."""
    res = {name: float(np.median(stamps[:, k])) / per for k, name in enumerate(names)}
    res["total"] = float(np.median(stamps[:, 7])) / per
    return res


def anr_phases(src: str, include: Path, tag: str) -> dict:
    """K-ANR's phase cycles at chip_smoke.py's shape, from an instrumented
    copy of the source text ``src``; its outputs must equal the package
    kernel's."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import anr

    design, text, (names,) = stamped(src, ANR_STAMPS, "csrc/anr.cu")
    lib = build({f"anr_stamped_{tag}": text}, include)[f"anr_stamped_{tag}"]
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    state, x, lms = anr_case()
    c, t = x.shape
    blocks = -(-t // lms[-1])
    run, got = anr_raw_call(lib.anr_launch, state, x, lms)
    probe, _ = anr_raw_call(lib.anr_chain_probe_launch, state, x, lms)
    for _ in range(3):
        run()
        probe()
    torch.cuda.synchronize()
    stamps = np.zeros((ANR_PROBE_SLOT + c, 8), np.int64)
    lib.read_stamps(stamps.ctypes.data, ANR_PROBE_SLOT + c)
    new, out = anr.lms_blocks(*state, x, *lms)
    if not same(got, (*new, out)):
        raise AssertionError(f"instrumented K-ANR ({tag}) differs from the package kernel")
    res = {"source": tag, "design": design, "shape": [c, t], "blocks": blocks,
           "cycles_per_block": phase_table(stamps[:c], ["other"] + names, blocks),
           "cycles_total": float(np.median(stamps[:c, 7])),
           "probe_cycles_per_block": phase_table(stamps[ANR_PROBE_SLOT:ANR_PROBE_SLOT + c],
                                                 ["other"] + names, blocks),
           "equal_to_package_kernel": True}
    if design == "ring":
        # thread 96, the first producer: its cycles a segment
        segs = -(-t // anr.segment_len(lms[-1]))
        res["producer_cycles_per_segment"] = phase_table(
            stamps[1024:1024 + c], ["prologue", "waiting at hand-over", "", "", "",
                                    "staging + window powers"], segs)
        res["producer_cycles_per_segment"].pop("")
    return res


def nb_phases(src: str, include: Path, tag: str) -> dict:
    """K-NB's phase cycles (each launch) at chip_smoke.py's shape, from an
    instrumented copy of the source text ``src``; its outputs must equal
    the package kernels'."""
    import torch

    design, text, (lpc_names, repair_names) = stamped(src, NB_STAMPS, "csrc/nb.cu")
    lib = build({f"nb_stamped_{tag}": text}, include)[f"nb_stamped_{tag}"]
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    case = nb_case()
    c = case[0].shape[0]
    runs, got = nb_raw_calls(lib, case)
    for _ in range(3):
        for fn in runs:
            fn()
    torch.cuda.synchronize()
    stamps = np.zeros((NB_PROBE_SLOT + c, 8), np.int64)
    lib.read_stamps(stamps.ctypes.data, NB_PROBE_SLOT + c)
    want = package_nb(case)
    if not (same(got[0], want[0]) and same(got[1], want[1]) and torch.equal(got[2], want[2])):
        raise AssertionError(f"instrumented K-NB ({tag}) differs from the package kernels")
    counts = got[1][1]
    return {"source": tag, "design": design, "shape": list(case[0].shape),
            "impulses_median": float(counts.float().median()),
            "lpc_cycles": phase_table(stamps[:c], lpc_names),
            "repair_cycles": phase_table(stamps[NB_REPAIR_SLOT:NB_REPAIR_SLOT + c],
                                         repair_names),
            "probe_cycles": phase_table(stamps[NB_PROBE_SLOT:NB_PROBE_SLOT + c],
                                        repair_names),
            "equal_to_package_kernel": True}


# K-NR's stamps.  Each warp's lane 0 adds the clock64 cycles between its
# stamps into the phase the stamp names, over the whole call, and stores
# them at slot ``off`` + the warp (8 values a slot, the 8th the total).
# DEP(v) folds v into a register (slot 6, no phase), so that the next
# stamp waits for v (an instruction issues only when its operands are
# ready): each phase then ends when its values exist, and the stamped copy runs its parts
# one after the other.  With NR_TOTAL_ONLY the copy keeps the first and
# the last stamp alone (the loop's cycles, unperturbed).  g_nr_frames
# counts the warp-frames run (index 1) and those redone on the exact
# path (index 0).
NR_MACROS = r"""
__device__ long long g_stamps[8 * 8192];
__device__ unsigned long long g_nr_frames[4];
#define STAMP_INIT const long long stamp0_ = clock64(); long long ph_[7] = {0, 0, 0, 0, 0, 0, 0}; long long tp_ = stamp0_;
#ifdef NR_TOTAL_ONLY
#define PH(k) {}
#define DEP(v) {}
#else
#define PH(k) { const long long tn_ = clock64(); ph_[k] += tn_ - tp_; tp_ = tn_; }
#define DEP(v) { ph_[6] ^= __float_as_uint(v); }
#endif
#define NR_COUNT(k, n) if ((threadIdx.x & 31) == 0) atomicAdd(&g_nr_frames[k], static_cast<unsigned long long>(n));
#define NR_END(off) if ((threadIdx.x & 31) == 0) { long long* st_ = g_stamps + 8 * ((off) + (blockIdx.x * blockDim.x + threadIdx.x) / 32); for (int k_ = 0; k_ < 7; ++k_) st_[k_] = ph_[k_]; st_[7] = clock64() - stamp0_; }
"""
NR_READ = """
extern "C" int read_nr_frames(unsigned long long* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_nr_frames, sizeof(g_nr_frames)));
}
extern "C" int reset_nr_frames() {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_nr_frames, zero, sizeof(zero)));
}
"""
NR_STAMPS = {
    # the first design: one frame at a time, its divisions and square root
    # branching to their slow paths
    "frame": (["load wait", "frame", "stores"], [
        ("    int stage = stage0[c];\n    Carry s{nest0[idx], xt0[idx], pslp0[idx], hk0[idx]};\n",
         "    STAMP_INIT\n", False),
        ("        g_run[at] = frame(k, stage, s, x_pow[at], running);\n",
         "        const float xv_ = x_pow[at]; DEP(xv_) PH(0)\n"
         "        const float gv_ = frame(k, stage, s, xv_, running); DEP(gv_) DEP(s.xt) PH(1)\n"
         "        NR_COUNT(1, 1)\n        g_run[at] = gv_;\n", "replace"),
        ("        if (lead) running_out[static_cast<long long>(i) * channels + c] = running;\n",
         "        PH(2)\n", False),
        ("    if (lead) stage1[c] = stage;\n", "    NR_END(0)\n", True),
    ]),
    # groups of kGroup frames, each frame's tail stages between the next
    # frame's head stages; in the stamped copy each stage waits for its
    # inputs before the next stamp, so the parts run one after the other
    "groups": (["load wait", "xt head", "hk tail", "range test + vote + exact redo",
                "stores"], [
        ("    issue(0);\n    issue(1);\n", "    STAMP_INIT\n", False),
        ("bool (&run)[kGroup], int first", ", long long* ph_, long long& tp_", False),
        ("frames<kGroup, true>(k, s, xq, g, run, 0", ", ph_, tp_", False),
        ("frames<kGroup, false>(k, s, xq, g, run, 0", ", ph_, tp_", False),
        ("frames<1, false>(k, s, xq, g, run, j", ", ph_, tp_", False),
        ("        fetch(q);\n", "#pragma unroll\n        for (int j = 0; j < kGroup; ++j) DEP(xq[j])\n"
         "        PH(0)\n", False),
        ("    Frame f[kN];\n", "    NR_COUNT(1, kN)\n", False),
        ("    h2<true, kSteady>(k, s, f[0]);\n", "    DEP(f[0].snr_post) PH(1)\n", False),
        ("        h1<true, kSteady>(k, s, f[j]);\n", "        DEP(f[j].e) PH(1)\n", False),
        ("        t2<true>(f[j - 1]);\n", "        DEP(f[j - 1].w) PH(2)\n", False),
        ("        h2<true, kSteady>(k, s, f[j]);\n", "        DEP(f[j].snr_post) PH(1)\n", False),
        ("        g[first + j - 1] = t3<true, kSteady>(s, f[j - 1]);\n", "        DEP(s.hk) PH(2)\n",
         False),
        ("    g[first + kN - 1] = t3<true, kSteady>(s, f[kN - 1]);\n", "    DEP(s.hk) PH(2)\n",
         False),
        ("    if (__any_sync(kFull, !ok)) {\n        s = saved;\n", "        NR_COUNT(0, kN)\n",
         False),
        ("    for (int j = 0; j < kN; ++j) run[first + j] = f[j].running;\n",
         "    DEP(s.hk) DEP(s.xt) PH(3)\n", False),
        ("        for (int j = 0; j < kGroup; ++j) store(j);\n", "        PH(4)\n", False),
        ("            store(j);\n        }\n", "            PH(4)\n", False),
        ("    if (!live) return;\n    if (lead && !kProbe) stage1[chan] = s.stage;\n",
         "    NR_END(kProbe ? 4096 : 0)\n", True),
    ]),
}


def nr_case(silent_every: int = 0, seed: int = 19):
    """K-NR at chip_smoke.py's shape: the frame powers [36, 128, 180] of
    two steps of tone-and-noise streams (an AM-like tone on every other
    channel from 0.3 s), from a fresh state: (carries after the first
    step, params, the second step's powers, the first step's powers, the
    fresh carries).  ``silent_every``: every such channel carries zeros
    (an idle slot of the server) from the start."""
    import math

    import torch

    from phantomsdr_tpu_torch.ops.cuda import nr
    from phantomsdr_tpu_torch.ops.nr import frame_spectra, init_nr_state, make_nr_params

    c, n, f = 128, 36, 180
    t = n * f
    p = make_nr_params(f)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tt = torch.arange(2 * t, device="cuda") / 12000.0
    gate = (torch.arange(c, device="cuda")[:, None] % 2) * (tt > 0.3)
    x = (6000 * torch.sin(2 * math.pi * 700 * tt)[None] * gate
         + 1500 * torch.randn(c, 2 * t, device="cuda", generator=gen))
    if silent_every:
        x[::silent_every] = 0.0
    win = torch.from_numpy(p.window).to("cuda")
    st = init_nr_state(c, f, "cuda")
    cur, _, xp0 = frame_spectra(st.last_in, win, x[:, :t], n)
    _, _, xp1 = frame_spectra(cur[-1], win, x[:, t:], n)
    fresh = (st.stage, st.nest, st.xt, st.pslp, st.hk_old)
    carries, _, _ = nr.gain_frames(fresh, p.alpha, p.xih1r, p.pfac, xp0)
    return carries, p, xp1.contiguous(), xp0.contiguous(), fresh


def nr_raw_call(fn, carries, p, xp, probe: bool = False):
    """A callable that calls K-NR's ctypes launcher ``fn`` (the package's
    C interface; ``probe``: the chain probe's) on the case, and its
    outputs (stage, nest, xt, pslp, hk_old, g_run, running; the probe's:
    nest, xt, pslp, hk_old)."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import nr
    from phantomsdr_tpu_torch.ops.cuda.build import stream_and_device

    n, c, f = xp.shape
    stream, dev = stream_and_device(xp)
    fn.argtypes = nr.KERNEL.probe_argtypes if probe else nr.KERNEL.argtypes
    fn.restype = ctypes.c_int
    floats = tuple(torch.empty_like(t) for t in carries[1:])
    if probe:
        outs = floats
        args = (xp.data_ptr(), *(t.data_ptr() for t in carries),
                *(t.data_ptr() for t in floats), n, c, f,
                *nr._consts(p.alpha, p.xih1r, p.pfac), dev, stream)
    else:
        outs = (torch.empty_like(carries[0]), *floats, torch.empty_like(xp),
                torch.empty((n, c), dtype=torch.bool, device="cuda"))
        args = (xp.data_ptr(), *(t.data_ptr() for t in carries), outs[5].data_ptr(),
                outs[6].data_ptr(), outs[0].data_ptr(), *(t.data_ptr() for t in floats),
                n, c, f, *nr._consts(p.alpha, p.xih1r, p.pfac), dev, stream)

    def run():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"K-NR launch failed: {rc}")

    return run, outs


def package_nr(carries, p, xp):
    """The package kernel's (stage, nest, xt, pslp, hk_old, g_run,
    running) on the case."""
    from phantomsdr_tpu_torch.ops.cuda import nr

    new, g, run = nr.gain_frames(carries, p.alpha, p.xih1r, p.pfac, xp)
    return (*new, g, run)


def nr_edge_cases():
    """(name, carries, params, [powers of two chained calls]) at the
    shapes the card tests use (F 1, 257 and 5034, frames 7 to 25) and at
    the bench shape with silent, subnormal and zero-power channels from a
    fresh state."""
    import torch

    from phantomsdr_tpu_torch.ops.nr import make_nr_params

    cases = []
    for c, f, n in ((5, 257, 7), (3, 5034, 8), (1, 1, 25), (40, 33, 9)):
        g = torch.Generator(device="cuda").manual_seed(c * f + n)
        x_pow = (1 - torch.rand(2 * n, c, f, device="cuda", generator=g)).log().neg() * 1e6
        x_pow[:, :, 0] = 0.0
        stage = (torch.arange(c, device="cuda", dtype=torch.int32) * 7) % 22
        carries = (stage,) + tuple(torch.rand(c, f, device="cuda", generator=g) * s
                                   for s in (1e6, 1e6, 0.5, 3.0))
        cases.append((f"{c}x{f}x{n}", carries, make_nr_params(max(f, 2)),
                      [x_pow[:n].contiguous(), x_pow[n:].contiguous()]))
    _, p, xp1, xp0, fresh = nr_case(silent_every=3)
    sub = xp0.clone()
    sub[:, 1::3] = 1e-40 * (1 + torch.arange(180, device="cuda"))
    cases.append(("bench_silent_rows", fresh, p, [xp0, xp1]))
    cases.append(("bench_subnormal_rows", fresh, p, [sub, xp1]))
    return cases


def compare_nr(lib) -> dict:
    """The parent's K-NR against the package's over two calls that carry
    the state, at the bench shape and at nr_edge_cases (every output equal
    bit for bit), then both and their chain probes timed in turns at the
    bench shape."""
    import torch

    from phantomsdr_tpu_torch.ops.cuda import nr

    carries, p, xp, _, _ = nr_case()
    cases = [("bench", carries, p, [xp, xp.flip(0).contiguous()])] + nr_edge_cases()
    for name, car, pp, xps in cases:
        for k, x in enumerate(xps):
            run, got = nr_raw_call(lib.nr_launch, car, pp, x)
            run()
            want = package_nr(car, pp, x)
            torch.cuda.synchronize()
            if not same(got, want):
                raise AssertionError(f"K-NR {name} call {k + 1}: the parent's output differs")
            car = want[:5]
    run_parent, _ = nr_raw_call(lib.nr_launch, carries, p, xp)
    probe_parent, _ = nr_raw_call(lib.nr_chain_probe_launch, carries, p, xp, probe=True)
    parent_ms, package_ms = in_turns(run_parent, lambda: nr.gain_frames(
        carries, p.alpha, p.xih1r, p.pfac, xp))
    parent_floor, floor = in_turns(probe_parent, lambda: nr.chain_probe(
        carries, p.alpha, p.xih1r, p.pfac, xp))
    return {"shape": list(xp.shape), "equal_bit_for_bit": True, "chained_calls": 2,
            "cases": [c[0] for c in cases],
            "parent_kernel_ms": parent_ms, "kernel_ms": package_ms,
            "parent_chain_floor_ms": parent_floor, "chain_floor_ms": floor}


def nr_phases(src: str, include: Path, tag: str) -> dict:
    """K-NR's cycles a frame by part at chip_smoke.py's shape (median over
    the warps of their lane 0), and the share of warp-frames the exact
    path ran, from an instrumented copy of the source text ``src`` (and a
    copy stamped only at the loop's ends: ``cycles_per_frame_unstamped``);
    on the bench case and on it with every third channel silent from a
    fresh state.  Outputs must equal the package kernel's."""
    import torch

    design, text, (names,) = stamped(src, NR_STAMPS, "csrc/nr.cu", NR_MACROS)
    text += NR_READ
    copies = {f"nr_stamped_{tag}": text, f"nr_total_{tag}": "#define NR_TOTAL_ONLY\n" + text}
    if design == "groups":
        # timing only (its gains are the snr_post): the xt head chains
        # without the hk tails
        head = "#define NR_TOTAL_ONLY\n" + text
        for old_, new_ in NR_HEAD_ONLY:
            if head.count(old_) != 1:
                raise RuntimeError("csrc/nr.cu changed: its tail stages")
            head = head.replace(old_, new_)
        copies[f"nr_head_{tag}"] = head
    libs = build(copies, include)
    res = {"source": tag, "design": design}
    carries, p, xp, _, _ = nr_case()
    _, ps, xs1, xs0, fresh = nr_case(silent_every=3)
    for case, car, pp, x in (("bench", carries, p, xp), ("silent_rows", fresh, ps, xs0)):
        n, c, f = x.shape
        kinds = {"thread": slice(None)}
        warps = -(-c * f // 32) * len(kinds)
        out = {}
        for which, lib in (("stamped", libs[f"nr_stamped_{tag}"]),
                           ("unstamped", libs[f"nr_total_{tag}"])):
            lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.read_nr_frames.argtypes = [ctypes.c_void_p]
            run, got = nr_raw_call(lib.nr_launch, car, pp, x)
            run()
            want = package_nr(car, pp, x)
            torch.cuda.synchronize()
            if not same(got, want):
                names_ = ("stage", "nest", "xt", "pslp", "hk_old", "g_run", "running")
                raise AssertionError(
                    f"instrumented K-NR ({tag}, {case}, {which}) differs from the package "
                    f"kernel: {[(nm, int((a != b).sum())) for nm, a, b in zip(names_, got, want)]}")
            assert lib.reset_nr_frames() == 0
            run()
            torch.cuda.synchronize()
            stamps = np.zeros((warps, 8), np.int64)
            lib.read_stamps(stamps.ctypes.data, warps)
            counts = np.zeros(4, np.uint64)
            lib.read_nr_frames(counts.ctypes.data)
            for kind, rows in kinds.items():
                if which == "stamped":
                    out[f"{kind}_cycles_per_frame"] = phase_table(stamps[rows], names, n)
                else:
                    out[f"{kind}_cycles_per_frame_unstamped"] = float(
                        np.median(stamps[rows, 7])) / n
                    out[f"{kind}_cycles_per_frame_unstamped_max"] = float(
                        stamps[rows, 7].max()) / n
            if which == "stamped":
                out["exact_share_of_warp_frames"] = [
                    float(counts[k]) / float(counts[k + 1]) if counts[k + 1] else 0.0
                    for k in range(0, 2 * len(kinds), 2)]
        res[case] = {"shape": [n, c, f], **out}
    # one warp alone on the card (32 bins of running channels): the loop's
    # latency without other warps on its scheduler (and the xt heads'
    # alone, for the groups design)
    g = torch.Generator(device="cuda").manual_seed(1)
    x1 = ((1 - torch.rand(36, 1, 32, device="cuda", generator=g)).log().neg() * 1e6).contiguous()
    car1 = (torch.full((1,), 21, dtype=torch.int32, device="cuda"),) + tuple(
        torch.rand(1, 32, device="cuda", generator=g) * s for s in (1e6, 1e6, 0.5, 3.0))
    for key, name in (("one_warp_alone", f"nr_total_{tag}"),
                      ("one_warp_alone_xt_heads_only", f"nr_head_{tag}")):
        if name not in libs:
            continue
        lib = libs[name]
        lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        run, _ = nr_raw_call(lib.nr_launch, car1, p, x1)
        run()
        torch.cuda.synchronize()
        one = np.zeros((1, 8), np.int64)
        lib.read_stamps(one.ctypes.data, 1)
        res[f"{key}_cycles_per_frame_unstamped"] = float(one[0, 7]) / 36
    res["equal_to_package_kernel"] = True
    return res


# the groups design's fast tail stages, and what replaces them in the
# timing-only copy of nr_phases (the snr_post for the gains)
NR_HEAD_ONLY = (
    ("        t1<true, kSteady>(k, s, f[j - 1]);\n        t2<true>(f[j - 1]);\n", ""),
    ("        g[first + j - 1] = t3<true, kSteady>(s, f[j - 1]);\n",
     "        g[first + j - 1] = f[j - 1].snr_post;\n"),
    ("    t1<true, kSteady>(k, s, f[kN - 1]);\n    t2<true>(f[kN - 1]);\n"
     "    g[first + kN - 1] = t3<true, kSteady>(s, f[kN - 1]);\n",
     "    g[first + kN - 1] = f[kN - 1].snr_post;\n"),
)
NR_SHAPE = ("constexpr int kThreads = 32;", "constexpr int kGroup = 4;")
# (threads a block, frames a group) of each copy
NR_SHAPES = ((32, 4), (64, 4), (96, 4), (128, 4), (32, 2), (32, 3), (32, 6), (32, 8))


def nr_shapes() -> dict:
    """K-NR's kernel ms and chain floor at chip_smoke.py's shape in copies
    of csrc/nr.cu with other threads a block and frames a group (a basic
    block and a vote); each copy's outputs must equal the package
    kernel's."""
    import torch

    from chip_smoke import kernel_ms
    from phantomsdr_tpu_torch.ops.cuda.build import CSRC

    src = (CSRC / "nr.cu").read_text()
    if any(src.count(line) != 1 for line in NR_SHAPE):
        raise RuntimeError("csrc/nr.cu changed: its shape lines")
    texts = {}
    for t, g in NR_SHAPES:
        text = src
        for line, v in zip(NR_SHAPE, (t, g)):
            text = text.replace(line, line.rsplit("=", 1)[0] + f"= {v};")
        texts[f"nr_threads{t}_group{g}"] = text
    libs = build(texts)
    carries, p, xp, _, _ = nr_case()
    want = package_nr(carries, p, xp)
    res = {}
    for name, lib in libs.items():
        run, got = nr_raw_call(lib.nr_launch, carries, p, xp)
        probe, _ = nr_raw_call(lib.nr_chain_probe_launch, carries, p, xp, probe=True)
        run()
        torch.cuda.synchronize()
        if not same(got, want):
            raise AssertionError(f"K-NR {name} differs")
        res[name.removeprefix("nr_")] = {"kernel_ms": kernel_ms(run),
                                         "chain_floor_ms": kernel_ms(probe)}
    return res


# issue cost on the card: each thread runs 8 independent chains of one
# instruction; cycles a warp-instruction takes its scheduler, from lane 0
# of warp 0 of each block's clock64
ISSUE_RATES = r"""
#include <cuda_runtime.h>
#define CHAINS(OP) \
    float x0 = threadIdx.x, x1 = x0 + 1, x2 = x0 + 2, x3 = x0 + 3, x4 = x0 + 4, x5 = x0 + 5, \
          x6 = x0 + 6, x7 = x0 + 7; \
    const long long t0 = clock64(); \
    for (int i = 0; i < n; ++i) { OP(x0); OP(x1); OP(x2); OP(x3); OP(x4); OP(x5); OP(x6); OP(x7); } \
    const long long t1 = clock64(); \
    out[blockIdx.x * blockDim.x + threadIdx.x] = x0 + x1 + x2 + x3 + x4 + x5 + x6 + x7; \
    if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
#define FFMA(x) asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x) : "f"(a), "f"(b))
#define FMNMX(x) asm volatile("min.f32 %0, %0, %1;" : "+f"(x) : "f"(a))
#define FMNMX_NAN(x) asm volatile("min.NaN.f32 %0, %0, %1;" : "+f"(x) : "f"(a))
#define FSETP_FSEL(x) asm volatile("{ .reg .pred p; setp.gt.f32 p, %0, %1; selp.f32 %0, %2, %0, p; }" : "+f"(x) : "f"(a), "f"(b))
__global__ void k0(float* out, long long* cyc, int n, float a, float b) { CHAINS(FFMA) }
__global__ void k1(float* out, long long* cyc, int n, float a, float b) { CHAINS(FMNMX) }
__global__ void k2(float* out, long long* cyc, int n, float a, float b) { CHAINS(FMNMX_NAN) }
__global__ void k3(float* out, long long* cyc, int n, float a, float b) { CHAINS(FSETP_FSEL) }
extern "C" int issue_launch(int which, float* out, long long* cyc, int warps, int n) {
    void (*k[])(float*, long long*, int, float, float) = {k0, k1, k2, k3};
    k[which]<<<132, 32 * warps>>>(out, cyc, n, 0.999f, 0.001f);
    return static_cast<int>(cudaGetLastError());
}
"""


def issue_rates() -> dict:
    """Cycles a warp-instruction of FFMA, FMNMX, FMNMX.NAN and FSETP +
    FSEL (a pair) takes its SM sub-partition's scheduler, with 8 warps a
    block (2 a scheduler): the instructions of K-NR's loop by their
    cost."""
    import torch

    lib = build({"issue_rates": ISSUE_RATES})["issue_rates"]
    out = torch.empty(132 * 256, device="cuda")
    cyc = torch.zeros(132, dtype=torch.int64, device="cuda")
    res = {}
    for which, name in enumerate(("ffma", "fmnmx", "fmnmx_nan", "fsetp_fsel_pair")):
        n, warps = 1024, 8
        if lib.issue_launch(which, ctypes.c_void_p(out.data_ptr()),
                            ctypes.c_void_p(cyc.data_ptr()), warps, n) != 0:
            raise RuntimeError("issue_rates launch failed")
        torch.cuda.synchronize()
        res[name] = float(cyc.float().median()) / (n * 8 * warps / 4)
    return res


LINES = ("agc_phases", "pilot_sass", "nr_phases", "anr_phases", "nb_phases", "compare",
         "pilot_depths", "nr_shapes", "issue_rates", "anr_variants", "wf_variants", "host_us")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from phantomsdr_tpu_torch.ops.cuda import agc, nr, pll, waterfall
    from phantomsdr_tpu_torch.ops.cuda.build import (
        CSRC, BUILD_DIR, require_cuda, stream_and_device,
    )

    argv = sys.argv[1:]
    parent = Path(argv[argv.index("--parent") + 1]) if "--parent" in argv else None
    sass_dir = (Path(argv[argv.index("--sass-dir") + 1]) if "--sass-dir" in argv
                else BUILD_DIR)
    if "--host-only" in argv:
        only = {"host_us"}
    elif "--only" in argv:
        only = set(argv[argv.index("--only") + 1].split(","))
    else:
        only = set(LINES)
    if only - set(LINES):
        raise SystemExit(f"--only: unknown lines {sorted(only - set(LINES))}; "
                         f"the lines are {', '.join(LINES)}")
    sources = [(CSRC, "package")] + ([(parent, "parent")] if parent else [])
    per_source = {"agc_phases": lambda where, tag: agc_phases(
                      (where / "agc.cu").read_text(), where, tag),
                  "pilot_sass": lambda where, tag: pilot_sass(
                      (where / "pilot.cu").read_text(), where, tag, sass_dir),
                  "nr_phases": lambda where, tag: nr_phases(
                      (where / "nr.cu").read_text(), where, tag),
                  "anr_phases": lambda where, tag: anr_phases(
                      (where / "anr.cu").read_text(), where, tag),
                  "nb_phases": lambda where, tag: nb_phases(
                      (where / "nb.cu").read_text(), where, tag)}
    for line, fn in per_source.items():
        if line in only:
            for where, tag in sources:
                print(json.dumps({line: fn(where, tag)}), flush=True)
    if parent and "compare" in only:
        print(json.dumps({"compare": compare(parent)}), flush=True)
    if "pilot_depths" in only:
        print(json.dumps({"pilot_depths": pilot_depths()}), flush=True)
    if "nr_shapes" in only:
        print(json.dumps({"nr_shapes": nr_shapes()}), flush=True)
    if "issue_rates" in only:
        print(json.dumps({"issue_rates": issue_rates()}), flush=True)
    if "anr_variants" in only:
        print(json.dumps({"anr_variants": anr_variants()}), flush=True)
    if not only & {"wf_variants", "host_us"}:
        return 0

    state, x, params, _ = agc_case("bench_int16")
    c, n = x.shape
    b, half = n // 180, 180
    out = torch.empty(b, c, half, dtype=torch.int16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    carrier = torch.randn(c, n, dtype=torch.complex64, device="cuda",
                          generator=gen)
    zero = torch.zeros(c, device="cuda")
    run_raw, _ = agc_call(agc_launcher(agc.KERNEL.lib(), False), state, x,
                          params, False)
    stream, dev = stream_and_device(x)
    from chip_smoke import time_ms

    r, levels = 1 << 20, 11
    spec = (torch.randn(b, r, dtype=torch.complex64, device="cuda",
                        generator=gen)
            * 10 ** (torch.rand(b, r, device="cuda", generator=gen) * 10 - 12))
    rows = torch.arange(0, b, b // 6, dtype=torch.int32, device="cuda")
    wf_kw = dict(fft_result_size=r, base_idx=r // 2 + 1, levels=levels,
                 size_log2=20)
    if "wf_variants" in only:
        print(json.dumps({"wf_variants": wf_variants(spec, rows, wf_kw, dev,
                                                     stream)}), flush=True)
    if "host_us" not in only:
        return 0
    wf_out = waterfall.waterfall_rows(spec, rows, **wf_kw)
    wf_args = (spec.data_ptr(), r, rows.data_ptr(), rows.shape[0], r,
               r // 2 + 1, levels, 20, 6.0206, 6.0206, wf_out.data_ptr(),
               wf_out.shape[1], None, dev, stream)
    wf_raw = waterfall.KERNEL.lib().waterfall_launch
    nr_carries, nr_p, nr_xp, _, _ = nr_case()
    nr_args = (nr_carries, nr_p.alpha, nr_p.xih1r, nr_p.pfac, nr_xp)
    nr_raw, _ = nr_raw_call(nr.KERNEL.lib().nr_launch, *nr_args[:1], nr_p, nr_xp)

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
        "agc_launch_ctypes": host_us(run_raw),
        "gain_frames": host_us(lambda: nr.gain_frames(*nr_args)),
        "nr_launch_ctypes": host_us(nr_raw),
    }, "events_only_ms": time_ms(lambda: None, 50),
        "nr_launches_per_call": nr_fusion_launches(),
        **({"gain_frames_in_turns": gain_frames_in_turns(parent, nr_args)} if parent else {})}),
        flush=True)
    return 0


def gain_frames_in_turns(parent: Path, args) -> dict:
    """Host us of one K-NR wrapper call: the parent checkout's
    ops/cuda/nr.py (loaded beside the package's; it launches the
    package's kernel) and the package's, in turns (parent, package,
    package, parent, five times), and the medians."""
    import importlib.util

    from phantomsdr_tpu_torch.ops.cuda import nr

    spec = importlib.util.spec_from_file_location(
        "phantomsdr_tpu_torch.ops.cuda._nr_parent", parent.parent / "ops/cuda/nr.py")
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    runs = {"parent": [], "package": []}
    for _ in range(5):
        for name, mod in (("parent", old), ("package", nr), ("package", nr), ("parent", old)):
            runs[name].append(host_us(lambda: mod.gain_frames(*args)))
    return {**runs, "median": {k: float(np.median(v)) for k, v in runs.items()}}


if __name__ == "__main__":
    sys.exit(main())
