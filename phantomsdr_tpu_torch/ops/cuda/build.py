"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes, at first
use (never at import: the package also runs where there is no nvcc).
Libraries land in ``build/torch_kernels/`` at the repository root,
named by a hash of their source and flags, so an edited source is
rebuilt and an unchanged one is reused.

Every exported launcher takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; the
wrapper raises on anything but 0.  Nothing here falls back to the
plain PyTorch versions: those run only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
I64 = ctypes.c_int64

_load_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class CudaKernel:
    """One launcher of a ``csrc/<source>.cu`` library: build, load, bind,
    count launches.

    ``argtypes`` lists the ctypes types of the launcher ``<name>_launch``
    (pointers and the stream as ``c_void_p``).  ``launches`` counts the
    wrapper's calls that launched the kernel.  ``probe_argtypes``, where
    given, binds ``<name>_chain_probe_launch``: the kernel's serial loop
    alone, a measuring aid that ``probe`` launches without counting.
    ``source`` defaults to ``name``; two launchers of one source share
    its library and count their launches apart.
    """

    def __init__(self, name: str, argtypes: list,
                 probe_argtypes: list | None = None,
                 source: str | None = None):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.argtypes = argtypes
        self.probe_argtypes = probe_argtypes
        self.launches = 0
        self._lib = None

    def lib_path(self) -> Path:
        # the source and the headers it may include from csrc/
        text = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        h = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{h}.so"

    def start_build(self):
        """Start nvcc for this library unless it is already built:
        None, or (process, temporary output, final output)."""
        out = self.lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def lib(self):
        with _load_lock:
            if self._lib is None:
                self._lib = self._build_and_bind()
        return self._lib

    def _build_and_bind(self):
        finish_builds([self.start_build()])
        lib = ctypes.CDLL(str(self.lib_path()))
        fn = getattr(lib, f"{self.name}_launch")
        fn.argtypes = self.argtypes
        fn.restype = I
        if self.probe_argtypes is not None:
            probe = getattr(lib, f"{self.name}_chain_probe_launch")
            probe.argtypes = self.probe_argtypes
            probe.restype = I
        lib.kernel_error_string.argtypes = [I]
        lib.kernel_error_string.restype = ctypes.c_char_p
        return lib

    def launch(self, *args) -> None:
        """Call ``<name>_launch(*args)`` and raise on a CUDA error."""
        self.call(f"{self.name}_launch", *args)
        self.launches += 1

    def probe(self, *args) -> None:
        """Call ``<name>_chain_probe_launch(*args)``; not counted."""
        self.call(f"{self.name}_chain_probe_launch", *args)

    def call(self, fn: str, *args) -> None:
        """Call the library's ``fn(*args)`` (its argtypes bound) and raise
        on a CUDA error; not counted."""
        lib = self.lib()
        rc = getattr(lib, fn)(*args)
        if rc != 0:
            msg = lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{fn} failed: CUDA error {rc} ({msg})")


def finish_builds(procs) -> None:
    """Wait for nvcc processes started by ``start_build`` and publish
    their libraries; raise with the compiler's output on failure."""
    errors = []
    for build in procs:
        if build is None:
            continue
        proc, tmp, out = build
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{proc.args[-1]}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build_all(kernels) -> None:
    """Compile every kernel's library at once (one nvcc per source)."""
    by_source = {k.lib_path(): k for k in kernels}
    finish_builds([k.start_build() for k in by_source.values()])


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype
    and rank (what every launcher takes).  (``is_cuda`` rather than
    ``device``: it runs on every launch, and building a device object
    costs more than the rest of the checks together.)"""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_and_device(t: torch.Tensor) -> tuple[int, int]:
    """(current stream handle, device index) for launching on the CUDA
    tensor ``t``."""
    dev = t.get_device()
    return torch.cuda.current_stream(dev).cuda_stream, dev


def div_scalar(x: torch.Tensor, k: float) -> torch.Tensor:
    """x / k rounded once, as JAX divides by a constant (on the card
    PyTorch divides by a Python scalar as a multiplication by its
    rounded reciprocal).  For the plain versions of the kernels."""
    return x / torch.full((), k, dtype=x.dtype, device=x.device)


def check_host_or_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel);
    raise for any other device."""
    if t.is_cuda:
        return False
    if t.is_cpu:
        return True
    raise ValueError(f"{name}: unsupported device {t.device}")
