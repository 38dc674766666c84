"""Build and load the hand-written CUDA kernels (``mpc_verde_tpu_torch/csrc``).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (all in parallel), and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  Tensors
pass as ``data_ptr()`` integers and the launch goes on PyTorch's current
stream.  Nothing here includes PyTorch's headers, whose build takes
minutes; the build time is that of the kernels themselves.

The library is built on first use into ``mpc_verde_tpu_torch/_build/``
(ignored by git), under a name that carries a hash of the sources and flags:
a changed source builds a new library.  ``python -m
mpc_verde_tpu_torch.ops.cuda.build`` builds it and prints, per source, the
seconds ``nvcc`` took and ``ptxas``'s register and spill report.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)

# C signatures of the kernels' entry points (argtypes, restype int).
_SIGNATURES = {
    "mv_riccati_backward": [_I, _I, _I, _I, _I, _F] + [_P] * 21
                           + [_I, _I, _IP, _P] + [_P],
    "mv_linesearch_forward": [_I, _I, _I, _I] + [_P] * 6 + [_FP, _IP, _P, _FP, _I]
                             + [_P] * 4 + [_I, _I, _IP] + [_P],
    "mv_fused_backward": [_I, _I, _I, _I, _I, _F] + [_P] * 5 + [_FP, _IP, _P]
                         + [_P] * 5 + [_I, _I, _I, _IP, _P] + [_P],
}

# Dynamic shared memory one block can use on sm_90 (227 KB of the SM's 256):
# kSmemMaxBytes in csrc/launch.cuh.
SMEM_MAX_BYTES = 232_448


class LaunchPlan(NamedTuple):
    """How a kernel is launched for one shape: a pure function of the shape
    (``riccati_launch_plan``, ``linesearch_launch_plan``,
    ``fused_launch_plan``), never of a trial."""

    variant: str
    problems: int     # problems per block
    threads: int      # threads per block
    smem_bytes: int   # dynamic shared memory per block
    layout: tuple = ()   # the kernel's shared-memory offsets or strides, floats

    def c_layout(self):
        """``layout`` as the C entry points take it (a host int array)."""
        return (ctypes.c_int * len(self.layout))(*self.layout)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float   # wall time of the nvcc run (0.0 when already built)
    log: str         # nvcc/ptxas output ("" when already built)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libmv_kernels_{h.hexdigest()[:16]}.so"


def build() -> BuildResult:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.is_file():
        return BuildResult(out, 0.0, "")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objdir = BUILD_DIR / f"{tmp.name}.obj"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    t0 = time.perf_counter()
    procs = {}
    for src in cu:   # one nvcc per source, all started together
        out_file = open(objdir / f"{src.stem}.log", "w")
        procs[src] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(objdir / f"{src.stem}.o")],
            stdout=out_file, stderr=subprocess.STDOUT), out_file)
    done = {}
    while len(done) < len(procs):
        for src, (proc, out_file) in procs.items():
            if src not in done and proc.poll() is not None:
                done[src] = time.perf_counter() - t0
                out_file.close()
        time.sleep(0.05)
    logs, failed = [], []
    for src, (proc, _) in procs.items():
        text = (objdir / f"{src.stem}.log").read_text()
        logs.append(f"== {src.name} ({done[src]:.1f} s)\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(objdir / f"{s.stem}.o") for s in cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    shutil.rmtree(objdir, ignore_errors=True)
    log = "".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return BuildResult(out, time.perf_counter() - t0, log)


_LIB = None


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the signatures."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        _LIB = lib
    return _LIB


def check_args(name: str, device: torch.device, named) -> None:
    """Raise unless every ``(arg, tensor, shape)`` is what the kernels take:
    a contiguous float32 tensor of that shape on ``device``."""
    for arg, t, shape in named:
        if t.device != device:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            "float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def check_launch(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


if __name__ == "__main__":
    res = build()
    print(f"{res.path} built in {res.seconds:.1f} s")
    print(res.log)
