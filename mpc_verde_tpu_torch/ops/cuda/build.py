"""Build and load the hand-written CUDA kernels (``mpc_verde_tpu_torch/csrc``).

Two kinds of library, each a plain C interface loaded with ``ctypes``:

* the kernels library: every ``csrc/*.cu`` file (K2 and K3 on their device
  models), one ``nvcc`` process a file, linked into one library;
* K1 (the Riccati backward pass), one library per (nx, nu): two generated
  translation units, one per variant (``riccati_units``), compiled by two
  ``nvcc`` processes and linked.  A size is built the first time it is
  used, so a process pays for the sizes it runs and no other;
* K2 and K3 on a device model generated from the trace of an OCP's own
  callables (``trace.py``, ``codegen.py``), one library per traced program:
  its K2 unit and its K3 unit (``codegen.units``), entry points named with
  the hash of the model's text, built the first time the program runs;
* the streaming refill (``csrc/refill.cuh``, ``refill.py``), a library of
  one generated unit, built the first time a streaming solver runs on the
  card: outside the kernels library, so that a solve on a traced model
  never builds or loads that one.

Tensors pass as ``data_ptr()`` integers and the launch goes on PyTorch's
current stream.  Nothing here includes PyTorch's headers, whose build takes
minutes; the build time is that of the kernels themselves.

A library is built into ``mpc_verde_tpu_torch/_build/`` (ignored by git)
under a name that carries a hash of its units' text, of every header they
include and of the flags: a changed source builds a new library.  The file
appears by an atomic rename, so concurrent builds never see half of one.
``build(riccati_sizes, programs)`` starts the ``nvcc`` processes of every
library it is given together.  A failed ``nvcc`` raises with its log; nothing falls
back.  ``python -m mpc_verde_tpu_torch.ops.cuda.build [nx,nu ...]`` builds
the kernels library and K1 at the given sizes and prints, per unit, the
seconds ``nvcc`` took and ``ptxas``'s register and spill report.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

from .codegen import program_hash, units as traced_units

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)

# C signatures of the entry points (argtypes, restype int): the kernels
# library's, and K1's, whose library of size (nx, nu) names it
# mv_riccati_backward_<nx>x<nu>.
_SIGNATURES = {
    "mv_linesearch_forward": [_I, _I, _I, _I] + [_P] * 6 + [_FP, _IP, _P, _FP, _I]
                             + [_P] * 4 + [_I, _I, _IP] + [_P],
    "mv_fused_backward": [_I, _I, _I, _I, _I, _F] + [_P] * 5 + [_FP, _IP, _P]
                         + [_P] * 5 + [_I, _I, _I, _IP, _P] + [_P],
    "mv_trajectory_cost": [_I, _I, _I, _I] + [_P] * 5 + [_FP, _IP, _P]
                          + [_P, _P],
}
_RICCATI_SIGNATURE = ([_I, _I, _I, _I, _I, _F] + [_P] * 21 + [_I, _I, _IP, _P]
                      + [_P])
# mv_refill_slots: dtype, B, M, nx, sp, su, sx, reg_init, use_ddp, 21 device
# pointers, the stream.
_REFILL_SIGNATURE = [_I] * 7 + [_D, _I] + [_P] * 21 + [_P]

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
    # from its first nvcc start to its link's end (0.0 when already built);
    # the units ran beside every other unit of the same build() call
    seconds: float
    log: str   # nvcc/ptxas output, "== unit (its own s)" a part ("" when already built)


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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

# K1's units at one size: the "thread" variant with the C entry point, and
# the "warps" variant (csrc/riccati_entry.cuh).
_RICCATI_UNIT = """// K1 at (nx, nu) = ({nx}, {nu}): variant "thread" and the C entry point.
// Generated by mpc_verde_tpu_torch/ops/cuda/build.py (riccati_units).
#include "riccati_entry.cuh"

MV_RICCATI_ENTRY({nx}, {nu})
"""
_RICCATI_WARPS_UNIT = """// K1 at (nx, nu) = ({nx}, {nu}): variant "warps".
// Generated by mpc_verde_tpu_torch/ops/cuda/build.py (riccati_units).
#include "riccati_warps.cuh"

cudaError_t mv_riccati_warps_launch_{nx}x{nu}(const RiccatiArgs& a, bool ddp, int problems,
                                        const int* layout, long long* clocks, cudaStream_t s) {{
  return riccati_warps_launch<{nx}, {nu}>(a, ddp, problems, layout, clocks, s);
}}
"""


# The refill's unit: its kernels and entry point are the header's.
_REFILL_UNIT = """// The streaming refill, float32 and float64, and its C entry point.
// Generated by mpc_verde_tpu_torch/ops/cuda/build.py (refill_units).
#include "refill.cuh"
"""


def check_riccati_size(nx: int, nu: int) -> None:
    """Raise unless K1 takes (nx, nu): nx >= 1 and 1 <= nu <= 4.  nu > 4
    raises ``NotImplementedError``, as the JAX kernel does: the stage box QP
    enumerates 3^nu active-set patterns."""
    if nu > 4:
        raise NotImplementedError(
            f"the Riccati kernel supports nu <= 4 (3^nu active-set "
            f'enumeration), not nu = {nu}; use backend="torch" for wider '
            "control vectors")
    if nx < 1 or nu < 1:
        raise ValueError(f"the Riccati kernel needs nx >= 1 and nu >= 1, not "
                         f"({nx}, {nu})")


def riccati_units(nx: int, nu: int) -> dict:
    """The generated translation units of K1 at (nx, nu): {file name: text}."""
    check_riccati_size(nx, nu)
    return {f"riccati_{nx}x{nu}.cu": _RICCATI_UNIT.format(nx=nx, nu=nu),
            f"riccati_warps_{nx}x{nu}.cu": _RICCATI_WARPS_UNIT.format(nx=nx,
                                                                      nu=nu)}


def refill_units() -> dict:
    """The generated translation unit of the refill: {file name: text}."""
    return {"refill.cu": _REFILL_UNIT}


def _kernels_units() -> dict:
    return {f.name: f.read_text() for f in sorted(CSRC.glob("*.cu"))}


def _headers(units: dict) -> list:
    """The csrc headers that ``units`` include, directly or through another
    header, sorted by name."""
    seen, todo = set(), list(units.values())
    while todo:
        for name in _INCLUDE.findall(todo.pop()):
            if name not in seen and (CSRC / name).is_file():
                seen.add(name)
                todo.append((CSRC / name).read_text())
    return sorted(seen)


def _library(stem: str, units: dict) -> Path:
    """The library of ``units`` under a name that hashes the flags, the
    units' names and text and every header they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, text in sorted(units.items()):
        h.update(name.encode())
        h.update(text.encode())
    for name in _headers(units):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Path of the kernels library (K2, K3) for the current sources and flags."""
    return _library("mv_kernels", _kernels_units())


def riccati_library_path(nx: int, nu: int) -> Path:
    """Path of K1's library at (nx, nu) for the current sources and flags."""
    return _library(f"mv_riccati_{nx}x{nu}", riccati_units(nx, nu))


def refill_library_path() -> Path:
    """Path of the refill's library for the current sources and flags."""
    return _library("mv_refill", refill_units())


def traced_library_path(program) -> Path:
    """Path of the library of a traced program's K2 and K3."""
    return _library(f"mv_traced_{program_hash(program)}",
                    traced_units(program))


def _compile(libraries: dict) -> dict:
    """Build every library of ``libraries`` ({path: units}) that does not
    exist: each unit by its own nvcc process, all started together; then
    each library's link.  Returns {path: BuildResult}; raises with the logs
    if a unit or a link fails (the libraries that compiled are kept).  Each
    unit's log carries its own seconds, start to finish; a library's
    ``seconds`` run from its first unit's start to its link's end.  Each
    traced program's library built counts one ``traced_builds``."""
    from ...utils.profiling import count   # utils imports this module

    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, objdirs = {}, {}
    for out, units in libraries.items():
        # a directory of its own per call, so that two builds of one size,
        # in two processes or two threads, never share objects
        objdir = Path(tempfile.mkdtemp(prefix=f"{out.stem}.", dir=BUILD_DIR))
        objdirs[out] = objdir
        for name, text in units.items():
            src = objdir / name
            src.write_text(text)
            log = open(objdir / f"{name}.log", "w")
            jobs[(out, name)] = (time.perf_counter(), subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                 str(src.with_suffix(".o"))],
                stdout=log, stderr=subprocess.STDOUT), log)
    done = {}
    while len(done) < len(jobs):
        for key, (_, proc, log) in jobs.items():
            if key not in done and proc.poll() is not None:
                done[key] = time.perf_counter()
                log.close()
        time.sleep(0.05)
    results, failed, logs = {}, [], []
    for out, units in libraries.items():
        objdir, parts, ok = objdirs[out], [], True
        for name in units:
            start, proc, _ = jobs[(out, name)]
            parts.append(f"== {name} ({done[(out, name)] - start:.1f} s)\n"
                         f"{(objdir / f'{name}.log').read_text()}")
            if proc.returncode != 0:
                ok = False
                failed.append(name)
        if ok:
            tmp = objdir / out.name
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp),
                 *(str((objdir / n).with_suffix(".o")) for n in units)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            parts.append(f"== link {out.name}\n{link.stdout}")
            if link.returncode != 0:
                failed.append(f"link {out.name}")
            else:
                os.replace(tmp, out)   # atomic: no one sees half a file
                if out.name.startswith("libmv_traced_"):
                    count(traced_builds=1)
                first = min(jobs[(out, name)][0] for name in units)
                results[out] = BuildResult(out, time.perf_counter() - first,
                                           "".join(parts))
        shutil.rmtree(objdir, ignore_errors=True)
        logs += parts
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{''.join(logs)}")
    return results


def build(riccati_sizes=(), programs=()) -> dict:
    """Build the kernels library, K1's library at each (nx, nu) of
    ``riccati_sizes`` and the library of each traced program of
    ``programs`` (``trace.Program``), every nvcc process of every library
    not yet built started together.  Returns {"kernels",
    "riccati_<nx>x<nu>" or "traced_<hash>": BuildResult}; a library that
    exists comes back with 0.0 seconds and an empty log."""
    wanted = {"kernels": (library_path(), _kernels_units())}
    for nx, nu in riccati_sizes:
        wanted[f"riccati_{nx}x{nu}"] = (riccati_library_path(nx, nu),
                                        riccati_units(nx, nu))
    for program in programs:
        wanted[f"traced_{program_hash(program)}"] = (
            traced_library_path(program), traced_units(program))
    built = _compile({path: units for path, units in wanted.values()
                      if not path.is_file()})
    return {key: built.get(path, BuildResult(path, 0.0, ""))
            for key, (path, _) in wanted.items()}


_LIB = None
_RICCATI = {}
_TRACED = {}
_REFILL = None


def load_library() -> ctypes.CDLL:
    """Build the kernels library if needed, load it once per process, and
    declare the signatures."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()["kernels"].path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        _LIB = lib
    return _LIB


def riccati_entry(nx: int, nu: int):
    """K1's C entry point at (nx, nu), its library built at first use and
    loaded once per process."""
    if (nx, nu) not in _RICCATI:
        path = riccati_library_path(nx, nu)
        if not path.is_file():
            _compile({path: riccati_units(nx, nu)})
        fn = getattr(ctypes.CDLL(str(path)), f"mv_riccati_backward_{nx}x{nu}")
        fn.argtypes = _RICCATI_SIGNATURE
        fn.restype = _I
        _RICCATI[(nx, nu)] = fn
    return _RICCATI[(nx, nu)]


def refill_entry():
    """The refill's C entry point ``mv_refill_slots``, its library built at
    first use and loaded once per process."""
    global _REFILL
    if _REFILL is None:
        path = refill_library_path()
        if not path.is_file():
            _compile({path: refill_units()})
        fn = ctypes.CDLL(str(path)).mv_refill_slots
        fn.argtypes = _REFILL_SIGNATURE
        fn.restype = _I
        _REFILL = fn
    return _REFILL


def traced_entry(program, name: str):
    """The entry point ``name`` ("mv_linesearch_forward",
    "mv_trajectory_cost" or "mv_fused_backward", the kernels library's
    signatures) of a traced
    program's library, built at first use and loaded once per process
    (inside the span ``mpc.build``)."""
    from ...utils.profiling import count, span   # utils imports this module

    h = program_hash(program)
    if h not in _TRACED:
        with span("mpc.build"):
            path = traced_library_path(program)
            if not path.is_file():
                _compile({path: traced_units(program)})
            _TRACED[h] = ctypes.CDLL(str(path))
        count(traced_loads=1)
    fn = getattr(_TRACED[h], f"{name}_{h}")
    fn.argtypes = _SIGNATURES[name]
    fn.restype = _I
    return fn


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
    import sys

    sizes = [tuple(int(v) for v in arg.split(",")) for arg in sys.argv[1:]]
    for key, res in build(sizes).items():
        print(f"{key}: {res.path} built in {res.seconds:.1f} s")
        print(res.log)
