"""ctypes bindings for the native host engine (``native/``); the port's own
copy of ``mpc_verde_tpu.native``, loading the same library.

The shared library ``native/build/lib/libmpcverde_host.so`` is built with
cmake (+ ninja where present) from the repo's ``native/`` sources (``python
-m mpc_verde_tpu_torch.native.build``).  Every entry point has a
pure-Python/numpy counterpart in ``refgen``, so the port works without the
library, and nothing on its CUDA path needs it; when present, CSV ingest and
reference synthesis run natively (the role pandas + per-step Python loops
play in the reference scripts), and ``lqr_riccati`` is an independent
float64 LQR golden.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_LIB = None
_SEARCH = (
    Path(__file__).resolve().parents[2] / "native" / "build" / "lib",
    Path(__file__).resolve().parents[2] / "native" / "build",
)


def _load(path=None):
    """The loaded library: the one at ``path`` when given (a build elsewhere,
    ``build(build_dir=...)``), else the first found under ``native/build``;
    None when there is none."""
    global _LIB
    if _LIB is not None and path is None:
        return _LIB
    cands = [Path(path)] if path is not None else [
        d / "libmpcverde_host.so" for d in _SEARCH]
    for p in cands:
        if p.is_file():
            lib = ctypes.CDLL(str(p))
            c_d = ctypes.POINTER(ctypes.c_double)
            lib.mv_csv_rows.restype = ctypes.c_int64
            lib.mv_csv_rows.argtypes = [ctypes.c_char_p]
            lib.mv_load_path_csv.restype = ctypes.c_int64
            lib.mv_load_path_csv.argtypes = [ctypes.c_char_p, c_d, c_d, c_d,
                                             ctypes.c_int64]
            lib.mv_path_heading.restype = None
            lib.mv_path_heading.argtypes = [c_d, c_d, ctypes.c_int64,
                                            ctypes.c_int, c_d]
            lib.mv_lateral_error_refs.restype = None
            lib.mv_lateral_error_refs.argtypes = [
                c_d, c_d, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, c_d]
            lib.mv_stage_window.restype = None
            lib.mv_stage_window.argtypes = [c_d, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int64, c_d]
            lib.mv_lqr_riccati.restype = ctypes.c_double
            lib.mv_lqr_riccati.argtypes = [c_d, c_d, c_d, c_d, c_d,
                                           ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int64, c_d, c_d]
            _LIB = lib
            return lib
    return None


def available() -> bool:
    return _load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def load_path_csv(path: str):
    """Native CSV path loader; returns dict(x, y, uref)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    n = lib.mv_csv_rows(str(path).encode())
    if n <= 0:
        raise FileNotFoundError(path)
    x = np.empty(n); y = np.empty(n); u = np.empty(n)
    got = lib.mv_load_path_csv(str(path).encode(), _ptr(x), _ptr(y), _ptr(u), n)
    if got <= 0:
        raise ValueError(f"failed to parse {path}")
    return {"x": x[:got], "y": y[:got], "uref": u[:got]}


def lateral_error_refs(x, y, dt: float, ar: float, br: float,
                       unwrap: bool = False):
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    x = np.ascontiguousarray(x, dtype=float)
    y = np.ascontiguousarray(y, dtype=float)
    n = len(x)
    out = np.empty((n, 4))
    lib.mv_lateral_error_refs(_ptr(x), _ptr(y), n, dt, ar, br,
                              1 if unwrap else 0, _ptr(out))
    return out


def stage_window(refs, Nt: int, Nsim: int):
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    refs = np.ascontiguousarray(refs, dtype=float)
    n, np_ = refs.shape
    out = np.empty((Nsim, Nt, np_))
    lib.mv_stage_window(_ptr(refs), n, np_, Nt, Nsim, _ptr(out))
    return out


def lqr_riccati(A, B, Q, R, Qf, N: int, x0):
    """Independent float64 finite-horizon LQR golden."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    A = np.ascontiguousarray(A, dtype=float)
    B = np.ascontiguousarray(B, dtype=float)
    Q = np.ascontiguousarray(Q, dtype=float)
    R = np.ascontiguousarray(R, dtype=float).reshape(B.shape[1], B.shape[1])
    Qf = np.ascontiguousarray(Qf, dtype=float)
    x0 = np.ascontiguousarray(x0, dtype=float)
    nx, nu = B.shape
    us = np.empty((N, nu))
    cost = lib.mv_lqr_riccati(_ptr(A), _ptr(B), _ptr(Q), _ptr(R), _ptr(Qf),
                              nx, nu, N, _ptr(x0), _ptr(us))
    return us, float(cost)
