"""Build the native host engine: ``python -m mpc_verde_tpu_torch.native.build``
(cmake, and ninja where present; the library lands in ``native/build/lib``)."""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path


def build(verbose: bool = True, build_dir=None) -> Path:
    """Configure and build ``native/`` into ``build_dir`` (default
    ``native/build``, where ``mpc_verde_tpu_torch.native`` looks); returns
    the library's path."""
    root = Path(__file__).resolve().parents[2] / "native"
    bdir = Path(build_dir) if build_dir is not None else root / "build"
    bdir.mkdir(parents=True, exist_ok=True)
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    subprocess.run(["cmake", *gen, "-S", str(root), "-B", str(bdir)],
                   cwd=bdir, check=True, capture_output=not verbose)
    subprocess.run(["cmake", "--build", "."], cwd=bdir, check=True,
                   capture_output=not verbose)
    lib = bdir / "lib" / "libmpcverde_host.so"
    if not lib.is_file():
        raise RuntimeError("build produced no library")
    return lib


if __name__ == "__main__":
    p = build()
    print(f"built {p}")
    sys.exit(0)
