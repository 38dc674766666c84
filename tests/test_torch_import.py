"""The PyTorch port stands alone: no JAX, no kernel without a device model
(the OCP's own or the one traced from its callables), and chip_smoke.py
refuses to run without a GPU."""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mpc_verde_tpu_torch as mt
from mpc_verde_tpu_torch.interop import bench_ocp

ROOT = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "pre = set(sys.modules)\n"
        "import mpc_verde_tpu_torch as m\n"
        "for i in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(i.name)\n"
        "new = set(sys.modules) - pre\n"
        "bad = sorted(n for n in new if n.split('.')[0] in ('jax', 'jaxlib',"
        " 'flax', 'mpc_verde_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(new))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_backend_needs_device_model():
    """An OCP without a device model runs "cuda" on the model traced from
    its callables (the one it needs); a callable outside the lowering table
    raises NotImplementedError naming the op and the callable."""
    from mpc_verde_tpu_torch.ops.cuda.rollout import TracedDeviceModel

    ocp = bench_ocp(5, "cpu", torch.float32)
    bare = mt.OCP(dynamics=ocp.dynamics, stage_cost=ocp.stage_cost, N=5,
                  nx=3, nu=2, npar=3, control_bounds=ocp.control_bounds)
    atan2 = dataclasses.replace(bare, terminal_cost=lambda x, p: torch.atan2(
        x[1], x[0]))
    for make in (mt.make_batched_ilqr_solver, mt.make_streaming_solver):
        with pytest.raises(NotImplementedError,
                           match="terminal_cost: the ATen op aten.atan2"):
            make(atan2, backend="cuda")
        make(bare, backend="cuda")
        make(ocp, backend="cuda")  # the bench OCP carries one
    assert isinstance(bare._traced_device_model, TracedDeviceModel)
    assert not hasattr(ocp, "_traced_device_model")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No usable card (or no repo beside it): non-zero exit, no result line."""
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_sources_name_no_jax_import():
    """No line of the port or of chip_smoke.py imports jax, flax or the JAX
    package (what the walk above sees only for modules it imports)."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|mpc_verde_tpu)(\.|\s|$)")
    files = sorted((ROOT / "mpc_verde_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    bad = [f"{f.relative_to(ROOT)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad


def test_viz_and_export_import_without_matplotlib_or_pandas(tmp_path):
    """With matplotlib and pandas unimportable, viz, compat and
    runtime.export import, CSV and xlsx runs round-trip, and only legacy
    Excel asks for pandas."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'pandas'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "import mpc_verde_tpu_torch.viz, mpc_verde_tpu_torch.compat\n"
        "from mpc_verde_tpu_torch.runtime import export as e\n"
        f"d = {str(tmp_path)!r}\n"
        "xs = np.arange(12.0).reshape(4, 3) / 7; us = np.ones((3, 2)) / 3\n"
        "for ext in ('.csv', '.xlsx'):\n"
        "    t = e.load_run(e.export_diffdrive_run(d + '/r' + ext, xs, us, 0.2))\n"
        "    assert np.array_equal(t['x'], xs[:, 0]), t\n"
        "try:\n"
        "    e.load_run(d + '/r.xls')\n"
        "except ImportError as exc:\n"
        "    assert 'pandas' in str(exc)\n"
        "else:\n"
        "    raise AssertionError('.xls read without pandas')\n"
        "assert not {'matplotlib', 'pandas'} & set(sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("pkg", ["", ".utils", ".runtime", ".parallel",
                                 ".viz", ".compat"])
def test_packages_export_the_jax_names(pkg):
    """Each package exports the names its JAX counterpart's __init__ binds
    (the JAX-only force_cpu / force_tpu aside), read from the source: a
    package's attributes also hold whatever submodule another import
    loaded."""
    import ast
    import importlib

    init = ROOT / "mpc_verde_tpu" / pkg.lstrip(".") / "__init__.py"
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    names -= {"force_cpu", "force_tpu", "annotations"}
    tmod = importlib.import_module("mpc_verde_tpu_torch" + pkg)
    missing = sorted(n for n in names if not hasattr(tmod, n))
    assert not missing, missing
