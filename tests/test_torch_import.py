"""The PyTorch port stands alone: no JAX, no kernel without its device model,
and chip_smoke.py refuses to run without a GPU."""
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
    ocp = bench_ocp(5, "cpu", torch.float32)
    bare = mt.OCP(dynamics=ocp.dynamics, stage_cost=ocp.stage_cost, N=5,
                  nx=3, nu=2, npar=3, control_bounds=ocp.control_bounds)
    for make in (mt.make_batched_ilqr_solver, mt.make_streaming_solver):
        with pytest.raises(NotImplementedError, match="device_model"):
            make(bare, backend="cuda")
        make(ocp, backend="cuda")  # the bench OCP carries one


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
