"""Port vs JAX: the host tools — ``utils`` (tree_where, Timer / timed,
SolvePhaseTimer, device_trace), ``refgen.xlsx``, ``runtime.export`` and
``runtime.checkpoint`` (SegmentedRun) — on the CPU, in float64.

Tables cross between the packages as files: each package reads what the
other wrote.  The segmented runs are the diff-drive closed loop (24 steps,
segments of 8) against the port's and JAX's monolithic runs.
"""
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_verde_tpu_torch.runtime.checkpoint import (SegmentedRun,
                                                    load_checkpoint,
                                                    save_checkpoint)
from mpc_verde_tpu_torch.runtime.export import (compare_runs,
                                                export_diffdrive_run,
                                                export_lane_change_run,
                                                load_run)

STEPS, SEG = 24, 8
CPU64 = dict(device="cpu", dtype=torch.float64)


@dataclasses.dataclass
class _Pair:
    a: torch.Tensor
    b: tuple


def test_tree_where_matches_jax():
    import jax.numpy as jnp

    from mpc_verde_tpu.utils import tree_where as j_tree_where
    from mpc_verde_tpu_torch.utils import tree_where

    rng = np.random.default_rng(3)
    a = {"x": rng.normal(size=(4, 3)), "y": (rng.normal(size=4),
                                             rng.normal(size=(4, 2)))}
    b = {"x": rng.normal(size=(4, 3)), "y": (rng.normal(size=4),
                                             rng.normal(size=(4, 2)))}
    for pred in (np.array(True), np.array(False),
                 rng.uniform(size=(4, 1)) > 0.5):
        t = lambda tree: {"x": torch.as_tensor(tree["x"]),
                          "y": tuple(torch.as_tensor(v) for v in tree["y"])}
        got = tree_where(torch.as_tensor(pred), t(a), t(b))
        ref = j_tree_where(jnp.asarray(pred), a, b)
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(ref["x"]))
        for g, r in zip(got["y"], ref["y"]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    pa = _Pair(torch.zeros(3), (torch.zeros(3), None))
    pb = _Pair(torch.ones(3), (torch.ones(3), None))
    out = tree_where(torch.tensor([True, False, True]), pa, pb)
    assert isinstance(out, _Pair) and out.b[1] is None
    np.testing.assert_array_equal(out.a.numpy(), [0.0, 1.0, 0.0])


def test_timers_match_jax():
    from mpc_verde_tpu.utils import Timer as JTimer
    from mpc_verde_tpu.utils import timed as j_timed
    from mpc_verde_tpu.utils.profiling import SolvePhaseTimer as JPhase
    from mpc_verde_tpu_torch.utils import SolvePhaseTimer, Timer, timed

    t = Timer()
    for _ in range(3):
        with t.phase("solve"):
            time.sleep(0.001)
    with t.phase("plant"):
        pass
    s = t.summary()
    assert s["solve"]["count"] == 3 and s["plant"]["count"] == 1
    assert s["solve"]["total_s"] >= 0.003
    assert t.mean_ms("missing") == 0.0 and t.total_s("missing") == 0
    with timed("step") as out:
        time.sleep(0.001)
    with j_timed("step") as j_out:
        pass
    assert set(out) == set(j_out) and out["label"] == "step"
    assert out["seconds"] >= 0.001
    samples = {"rollout": [0.01, 0.02], "backward": [0.5]}
    for mine, theirs in ((Timer, JTimer), (SolvePhaseTimer, JPhase)):
        m, j = mine(), theirs()
        m.samples = {k: list(v) for k, v in samples.items()}
        j.samples = {k: list(v) for k, v in samples.items()}
        assert m.summary() == j.summary()
    assert SolvePhaseTimer.PHASES == JPhase.PHASES
    m.samples, j.samples = dict(samples), dict(samples)
    assert m.report() == j.report()


def test_device_trace_on_the_cpu(tmp_path):
    from mpc_verde_tpu_torch.utils import device_trace

    with device_trace(str(tmp_path / "trace")) as tr:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert not tr.cuda and tr.kernels == {}
    path = Path(tr.path)
    assert path.parent == tmp_path / "trace" and path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_xlsx_crosses_between_the_packages(tmp_path):
    from mpc_verde_tpu.refgen.xlsx import read_xlsx as j_read
    from mpc_verde_tpu.refgen.xlsx import write_xlsx as j_write
    from mpc_verde_tpu_torch.refgen.xlsx import read_xlsx, write_xlsx

    cols = {"a": np.array([1.5, np.nan, -3.0, 7.0]),
            "b": np.array([0.0, 2.0 ** -30, 1e300, -1.0 / 3.0]),
            "n & <m>": np.arange(4.0)}
    for index in (True, False):
        mine = write_xlsx(str(tmp_path / f"t{index}.xlsx"), cols, index=index)
        theirs = j_write(str(tmp_path / f"j{index}.xlsx"), cols, index=index)
        for got, ref in ((read_xlsx(theirs), j_read(theirs)),
                         (j_read(mine), read_xlsx(mine))):
            assert list(got) == list(ref)
            for k in got:
                np.testing.assert_array_equal(got[k], ref[k])
        back = read_xlsx(mine)
        for k, v in cols.items():
            np.testing.assert_array_equal(back[k], v)


def _runs(rng):
    xs, us = rng.normal(size=(21, 3)), rng.normal(size=(20, 2))
    lxs, lus = rng.normal(size=(31, 3)), rng.normal(size=(30, 1))
    refs = rng.normal(size=(30, 4))
    traj = (rng.normal(size=40), rng.normal(size=40))
    return ((lambda exp, p: exp[0](p, xs, us, 0.2)),
            (lambda exp, p: exp[1](p, lxs, lus, traj, refs)))


@pytest.mark.parametrize("ext", [".csv", ".xlsx"])
def test_export_layouts_and_compare_match_jax(tmp_path, ext):
    from mpc_verde_tpu.runtime import export as j_export

    rng = np.random.default_rng(11)
    mine_exp = (export_diffdrive_run, export_lane_change_run)
    j_exp = (j_export.export_diffdrive_run, j_export.export_lane_change_run)
    for i, write in enumerate(_runs(rng)):
        p, q = str(tmp_path / f"m{i}{ext}"), str(tmp_path / f"j{i}{ext}")
        write(mine_exp, p)
        write(j_exp, q)
        if ext == ".csv":   # the same repr floats, byte for byte
            assert Path(p).read_bytes() == Path(q).read_bytes()
        ref = j_export.load_run(q)                # a DataFrame
        mine = load_run(p)
        for table in (mine, load_run(q)):   # either writer's file
            assert isinstance(table, dict)
            assert list(table) == list(ref.columns)
            for c in table:
                np.testing.assert_array_equal(table[c], mine[c])
                # pandas' default CSV parser may round the last bits
                np.testing.assert_allclose(table[c], ref[c].to_numpy(),
                                           rtol=1e-14, atol=0)
        # a perturbed copy: compare_runs agrees with JAX's on the same tables
        other = {c: v + (1e-3 if c != "" else 0.0) * np.arange(len(v))
                 for c, v in load_run(p).items()}
        import pandas as pd

        frames = (pd.DataFrame(mine), pd.DataFrame(other))
        for dec in (0, 2):
            assert compare_runs(mine, other, decimals=dec) == \
                j_export.compare_runs(*frames, decimals=dec)
        sub = list(ref.columns)[1:3]
        assert compare_runs(mine, other, columns=sub) == \
            j_export.compare_runs(*frames, columns=sub)
    with pytest.raises(ValueError, match="unrecognized extension"):
        load_run(str(tmp_path / "run.txt"))


def test_checkpoint_roundtrip_and_format(tmp_path):
    from mpc_verde_tpu.runtime.checkpoint import load_checkpoint as j_load

    rng = np.random.default_rng(13)
    state = {"step": np.int64(7), "x": torch.as_tensor(rng.normal(size=3)),
             "warm": rng.normal(size=(5, 2)), "conv": np.ones(7, bool)}
    p = save_checkpoint(str(tmp_path / "ck.npz"), state)
    assert not (tmp_path / "ck.tmp.npz").exists()
    for back in (load_checkpoint(p), j_load(p)):
        for k, v in state.items():
            np.testing.assert_array_equal(back[k], np.asarray(v))


# --- segmented closed loops -------------------------------------------------

def _port_runner():
    from mpc_verde_tpu_torch.models import unicycle
    from mpc_verde_tpu_torch.ops import euler_step
    from mpc_verde_tpu_torch.runtime import make_receding_horizon
    from mpc_verde_tpu_torch.scenarios import build_diffdrive

    b = build_diffdrive(n_steps=STEPS, **CPU64)
    plant = euler_step(unicycle.f, 0.2)
    return lambda n: make_receding_horizon(
        b["ocp"], b["solve"], lambda x, u, pp: plant(x, u, None), n)


def _jax_runner():
    import jax

    from mpc_verde_tpu.models import unicycle
    from mpc_verde_tpu.ops import euler_step
    from mpc_verde_tpu.runtime import make_receding_horizon
    from mpc_verde_tpu.scenarios.diffdrive import build_diffdrive

    b = build_diffdrive(n_steps=STEPS)
    plant = euler_step(unicycle.f, 0.2)
    return lambda n: jax.jit(make_receding_horizon(
        b["ocp"], b["solve"], lambda x, u, pp: plant(x, u, None), n))


PARAMS = np.broadcast_to(np.array([10.0, 10.0, 0.0]), (STEPS, 11, 3)).copy()


class _CutOff(Exception):
    pass


def _cut_on_third(make_runner):
    """``make_runner`` whose runners raise on the third segment they run."""
    calls = []

    def make(n):
        run = make_runner(n)

        def cut(*a):
            calls.append(n)
            if len(calls) == 3:
                raise _CutOff
            return run(*a)
        return cut
    return make


@pytest.fixture(scope="module")
def jax_mono():
    import jax.numpy as jnp

    make = _jax_runner()
    res = make(STEPS)(jnp.zeros(3), jnp.asarray(PARAMS))
    return make, np.asarray(res.xs), np.asarray(res.us)


def test_segmented_run_matches_monolithic_and_jax(tmp_path, jax_mono):
    make = _port_runner()
    mono = make(STEPS)(np.zeros(3), PARAMS)
    ck = str(tmp_path / "run.npz")
    seg = SegmentedRun(make, segment_steps=SEG, checkpoint_path=ck)
    out = seg.run(np.zeros(3), PARAMS, resume=False)
    assert out["xs"].shape == (STEPS + 1, 3) and out["us"].shape == (STEPS, 2)
    np.testing.assert_array_equal(out["xs"], mono.xs.numpy())
    np.testing.assert_array_equal(out["us"], mono.us.numpy())
    np.testing.assert_array_equal(out["converged"], mono.converged.numpy())
    _, j_xs, j_us = jax_mono
    np.testing.assert_allclose(out["xs"], j_xs, rtol=0, atol=1e-9)
    np.testing.assert_allclose(out["us"], j_us, rtol=0, atol=1e-9)
    head = load_checkpoint(ck)
    assert set(head) == {"step", "segments", "x", "warm", "n_total", "x0"}
    assert int(head["step"]) == STEPS and int(head["segments"]) == 3

    # cut off on the third segment, then resumed by a fresh run
    ck2 = str(tmp_path / "cut.npz")
    with pytest.raises(_CutOff):
        SegmentedRun(_cut_on_third(make), SEG, ck2).run(np.zeros(3), PARAMS)
    assert int(load_checkpoint(ck2)["step"]) == 2 * SEG
    calls = []
    counted = lambda n: (calls.append(n), make(n))[1]
    again = SegmentedRun(counted, SEG, ck2).run(np.zeros(3), PARAMS)
    np.testing.assert_array_equal(again["xs"], mono.xs.numpy())
    np.testing.assert_array_equal(again["us"], mono.us.numpy())
    # a stale checkpoint (another start) is not resumed: the run starts over
    x0b = np.array([0.5, 0.0, 0.0])
    fresh = SegmentedRun(make, SEG, ck2).run(x0b, PARAMS)
    np.testing.assert_array_equal(fresh["xs"][0], x0b)
    np.testing.assert_array_equal(
        fresh["xs"], make(STEPS)(x0b, PARAMS).xs.numpy())


def test_port_resumes_a_jax_checkpoint(tmp_path, jax_mono):
    from mpc_verde_tpu.runtime.checkpoint import SegmentedRun as JSegmented

    j_make, j_xs, j_us = jax_mono
    ck = str(tmp_path / "jax.npz")
    with pytest.raises(_CutOff):
        JSegmented(_cut_on_third(j_make), SEG, ck).run(np.zeros(3), PARAMS)
    assert int(load_checkpoint(ck)["segments"]) == 2
    out = SegmentedRun(_port_runner(), SEG, ck).run(np.zeros(3), PARAMS)
    np.testing.assert_allclose(out["xs"], j_xs, rtol=0, atol=1e-9)
    np.testing.assert_allclose(out["us"], j_us, rtol=0, atol=1e-9)


def test_jax_resumes_a_port_checkpoint(tmp_path, jax_mono):
    from mpc_verde_tpu.runtime.checkpoint import SegmentedRun as JSegmented

    j_make, j_xs, j_us = jax_mono
    ck = str(tmp_path / "port.npz")
    with pytest.raises(_CutOff):
        SegmentedRun(_cut_on_third(_port_runner()), SEG, ck).run(
            np.zeros(3), PARAMS)
    out = JSegmented(j_make, SEG, ck).run(np.zeros(3), PARAMS)
    np.testing.assert_allclose(out["xs"], j_xs, rtol=0, atol=1e-9)
    np.testing.assert_allclose(out["us"], j_us, rtol=0, atol=1e-9)
