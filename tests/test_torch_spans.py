"""The solvers' spans and counters (``utils.profiling``), on the CPU.

With no profiler recording, no span site builds a ``record_function``;
under ``torch.profiler`` the trace holds the named spans, nested as the
loops nest; the counters agree with the spans and with each other; a
traced solve returns the bits of an untraced one; ``read_spans`` splits a
block's idle and kernel time by span exactly, and ``device_trace`` gives
its block's counters and spans.
"""
import copy
import json

import numpy as np
import pytest
import torch

import mpc_verde_tpu_torch as mt
from mpc_verde_tpu_torch.interop import bench_ocp
from mpc_verde_tpu_torch.runtime import make_batched_receding_horizon
from mpc_verde_tpu_torch.utils import device_trace
from mpc_verde_tpu_torch.utils.profiling import (COUNTER_NAMES, counters,
                                                read_spans)

N, M, W = 6, 10, 4
OPTS = dict(max_iters=20, tol_grad=1e-4, tol_cost=1e-6, n_alphas=4,
            alpha_decay=0.4)


def _inputs(rows):
    g = torch.Generator().manual_seed(3)
    x0 = 4.0 * torch.rand((rows, 3), generator=g, dtype=torch.float64) - 2.0
    ps = torch.tensor([10.0, 10.0, 0.0], dtype=torch.float64).expand(
        rows, N + 1, 3)
    return x0, ps


def _plant(x, u, p):
    th = x[2]
    return x + 0.2 * torch.stack([u[0] * torch.cos(th),
                                  u[0] * torch.sin(th), u[1]])


def _case(name):
    """(run, width, refill_every, loops): ``run()`` returns the results, a
    list of (iterations, converged, us) tensors; ``width`` is the slots of
    one iteration, ``refill_every`` the iterations of one streaming turn
    (None for the batched loop), ``loops`` the solver loops it runs."""
    ocp = bench_ocp(N, "cpu", torch.float64)
    opts = mt.ILQROptions(**OPTS)
    if name == "batched":
        x0, ps = _inputs(M)
        solve = mt.make_batched_ilqr_solver(ocp, opts)
        return (lambda: [_keep(solve(x0, ps))]), M, None, 1
    if name == "streaming_rounds":
        # two rounds, the second at the same params: the rounds' advance
        # and cost re-base run, two iterations a turn
        x0, ps = _inputs(W + 2)
        advance = lambda p, xs, r: p + 0.0
        solve = mt.make_streaming_solver(ocp, opts, batch_width=W,
                                         restarts=1, refill_every=2,
                                         rounds=(2, advance))
        return (lambda: [_keep(solve(x0, ps))]), W, 2, 1
    if name == "streaming_barrier":
        x0, ps = _inputs(W + 1)
        solve = mt.make_streaming_barrier_solver(
            ocp, opts, batch_width=W, restarts=1, inexact_kappa=10.0)
        return (lambda: [_keep(solve(x0, ps))]), W, 1, 1
    if name == "receding_batched":
        B = 3
        x0, _ = _inputs(B)
        params = torch.tensor([10.0, 10.0, 0.0], dtype=torch.float64).expand(
            2, N + 1, 3)
        run = make_batched_receding_horizon(
            ocp, mt.make_batched_ilqr_solver(ocp, opts), _plant, 2)

        def steps():
            r = run(x0, params)
            return [(r.iterations[t], r.converged[t], r.us[t])
                    for t in range(2)]
        return steps, B, None, 2
    raise ValueError(name)


def _keep(r):
    return (r.iterations, r.converged, r.us)


CASES = ("batched", "streaming_rounds", "streaming_barrier",
         "receding_batched")


def _spans(prof, tmp_path):
    """[(name, name of its innermost enclosing span or None)] of the
    trace's ``mpc.*`` spans, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), -float(e["dur"]), e["name"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("mpc."))
    out, open_ = [], []      # open_: [(end, name)] of the enclosing spans
    for ts, neg_dur, name in spans:
        end = ts - neg_dur
        while open_ and open_[-1][0] < end:
            open_.pop()
        out.append((name, open_[-1][1] if open_ else None))
        open_.append((end, name))
    return out


# each span's allowed innermost enclosing spans
PARENTS = {
    "mpc.step": {None},
    "mpc.solve": {None, "mpc.step", "mpc.solve"},
    "mpc.plant": {"mpc.step"},
    "mpc.preroll": {"mpc.solve"},
    "mpc.unpack": {"mpc.solve"},
    "mpc.turn": {"mpc.solve"},
    "mpc.refill": {"mpc.turn"},
    "mpc.direction": {"mpc.turn"},
    "mpc.linesearch": {"mpc.turn"},
    "mpc.accept": {"mpc.turn"},
    "mpc.rebase": {"mpc.turn", "mpc.solve"},
    "mpc.flag": {"mpc.solve"},
}


@pytest.mark.parametrize("case", CASES)
def test_no_record_function_without_a_profiler(case, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no "
                             "profiler recording")

    run, _, _, _ = _case(case)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = counters()
    run()
    assert counters()["turns"] > before["turns"]


@pytest.mark.parametrize("case", CASES)
def test_spans_nest_and_agree_with_the_counters(case, tmp_path):
    run, width, refill_every, loops = _case(case)
    plain = run()
    before = counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = run()
    d = {k: v - before[k] for k, v in counters().items()}
    spans = _spans(prof, tmp_path)
    names = [name for name, _ in spans]

    # traced and untraced solves give the same bits
    for a, b in zip(plain, traced):
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    for name, parent in spans:
        assert parent in PARENTS[name], (name, parent)
    expect = {"mpc.solve", "mpc.preroll", "mpc.turn", "mpc.direction",
              "mpc.linesearch", "mpc.accept", "mpc.flag", "mpc.unpack"}
    if refill_every is not None:
        expect |= {"mpc.refill"}
    if case in ("streaming_rounds", "streaming_barrier"):
        expect |= {"mpc.rebase"}
    if case == "receding_batched":
        expect |= {"mpc.step", "mpc.plant"}
        assert names.count("mpc.step") == names.count("mpc.plant") == 2
    assert expect <= set(names)

    # at quorum 1 one flag read before each turn and one after a loop's
    # last, each in its own mpc.flag span
    assert d["turns"] == names.count("mpc.turn") > 0
    assert d["flag_reads"] == names.count("mpc.flag") == d["turns"] + loops
    assert d["iterations"] == names.count("mpc.direction") \
        == names.count("mpc.linesearch")
    if refill_every is not None:
        assert d["iterations"] == d["turns"] * refill_every
        assert names.count("mpc.refill") == d["turns"]
    assert d["slot_iterations"] == width * d["iterations"]
    # the slots' work covers every iteration the solves report
    assert sum(int(r[0].sum()) for r in traced) <= d["slot_iterations"]
    # counters() reads the kernels' launch counters; no kernel runs here
    assert set(COUNTER_NAMES) | {"k1", "k2", "k3"} == set(d)
    assert d["k1"] == d["k2"] == d["k3"] == 0


def test_quorum_reads_twice_a_test_while_the_batch_runs():
    """Under a quorum a test while the batch still runs makes two reads
    (the last one, when every problem stopped, one); a solve of t turns
    makes t + 1 tests, and a zero budget one."""
    ocp = bench_ocp(N, "cpu", torch.float64)
    x0, ps = _inputs(M)
    for quorum, reads in ((0.5, lambda t: (2 * t + 1, 2 * t + 2)),
                          (1.0, lambda t: (t + 1,))):
        solve = mt.make_batched_ilqr_solver(
            ocp, mt.ILQROptions(**OPTS, quorum=quorum))
        before = counters()
        r = solve(x0, ps)
        d = {k: v - before[k] for k, v in counters().items()}
        assert d["turns"] == int(r.iterations.max()) > 0
        assert d["flag_reads"] in reads(d["turns"])
    before = counters()
    r = mt.make_batched_ilqr_solver(
        ocp, mt.ILQROptions(**dict(OPTS, max_iters=0)))(x0, ps)
    assert counters()["flag_reads"] == before["flag_reads"] + 1
    assert counters()["turns"] == before["turns"]
    assert int(r.iterations.max()) == 0
    np.testing.assert_array_equal(r.converged.numpy(), np.zeros(M, bool))


def X(name, ts, dur, cat, **args):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if args:
        e["args"] = args
    return e


# a block of 100 us: a solve with a turn (direction inside), a flag read
# and an unpack; kernels launched under the direction (nested three deep),
# under the solve alone, outside every span, and one whose launch is not
# in the trace; a copy; the card's copy of a range, which is not the host's
EVENTS = [
    X("block", 0.0, 100.0, "user_annotation"),
    X("mpc.solve", 10.0, 80.0, "user_annotation"),
    X("mpc.turn", 20.0, 30.0, "user_annotation"),
    X("mpc.direction", 22.0, 8.0, "user_annotation"),
    X("mpc.flag", 50.0, 10.0, "user_annotation"),
    X("mpc.unpack", 80.0, 8.0, "user_annotation"),
    X("mpc.turn", 20.0, 30.0, "gpu_user_annotation"),
    X("aten::where", 40.0, 1.0, "cpu_op"),
    X("cudaLaunchKernel", 23.0, 1.0, "cuda_runtime", correlation=1),
    X("cuLaunchKernel", 15.0, 1.0, "cuda_driver", correlation=2),
    X("cudaLaunchKernel", 5.0, 1.0, "cuda_runtime", correlation=3),
    X("fused_thread_kernel", 25.0, 10.0, "kernel", correlation=1),
    X("gemvx", 40.0, 5.0, "kernel", correlation=2),
    X("index_elementwise_kernel", 70.0, 2.0, "kernel", correlation=3),
    X("elementwise_kernel", 91.0, 2.0, "kernel", correlation=4),
    X("Memcpy DtoH", 46.0, 2.0, "gpu_memcpy"),
]


def test_read_spans_splits_idle_and_kernel_time_exactly():
    events = copy.deepcopy(EVENTS)
    r = read_spans(events, "block")
    assert events == EVENTS
    us = 1e-6
    assert r["idle_by_span"] == pytest.approx({
        "outside": 18 * us, "mpc.solve": 30 * us, "mpc.turn": 10 * us,
        "mpc.direction": 3 * us, "mpc.flag": 10 * us,
        "mpc.unpack": 8 * us}, abs=1e-12)
    assert r["device_by_span"] == pytest.approx({
        "mpc.direction": 10 * us, "mpc.solve": 5 * us, "outside": 2 * us,
        "unmatched": 2 * us}, abs=1e-12)
    assert r["spans"] == {
        "mpc.direction": {"count": 1, "total_s": pytest.approx(8 * us),
                          "self_s": pytest.approx(8 * us)},
        "mpc.flag": {"count": 1, "total_s": pytest.approx(10 * us),
                     "self_s": pytest.approx(10 * us)},
        "mpc.solve": {"count": 1, "total_s": pytest.approx(80 * us),
                      "self_s": pytest.approx(32 * us)},
        "mpc.turn": {"count": 1, "total_s": pytest.approx(30 * us),
                     "self_s": pytest.approx(22 * us)},
        "mpc.unpack": {"count": 1, "total_s": pytest.approx(8 * us),
                       "self_s": pytest.approx(8 * us)}}
    # the buckets sum to the block's idle time (100 us less the busy
    # 25-35, 40-45, 46-48, 70-72 and 91-93) and kernel time
    assert sum(r["idle_by_span"].values()) == pytest.approx(79 * us)
    assert sum(r["device_by_span"].values()) == pytest.approx(19 * us)


def test_read_spans_counts_nested_spans_of_one_name_once():
    events = copy.deepcopy(EVENTS) + [
        X("mpc.solve", 12.0, 70.0, "user_annotation"),
        X("mpc.solve", 12.0, 70.0, "gpu_user_annotation")]
    r = read_spans(events, "block")
    assert r["spans"]["mpc.solve"]["count"] == 2
    assert r["spans"]["mpc.solve"]["total_s"] == pytest.approx(80e-6)
    assert r["spans"]["mpc.turn"]["count"] == 1
    assert sum(v["self_s"] for v in r["spans"].values()) == pytest.approx(
        80e-6)
    with pytest.raises(RuntimeError, match="no 'device_trace' range"):
        read_spans(events)


@pytest.mark.parametrize("kind", ("batched", "streaming"))
def test_device_trace_gives_its_blocks_counters_and_spans(kind, tmp_path):
    ocp = bench_ocp(N, "cpu", torch.float64)
    opts = mt.ILQROptions(**OPTS)
    x0, ps = _inputs(M)
    solve, width = ((mt.make_batched_ilqr_solver(ocp, opts), M)
                    if kind == "batched" else
                    (mt.make_streaming_solver(ocp, opts, batch_width=W,
                                              restarts=1), W))
    solve(x0, ps)
    before = counters()
    with device_trace(str(tmp_path)) as tr:
        r = solve(x0, ps)
    d = {k: v - before[k] for k, v in counters().items()}
    assert tr.counters == d
    assert d["slot_iterations"] == width * d["iterations"] > 0
    # the share of the slot-work spent on problems still being solved
    assert 0 < int(r.iterations.sum()) <= d["slot_iterations"]
    assert tr.spans["mpc.turn"]["count"] == d["turns"]
    assert tr.spans["mpc.flag"]["count"] == d["flag_reads"] == d["turns"] + 1
    assert tr.spans["mpc.solve"]["count"] == 1
    # no card: the block is idle throughout, split among the spans and
    # the caller's code outside them, and no kernel ran
    window = json.loads(open(tr.path).read())["traceEvents"]
    block = [e for e in window if e.get("name") == "device_trace"
             and e.get("cat") == "user_annotation"][0]
    assert sum(tr.idle_by_span.values()) == pytest.approx(
        1e-6 * float(block["dur"]))
    assert tr.idle_by_span["mpc.flag"] > 0.0
    assert tr.device_by_span == {}
