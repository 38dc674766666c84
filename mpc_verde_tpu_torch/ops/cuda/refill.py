"""The streaming solver's refill: a hand-written CUDA kernel and its PyTorch twin.

Each loop turn of ``make_streaming_solver`` writes the result row of every
slot whose problem finished (``done`` with a problem, ``prob < M``) to the
packed output buffer and loads the next queued problem into it, with a
fresh solver state; a finished slot with no problem left idles with
``prob = M``.  ``SLOT_STATE`` names the slot tensors in the order both
functions take and return them.

``refill_slots`` replaces no TPU kernel: in the JAX solver the refill is a
few selects inside the one XLA program of its ``lax.while_loop``.  In
PyTorch those selects are some 45 kernels a turn over every slot: a
full-width ``cat`` of the result rows scattered to ``out`` (every slot that
did not finish to one dummy row), a full-width gather of queued rows and a
select a slot tensor, although a turn changes a few percent of the slots.
The kernel (``csrc/refill.cuh``, its own library, ``build.refill_entry``)
touches those slots alone.  What bounds it on the H100 is the bytes of the
rows it moves; its design keeps to them: one block ranks the finished slots
in slot order and writes their list and count to device memory, then a
fixed grid of warps walks the list, one slot a warp, with loads and stores
coalesced along the rows.  The host reads no count, and no other slot, no
other row of ``out`` and never its dummy row ``M`` is written.

On the card the slot tensors are updated **in place**: ``refill_slots``
returns the very tensors it was given.  The solver's carry is safe to write:
each of its tensors is a fresh result of the accept, the restarts or the
re-base (``torch.where``, ``&``, ``+``) or of the slots' first load, and no
other live tensor shares its storage; K2's outputs are read by the accept
before the refill and never kept.

``refill_slots_torch`` is the plain PyTorch version, the solver's refill as
it was written before the kernel, on any device and dtype; it returns new
tensors.  Both give the same bits, rows of ``out`` below ``M`` included.
"""
from __future__ import annotations

import torch

from .build import check_launch, refill_entry

# the slot tensors, in the order the refill takes and returns them: B-rows of
# the solver's carry and bookkeeping (float: xs, us, cost, reg, gnorm, x0s,
# ps; int32: it, stall, rst, iacc, alr, prob; bool: done, fail, ddp_on,
# capped)
SLOT_STATE = ("xs", "us", "cost", "reg", "it", "done", "gnorm", "stall",
              "fail", "ddp_on", "x0s", "ps", "capped", "rst", "iacc", "alr",
              "prob")
_FLOAT = ("xs", "us", "cost", "reg", "gnorm", "x0s", "ps")
_BOOL = ("done", "fail", "ddp_on", "capped")
_DTYPES = {torch.float32: 0, torch.float64: 1}   # the C entry's ids


def refill_slots_torch(state, nq, out, qpk, *, reg_init: float,
                       use_ddp: bool):
    """The refill in plain PyTorch: ``(state, nq)`` after one turn.

    ``state`` is the tuple of ``SLOT_STATE``: xs (B, N+1, nx), us (B, N,
    nu), ps (B, N+1, npar), x0s (B, nx) and the rest (B,); nq the 0-d int32
    queue pointer.  ``out`` (M+1, sx+su+4) receives each finished slot's
    ``[xs | us | cost gnorm iterations converged]`` at its row ``prob``
    (every other slot writes the dummy row M); ``qpk`` (M, nx+sp+su+sx+1)
    holds the queue's packed ``[x0 | ps | us | xs | cost]`` rows.
    """
    (xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on, x0s, ps,
     capped, rst, iacc, alr, prob) = state
    B, N1, nx = xs.shape
    N, nu = us.shape[1:]
    npar = ps.shape[-1]
    M = qpk.shape[0]
    sx, su, sp = N1 * nx, N * nu, N1 * npar
    dt = out.dtype
    fin = done & (prob < M)
    widx = torch.where(fin, prob, M)
    conv = ~fail & torch.isfinite(cost) & ~capped
    row = torch.cat(
        [xs.reshape(B, sx), us.reshape(B, su), cost[:, None], gnorm[:, None],
         (iacc + it.clamp(min=0)).to(dt)[:, None], conv.to(dt)[:, None]],
        dim=1)
    out[widx] = row

    rank = torch.cumsum(fin.to(torch.int32), 0, dtype=torch.int32) - 1
    cand = nq + rank
    has = fin & (cand < M)
    qrow = qpk[cand.clamp(0, M - 1)]
    h2, h3 = has[:, None], has[:, None, None]
    x0s = torch.where(h2, qrow[:, :nx], x0s)
    ps = torch.where(h3, qrow[:, nx:nx + sp].reshape(B, N1, npar), ps)
    us = torch.where(h3, qrow[:, nx + sp:nx + sp + su].reshape(B, N, nu), us)
    xs = torch.where(
        h3, qrow[:, nx + sp + su:nx + sp + su + sx].reshape(B, N1, nx), xs)
    cost = torch.where(has, qrow[:, -1], cost)
    reg = torch.where(has, reg_init, reg)
    it = torch.where(has, 0, it)
    gnorm = torch.where(has, torch.inf, gnorm)
    stall = torch.where(has, 0, stall)
    fail = fail & ~has
    ddp_on = torch.where(has, bool(use_ddp), ddp_on)
    capped = capped & ~has
    done = done & ~has
    prob = torch.where(has, cand, torch.where(fin, M, prob))
    rst = torch.where(has, 0, rst)
    iacc = torch.where(has, 0, iacc)
    alr = torch.where(has, 0, alr)
    nq = nq + has.sum(dtype=torch.int32)
    return ((xs, us, cost, reg, it, done, gnorm, stall, fail, ddp_on,
             x0s.contiguous(), ps.contiguous(), capped, rst, iacc, alr, prob),
            nq)


def _check(state, nq, out, qpk):
    """Raise unless the kernel takes these tensors; returns (B, M, nx, sp,
    su, sx)."""
    named = dict(zip(SLOT_STATE, state), nq=nq, out=out, qpk=qpk)
    dev, dt = state[0].device, state[0].dtype
    if dt not in _DTYPES:
        raise TypeError(f"refill_slots: xs is {dt}; the kernel takes float32 "
                        "or float64")
    B, N1, nx = state[0].shape
    _, N, nu = state[1].shape
    npar = state[11].shape[-1]
    M = qpk.shape[0]
    sx, su, sp = N1 * nx, N * nu, N1 * npar
    shapes = dict(xs=(B, N1, nx), us=(B, N, nu), x0s=(B, nx),
                  ps=(B, N1, npar), nq=(), out=(M + 1, sx + su + 4),
                  qpk=(M, nx + sp + su + sx + 1))
    for name, t in named.items():
        want = (dt if name in _FLOAT + ("out", "qpk") else
                torch.bool if name in _BOOL else torch.int32)
        if t.device != dev:
            raise ValueError(f"refill_slots: {name} on {t.device}, expected "
                             f"{dev}")
        if t.dtype != want:
            raise TypeError(f"refill_slots: {name} is {t.dtype}, expected "
                            f"{want}")
        if tuple(t.shape) != shapes.get(name, (B,)):
            raise ValueError(f"refill_slots: {name} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"{shapes.get(name, (B,))}")
        if not t.is_contiguous():
            raise ValueError(f"refill_slots: {name} is not contiguous")
    if M < 1:
        raise ValueError("refill_slots: the queue is empty")
    return B, M, nx, sp, su, sx


def refill_slots(state, nq, out, qpk, *, reg_init: float, use_ddp: bool):
    """One turn's refill: ``(state, nq)`` as ``refill_slots_torch`` gives
    them, bit for bit.

    On CPU tensors the twin.  On the card one call of the kernel's entry
    point (two launches, the scan and the moves) on PyTorch's current
    stream, which updates the slot tensors, ``nq`` and the finished slots'
    rows of ``out`` in place and returns the same tensors.  Every tensor
    must be contiguous and on one device, the float ones float32 or float64
    alike, the counters int32 and the flags bool; anything else raises.
    ``launches`` counts the calls of the entry point.
    """
    if state[0].device.type == "cpu":
        return refill_slots_torch(state, nq, out, qpk, reg_init=reg_init,
                                  use_ddp=use_ddp)
    if not state[0].is_cuda:
        raise ValueError(f"refill_slots: unsupported device {state[0].device}")
    B, M, nx, sp, su, sx = _check(state, nq, out, qpk)
    scratch = torch.empty((B + 2,), dtype=torch.int32, device=state[0].device)
    launch = refill_entry()
    with torch.cuda.device(state[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(_DTYPES[state[0].dtype], B, M, nx, sp, su, sx,
                    float(reg_init), int(bool(use_ddp)),
                    *(t.data_ptr() for t in state), nq.data_ptr(),
                    out.data_ptr(), qpk.data_ptr(), scratch.data_ptr(),
                    stream)
    check_launch(rc, "mv_refill_slots")
    refill_slots.launches += 1
    return state, nq


refill_slots.launches = 0
