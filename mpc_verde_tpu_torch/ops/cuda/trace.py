"""Trace an OCP's callables into one flat scalar program.

The port's counterpart of the JAX package's ``_hoist_consts``, ``_CSE`` and
``_eval_jaxpr_nodot`` (``mpc_verde_tpu/ops/pallas/rollout.py``).  The Pallas
kernels K2 and K3 inline the jaxpr of the OCP's own callables; the CUDA
kernels cannot inline a Python callable, so ``trace_ocp`` traces the four
callables with ``make_fx`` and lowers them to a program over scalars that
``codegen.py`` turns into a device model, on which the hand-written kernels
(``csrc/rollout.cuh``, ``csrc/fused.cuh``) are instantiated.

* The callables are traced at single-vector example shapes: ``F(x, u, p)``
  and ``l(x, u, p)`` at ``x (nx,)``, ``u (nu,)``, ``p (max(npar, 1),)``,
  ``lf(x, p)`` and ``cb(x, p, k)`` with ``k`` a 0-d int64 tensor, so that a
  per-stage box ``lb[k]`` stays a read of its table at the stage index and is
  never a row baked in at trace time.  A callable that reads a value of its
  inputs in Python (a branch on ``x``, an ``int(k)``) cannot be traced and
  raises.
* The trace allocates nothing on the OCP's device: the example inputs lie
  on the host, and every op of the trace runs on host copies of its
  operands (``_OnHost``), so a program is traced without a card, and
  equally for an OCP whose tensors lie on one.  The graph still records the
  closed-over tensors themselves, wherever they lie.  A callable's move of
  a tensor to another device (``as_tensor(lb, device=u.device)``, ``.to``)
  is dropped (``_NoMoves``), so the program's text is the same whichever
  device the OCP's tensors lie on.
* Every ATen op lowers to scalar SSA with every small static shape unrolled:
  ``mm`` / ``mv`` / ``dot`` become products and sums, as the JAX package
  decomposes ``dot_general``.  The table holds every primitive that Mosaic
  lowers into the Pallas kernels (``jax/_src/pallas/mosaic/lowering.py``):
  beside the arithmetic, sin, cos, tan, exp, log, sqrt and abs also tanh,
  the sigmoid, log1p, exp2, erfinv, floor, ceil, round (half to even),
  sign, pow with a tensor exponent, fmod and remainder, and the max / min
  reductions.  Composites are decomposed in the trace into those ops
  (``_DECOMPOSITIONS``: softplus, logaddexp, hypot, the Huber and smooth
  L1 losses, silu, logsumexp, and the backward ops of tanh, sigmoid and
  softplus where a callable differentiates itself), as JAX builds them
  from its primitives.  An op outside ``LOWERINGS`` raises
  ``NotImplementedError`` naming the op and the callable: atan, atan2,
  asin, acos, sinh, cosh, erf and expm1 among them, which Mosaic does not
  lower either.
* Floating tensors the callables close over (weights, a per-stage bound
  table) are hoisted into one float table, as JAX hoists its constants; the
  program holds offsets into it, never its values, so one program, and one
  build of its kernels, serves OCPs that differ only in their weights.
  The program keeps the hoisted tensors themselves and reads their current
  values (``Program.table``), so a weight changed in place is followed.
  Integer and bool tensors, and Python scalars, stay literals.
* Equal instructions are merged by a value-keyed CSE: the key is the
  instruction itself (a literal keyed by its exact bits), never a hash of
  it, as JAX's ``_params_key`` keys on values (``hash(-1) == hash(-2)``).

``Program.evaluate`` is the plain PyTorch evaluator of the program, the twin
of the generated device model: batched over leading dims, any float dtype,
differentiable by ``torch.func``.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable

import numpy as np
import torch
from torch._decomp import get_decompositions
from torch.fx.experimental.proxy_tensor import make_fx
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

aten = torch.ops.aten

# value kinds: float, bool, int (the stage index and what is computed from it)
F, B, I = "f", "b", "i"
FLOAT_UNARY = ("neg", "sin", "cos", "tan", "exp", "log", "sqrt", "abs",
               "recip", "tanh", "sigmoid", "log1p", "exp2", "erfinv", "floor",
               "ceil", "round", "sign")
# "rem" is torch.remainder / jnp.remainder (the divisor's sign), "fmod" C's
# fmod (the dividend's sign, lax.rem)
FLOAT_BINARY = ("add", "sub", "mul", "div", "max", "min", "pow", "fmod",
                "rem")
COMPARE = ("gt", "lt", "ge", "le", "eq", "ne")
INT_BINARY = ("addi", "subi", "muli")
LITERALS = ("cf", "ci", "cb")


def _remainder(a, b):
    """torch.remainder's rule on C's fmod: the result takes b's sign."""
    r = np.fmod(a, b)
    return r + b if r != 0 and (r < 0) != (b < 0) else r


_FOLD = {
    "neg": operator.neg, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "exp": np.exp, "log": np.log, "sqrt": np.sqrt, "abs": abs,
    "recip": lambda a: np.float64(1.0) / a,
    "tanh": np.tanh, "sigmoid": lambda a: 1.0 / (1.0 + np.exp(-a)),
    "log1p": np.log1p, "exp2": np.exp2,
    "erfinv": lambda a: torch.erfinv(torch.tensor(a, dtype=torch.float64))
    .item(),
    "floor": np.floor, "ceil": np.ceil, "round": np.rint,
    "sign": lambda a: np.float64(int(a > 0) - int(a < 0)),   # 0 at NaN
    "pow": np.power, "fmod": np.fmod, "rem": _remainder,
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": lambda a, b: np.float64(a) / b,
    "max": lambda a, b: np.fmax(a, b) if not (np.isnan(a) or np.isnan(b))
    else np.nan,
    "min": lambda a, b: np.fmin(a, b) if not (np.isnan(a) or np.isnan(b))
    else np.nan,
    "gt": operator.gt, "lt": operator.lt, "ge": operator.ge,
    "le": operator.le, "eq": operator.eq, "ne": operator.ne,
    "and": lambda a, b: a and b, "or": lambda a, b: a or b,
    "not": operator.not_, "addi": operator.add, "subi": operator.sub,
    "muli": operator.mul, "i2f": float, "b2f": float,
}


def _kind_of_dtype(dtype) -> str:
    if dtype == torch.bool:
        return B
    return F if dtype.is_floating_point else I


class _SSA:
    """The SSA instructions with their value-keyed CSE and literal folding.

    An instruction is a tuple ``(op, *fields)``; value i is instruction i.
    Fields are value numbers, or for the leaves an input's name and
    position, a table offset or a literal.  A float literal is keyed by its
    exact bits (``float.hex``), so -0.0 and 0.0, or -1.0 and -2.0, never
    merge."""

    def __init__(self):
        self.ops, self.kinds, self.memo = [], [], {}

    def _emit(self, ins, kind):
        key = ins if ins[0] != "cf" else ("cf", float(ins[1]).hex())
        v = self.memo.get(key)
        if v is None:
            v = self.memo[key] = len(self.ops)
            self.ops.append(ins)
            self.kinds.append(kind)
        return v

    def lit(self, value, kind=F):
        if kind == F:
            return self._emit(("cf", float(value)), F)
        if kind == I:
            return self._emit(("ci", int(value)), I)
        return self._emit(("cb", bool(value)), B)

    def leaf(self, ins, kind=F):
        return self._emit(ins, kind)

    def literal_value(self, v):
        ins = self.ops[v]
        return ins[1] if ins[0] in LITERALS else None

    def op(self, name, *args):
        kinds = [self.kinds[a] for a in args]
        if name in FLOAT_UNARY + FLOAT_BINARY:
            if any(k != F for k in kinds):
                raise TypeError(f"{name} takes floats, not {kinds}")
            kind = F
        elif name in COMPARE:
            if kinds[0] != kinds[1] or kinds[0] == B:
                raise TypeError(f"{name} compares two floats or two ints, "
                                f"not {kinds}")
            kind = B
        elif name in ("and", "or", "not"):
            if any(k != B for k in kinds):
                raise TypeError(f"{name} takes bools, not {kinds}")
            kind = B
        elif name in INT_BINARY:
            if any(k != I for k in kinds):
                raise TypeError(f"{name} takes ints, not {kinds}")
            kind = I
        elif name in ("i2f", "b2f"):
            kind = F
        elif name == "sel":
            if kinds[0] != B or kinds[1] != kinds[2]:
                raise TypeError(f"sel takes a bool and two values of one "
                                f"kind, not {kinds}")
            c = self.literal_value(args[0])
            if c is not None:
                return args[1] if c else args[2]
            if args[1] == args[2]:
                return args[1]
            kind = kinds[1]
        else:
            raise ValueError(f"unknown instruction {name!r}")
        vals = [self.literal_value(a) for a in args]
        if all(v is not None for v in vals):
            with np.errstate(all="ignore"):
                return self.lit(_FOLD[name](*map(np.float64 if kind == F
                                                  else (lambda v: v), vals)),
                                kind)
        return self._emit((name, *args), kind)


def _ids(a):
    return np.asarray(a, dtype=object)


class _KIndex(TorchFunctionMode):
    """Index by a 0-d integer tensor as ``aten.index`` (a read at the index
    the tensor holds), where Python would call ``int()`` on it: ``lb[k]``
    with the traced stage index stays symbolic."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            t, idx = args
            if (isinstance(idx, torch.Tensor) and idx.dim() == 0
                    and not idx.is_floating_point()
                    and idx.dtype != torch.bool):
                return aten.index.Tensor(t, [idx])
        return func(*args, **(kwargs or {}))


class _NoMoves(TorchFunctionMode):
    """Drop the device of ``torch.as_tensor`` / ``Tensor.to`` on a tensor
    (a cast stays) and ``Tensor.cpu`` / ``cuda``: where a callable moves a
    closed-over tensor to its inputs' device, the graph is the one of the
    same callable with both on one device, which records no copy."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in (torch.as_tensor, torch.asarray) and args
                and isinstance(args[0], torch.Tensor)):
            kwargs = {k: v for k, v in kwargs.items() if k != "device"}
        elif func in (torch.Tensor.cpu, torch.Tensor.cuda):
            return args[0]
        elif func is torch.Tensor.to:
            dtype = torch._C._nn._parse_to(*args[1:], **kwargs)[1]
            return args[0] if dtype is None else args[0].to(dtype)
        return func(*args, **kwargs)


class _OnHost(TorchDispatchMode):
    """Run every op on host copies of its tensors, factories on the host:
    under ``make_fx`` the graph records each op on its real operands (a
    closed-over tensor on the card stays that tensor) and only the values
    the trace computes, which the lowering reads for shapes and dtypes, lie
    on the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        args, kwargs = tree_map_only(
            torch.Tensor, lambda t: t if t.device.type == "cpu" else t.cpu(),
            (args, dict(kwargs or {})))
        if kwargs.get("device") is not None:
            kwargs["device"] = torch.device("cpu")
        return func(*args, **kwargs)


class _Lowering:
    """Lower one traced graph onto the SSA instructions."""

    def __init__(self, b: _SSA, hoist: Callable, callable_name: str):
        self.b, self.hoist, self.name = b, hoist, callable_name

    # ---- values ---------------------------------------------------------
    def arr(self, v, kind=None):
        """A lowered value as an id array; a Python scalar as a literal."""
        if isinstance(v, np.ndarray):
            return v
        if isinstance(v, bool):
            return _ids(self.b.lit(v, B))
        if isinstance(v, int):
            return _ids(self.b.lit(v, kind if kind == F else I))
        if isinstance(v, float):
            return _ids(self.b.lit(v, F))
        raise NotImplementedError(f"{self.name}: cannot lower the operand "
                                  f"{v!r}")

    def kind(self, a):
        kinds = {self.b.kinds[i] for i in a.flat}
        return kinds.pop() if len(kinds) == 1 else (F if F in kinds else I)

    def map(self, name, *arrays):
        return _ids(np.frompyfunc(lambda *a: self.b.op(name, *a), len(arrays),
                             1)(*arrays))

    def to(self, a, kind):
        """Convert every id of ``a`` to ``kind``."""
        def conv(i):
            k = self.b.kinds[i]
            if k == kind:
                return i
            if kind == F:
                return self.b.op("i2f" if k == I else "b2f", i)
            raise NotImplementedError(f"{self.name}: cannot convert a {k} "
                                      f"value to {kind}")
        return _ids(np.frompyfunc(conv, 1, 1)(a))

    def promote(self, *vals):
        """Id arrays of one kind: float if any operand is a float."""
        scal = [v for v in vals if not isinstance(v, np.ndarray)]
        arrs = [self.arr(v) for v in vals if isinstance(v, np.ndarray)]
        kinds = {self.kind(a) for a in arrs if a.size}
        kinds |= {B if isinstance(v, bool) else I if isinstance(v, int)
                  else F for v in scal}
        kind = F if F in kinds else I if I in kinds else B
        return [self.to(self.arr(v, kind), kind) for v in vals], kind

    # ---- arithmetic -----------------------------------------------------
    def arith(self, name, a, b):
        (a, b), kind = self.promote(a, b)
        if name == "div":
            a, b, kind = self.to(a, F), self.to(b, F), F
        if kind == B:
            names = {"add": "or", "mul": "and"}
            if name not in names:
                raise NotImplementedError(f"{self.name}: {name} on bools")
            return self.map(names[name], a, b)
        if kind == I:
            return self.map(name + "i", a, b)
        return self.map(name, a, b)

    def cmp(self, name, a, b):
        (a, b), kind = self.promote(a, b)
        if kind == B:
            raise NotImplementedError(f"{self.name}: {name} on bools")
        return self.map(name, a, b)

    def unary(self, name, a):
        return self.map(name, self.to(self.arr(a), F))

    def binary(self, name, a, b):
        """A float function of two operands (pow, fmod, rem)."""
        (a, b), kind = self.promote(a, b)
        if kind != F:
            _raise(self, f"{name} of integers or bools")
        return self.map(name, a, b)

    def rounding(self, name, a):
        """floor / ceil / round / sign; an integer stays itself (its sign
        an integer)."""
        a = self.arr(a)
        if not a.size or self.kind(a) == F:
            return self.unary(name, a)
        if self.kind(a) != I:
            _raise(self, f"{name} of a bool")
        if name != "sign":
            return a
        return self.select(self.cmp("gt", a, 0), 1, self.select(
            self.cmp("lt", a, 0), -1, 0))

    def select(self, c, a, b):
        (a, b), _ = self.promote(a, b)
        return self.map("sel", self.to(self.arr(c), B), a, b)

    def clamp(self, a, lo=None, hi=None):
        if lo is not None:
            a = self.select(self.cmp("lt", a, lo), lo, a)
        if hi is not None:
            a = self.select(self.cmp("gt", a, hi), hi, a)
        return self.to(self.arr(a), F)

    def fsum(self, a, axis=None, keepdim=False):
        """Sum left to right over ``axis`` (every axis for None)."""
        a = self.arr(a)
        if self.kind(a) == B:
            a = self.to(a, F)
        kind = self.kind(a) if a.size else F
        return self.fold("add" if kind == F else "addi", a, axis, keepdim,
                         lambda: self.b.lit(0, kind))

    def extremum(self, name, a, axis=None, keepdim=False):
        """``name`` ("max" or "min") over ``axis``, left to right, NaN
        propagating as torch.amax / torch.amin: a fold of the binary op."""
        a = self.arr(a)
        if a.size and self.kind(a) != F:
            _raise(self, f"a {name} reduction over integers or bools")
        return self.fold(name, a, axis, keepdim, lambda: _raise(
            self, f"a {name} reduction over no element"))

    def fold(self, op, a, axis, keepdim, empty):
        """``op`` folded left to right over ``axis`` (every axis for None or
        []); ``empty()`` gives an empty row's value."""
        axes = tuple(range(a.ndim)) if axis is None or axis == [] else tuple(
            d % a.ndim for d in (axis if isinstance(axis, (list, tuple))
                                 else (axis,)))
        keep = [d for d in range(a.ndim) if d not in axes]
        t = np.transpose(a, keep + list(axes))
        t = t.reshape(t.shape[:len(keep)] + (-1,))
        out = np.empty(t.shape[:-1], dtype=object)
        for idx in np.ndindex(*out.shape):
            row = t[idx]
            s = row[0] if len(row) else empty()
            for v in row[1:]:
                s = self.b.op(op, s, v)
            out[idx] = s
        if keepdim:
            out = out.reshape([1 if d in axes else a.shape[d]
                               for d in range(a.ndim)])
        return out

    def matmul(self, a, b):
        a, b = self.to(self.arr(a), F), self.to(self.arr(b), F)
        va, vb = a.ndim == 1, b.ndim == 1
        A = a[None, :] if va else a
        Bm = b[:, None] if vb else b
        out = np.empty((A.shape[0], Bm.shape[1]), dtype=object)
        for i in range(A.shape[0]):
            for j in range(Bm.shape[1]):
                s = None
                for t in range(A.shape[1]):
                    p = self.b.op("mul", A[i, t], Bm[t, j])
                    s = p if s is None else self.b.op("add", s, p)
                out[i, j] = self.b.lit(0.0) if s is None else s
        if va:
            out = out[0]
        if vb:
            out = out[..., 0]
        return out

    def power(self, a, e):
        a = self.to(self.arr(a), F)
        e = float(e)
        if e == int(e) and abs(e) <= 64:
            n = abs(int(e))
            if n == 0:
                return _ids(np.frompyfunc(lambda i: self.b.lit(1.0), 1, 1)(a))

            def prod(i):
                s = i
                for _ in range(n - 1):
                    s = self.b.op("mul", s, i)
                return self.b.op("recip", s) if e < 0 else s
            return _ids(np.frompyfunc(prod, 1, 1)(a))
        if e == 0.5:
            return self.map("sqrt", a)
        return self.map("exp", self.arith("mul", e, self.map("log", a)))

    def gather(self, t, idx):
        """``t[idx]`` on the first axis for an int id: a read of the float
        table at the stage index where ``t`` is a block of it, else a chain
        of selects on the index's value (out-of-range indices clamp to the
        ends, as JAX's reads do)."""
        n = t.shape[0]
        ops = self.b.ops
        tab = [ops[i] for i in t.flat]
        if tab and all(o[0] == "tab" for o in tab):
            off = np.array([o[1] for o in tab]).reshape(t.shape)
            stride = off[1] - off[0] if n > 1 else np.zeros(t.shape[1:], int)
            if n == 1 or (np.all(stride == stride.flat[0]) and np.array_equal(
                    off, off[0] + np.arange(n).reshape((n,) + (1,) * (
                        t.ndim - 1)) * stride.flat[0])):
                s = int(stride.flat[0]) if n > 1 else 0
                return _ids(np.frompyfunc(
                    lambda base: self.b.leaf(("tabi", int(base), s, n, idx)),
                    1, 1)(off[0]))
        out = _ids(t[n - 1])
        for j in range(n - 2, -1, -1):
            c = self.cmp("le", _ids(idx), j)
            out = self.select(c, _ids(t[j]), out)
        return out

    # ---- a graph --------------------------------------------------------
    def run(self, gm, inputs):
        env = {}
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = inputs[len(env)]
            elif node.op == "get_attr":
                env[node] = self.hoist(getattr(gm, node.target))
            elif node.op == "call_function":
                args = torch.fx.node.map_arg(node.args, lambda n: env[n])
                kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
                if node.target is operator.getitem:
                    env[node] = args[0][args[1]]
                    continue
                fn = LOWERINGS.get(node.target)
                if fn is None:
                    raise NotImplementedError(
                        f"{self.name}: the ATen op {node.target} has no "
                        "lowering to the device model (ops/cuda/trace.py "
                        "LOWERINGS)")
                out = fn(self, *args, **kwargs)
                val = node.meta.get("val")
                if isinstance(val, torch.Tensor):
                    out = _ids(out)
                if isinstance(out, np.ndarray) and isinstance(val, torch.Tensor):
                    if out.shape != tuple(val.shape):
                        raise RuntimeError(
                            f"{self.name}: {node.target} lowered to shape "
                            f"{out.shape}, traced {tuple(val.shape)}")
                    kind = _kind_of_dtype(val.dtype)
                    if out.size and self.kind(out) != kind and kind == F:
                        out = self.to(out, F)
                env[node] = out
                if node.target in _INPLACE:   # the op's first operand changed
                    env[node.args[0]] = out
            elif node.op == "output":
                return torch.fx.node.map_arg(node.args[0], lambda n: env[n])
            else:
                raise NotImplementedError(f"{self.name}: fx node {node.op}")


def _shape_arg(s):
    return [int(v) for v in s]


def _dim_list(dims):
    return dims if isinstance(dims, (list, tuple)) else [dims]


def _factory(L, shape, value, dtype=None, like=None):
    kind = (_kind_of_dtype(dtype) if dtype is not None else
            L.kind(like) if like is not None and like.size else
            B if isinstance(value, bool) else F)
    v = L.b.lit(value, kind)
    return np.full(tuple(shape), v, dtype=object)


def _slice(L, a, dim=0, start=None, end=None, step=1):
    idx = [slice(None)] * a.ndim
    n = a.shape[dim]
    start = 0 if start is None else start
    end = n if end is None else min(end, n)
    idx[dim] = slice(start, end, step)
    return a[tuple(idx)]


def _slice_scatter(L, base, src, dim=0, start=None, end=None, step=1):
    out = base.copy()
    idx = [slice(None)] * base.ndim
    n = base.shape[dim]
    idx[dim] = slice(0 if start is None else start,
                     n if end is None else min(end, n), step)
    out[tuple(idx)] = src
    return out


def _select_scatter(L, base, src, dim, index):
    out = base.copy()
    idx = [slice(None)] * base.ndim
    idx[dim] = index
    out[tuple(idx)] = src if src.ndim else src.item()   # an id, not an array
    return out


def _index(L, t, indices):
    if len(indices) != 1 or indices[0] is None:
        raise NotImplementedError(f"{L.name}: aten.index with {len(indices)} "
                                  "index tensors (one on the first axis is "
                                  "lowered)")
    idx = L.arr(indices[0])
    if L.kind(idx) != I:
        raise NotImplementedError(f"{L.name}: aten.index by a non-integer "
                                  "index")
    vals = [L.b.literal_value(i) for i in idx.flat]
    if all(v is not None for v in vals):
        return _ids(np.take(t, np.array(vals, dtype=int).reshape(idx.shape),
                            axis=0))
    if idx.ndim != 0:
        raise NotImplementedError(f"{L.name}: aten.index by a computed index "
                                  f"tensor of shape {idx.shape}")
    return L.gather(t, idx.item())


def _squeeze(L, a, dim=None):
    if dim is None:
        return a.reshape([s for s in a.shape if s != 1])
    dims = {d % a.ndim for d in _dim_list(dim)}
    return a.reshape([s for d, s in enumerate(a.shape)
                      if not (d in dims and s == 1)])


def _expand(L, a, size, implicit=False):
    size = list(size)
    lead = len(size) - a.ndim
    shape = [a.shape[i - lead] if s == -1 else s for i, s in enumerate(size)]
    return np.broadcast_to(a, shape).copy()


def _to_copy(L, a, dtype=None, **_):
    """A copy, or a cast: every float type is the kernels' float, and an int
    or bool becomes a float; a float becomes no int or bool."""
    a = L.arr(a)
    if dtype is None:
        return a
    kind = _kind_of_dtype(dtype)
    if kind != F and L.kind(a) != kind:
        _raise(L, f"a cast to {dtype}")
    return L.to(a, kind)


def _raise(L, what):
    raise NotImplementedError(f"{L.name}: {what} has no lowering")


class _Unlowered:
    """The indices of ``max.dim`` / ``min.dim``: an index computed from
    values, which no lowering reads (``_Lowering.arr`` refuses it)."""

    def __init__(self, op):
        self.op = op

    def __repr__(self):
        return f"<the indices of {self.op}, computed from values>"


def _where(L, c, a, b):
    return L.select(c, a, b)


def _isfinite(L, a):
    a = L.to(L.arr(a), F)
    return L.map("and", L.map("eq", a, a),
                 L.cmp("ne", L.map("abs", a), math.inf))


def _identity(L, a, *_, **__):
    return L.arr(a)


def _sum(L, a, dim=None, keepdim=False, dtype=None):
    return L.fsum(a, dim, keepdim)


def _mean(L, a, dim=None, keepdim=False, dtype=None):
    a = L.arr(a)
    s = L.fsum(a, dim, keepdim)
    n = a.size // max(s.size, 1)
    return L.arith("div", s, float(n))


LOWERINGS = {
    # arithmetic
    aten.add.Tensor: lambda L, a, b, alpha=1: L.arith(
        "add", a, b if alpha == 1 else L.arith("mul", b, alpha)),
    aten.add.Scalar: lambda L, a, b, alpha=1: L.arith("add", a, b * alpha),
    aten.sub.Tensor: lambda L, a, b, alpha=1: L.arith(
        "sub", a, b if alpha == 1 else L.arith("mul", b, alpha)),
    aten.sub.Scalar: lambda L, a, b, alpha=1: L.arith("sub", a, b * alpha),
    aten.rsub.Scalar: lambda L, a, b, alpha=1: L.arith(
        "sub", b, a if alpha == 1 else L.arith("mul", a, alpha)),
    aten.rsub.Tensor: lambda L, a, b, alpha=1: L.arith(
        "sub", b, a if alpha == 1 else L.arith("mul", a, alpha)),
    aten.mul.Tensor: lambda L, a, b: L.arith("mul", a, b),
    aten.mul.Scalar: lambda L, a, b: L.arith("mul", a, b),
    aten.div.Tensor: lambda L, a, b: L.arith("div", a, b),
    aten.div.Scalar: lambda L, a, b: L.arith("div", a, b),
    aten.neg.default: lambda L, a: L.unary("neg", a),
    aten.reciprocal.default: lambda L, a: L.unary("recip", a),
    aten.sin.default: lambda L, a: L.unary("sin", a),
    aten.cos.default: lambda L, a: L.unary("cos", a),
    aten.tan.default: lambda L, a: L.unary("tan", a),
    aten.exp.default: lambda L, a: L.unary("exp", a),
    aten.log.default: lambda L, a: L.unary("log", a),
    aten.sqrt.default: lambda L, a: L.unary("sqrt", a),
    aten.rsqrt.default: lambda L, a: L.unary("recip", L.unary("sqrt", a)),
    aten.abs.default: lambda L, a: L.unary("abs", a),
    aten.tanh.default: lambda L, a: L.unary("tanh", a),
    aten.sigmoid.default: lambda L, a: L.unary("sigmoid", a),
    aten.log1p.default: lambda L, a: L.unary("log1p", a),
    aten.exp2.default: lambda L, a: L.unary("exp2", a),
    aten.erfinv.default: lambda L, a: L.unary("erfinv", a),
    aten.floor.default: lambda L, a: L.rounding("floor", a),
    aten.ceil.default: lambda L, a: L.rounding("ceil", a),
    aten.round.default: lambda L, a: L.rounding("round", a),
    aten.sign.default: lambda L, a: L.rounding("sign", a),
    aten.pow.Tensor_Scalar: lambda L, a, e: L.power(a, e),
    aten.pow.Tensor_Tensor: lambda L, a, b: L.binary("pow", a, b),
    aten.pow.Scalar: lambda L, a, b: L.binary("pow", a, b),
    aten.fmod.Tensor: lambda L, a, b: L.binary("fmod", a, b),
    aten.fmod.Scalar: lambda L, a, b: L.binary("fmod", a, b),
    aten.remainder.Tensor: lambda L, a, b: L.binary("rem", a, b),
    aten.remainder.Scalar: lambda L, a, b: L.binary("rem", a, b),
    aten.remainder.Scalar_Tensor: lambda L, a, b: L.binary("rem", a, b),
    aten.square.default: lambda L, a: L.power(a, 2),
    aten.maximum.default: lambda L, a, b: L.map("max", *L.promote(a, b)[0]),
    aten.minimum.default: lambda L, a, b: L.map("min", *L.promote(a, b)[0]),
    aten.clamp.default: lambda L, a, min=None, max=None: L.clamp(a, min, max),
    aten.clamp.Tensor: lambda L, a, min=None, max=None: L.clamp(a, min, max),
    aten.clamp_min.default: lambda L, a, m: L.clamp(a, m, None),
    aten.clamp_max.default: lambda L, a, m: L.clamp(a, None, m),
    aten.relu.default: lambda L, a: L.select(L.cmp("le", a, 0.0), 0.0, a),
    # comparisons and logic
    **{getattr(aten, n).Tensor: (lambda n: lambda L, a, b: L.cmp(n, a, b))(n)
       for n in COMPARE},
    **{getattr(aten, n).Scalar: (lambda n: lambda L, a, b: L.cmp(n, a, b))(n)
       for n in COMPARE},
    aten.isfinite.default: _isfinite,
    aten.isnan.default: lambda L, a: L.cmp("ne", a, a),
    aten.logical_and.default: lambda L, a, b: L.map(
        "and", L.to(L.arr(a), B), L.to(L.arr(b), B)),
    aten.logical_or.default: lambda L, a, b: L.map(
        "or", L.to(L.arr(a), B), L.to(L.arr(b), B)),
    aten.logical_not.default: lambda L, a: L.map("not", L.to(L.arr(a), B)),
    aten.bitwise_and.Tensor: lambda L, a, b: L.map(
        "and", L.to(L.arr(a), B), L.to(L.arr(b), B)),
    aten.bitwise_or.Tensor: lambda L, a, b: L.map(
        "or", L.to(L.arr(a), B), L.to(L.arr(b), B)),
    aten.bitwise_not.default: lambda L, a: L.map("not", L.to(L.arr(a), B)),
    aten.where.self: _where,
    aten.where.ScalarOther: _where,
    aten.where.ScalarSelf: _where,
    aten.where.Scalar: _where,
    aten.masked_fill.Scalar: lambda L, a, mask, v: L.select(mask, v, a),
    aten.masked_fill.Tensor: lambda L, a, mask, v: L.select(mask, v, a),
    # reductions and products
    aten.sum.default: _sum,
    aten.sum.dim_IntList: _sum,
    aten.mean.default: _mean,
    aten.mean.dim: _mean,
    aten.amax.default: lambda L, a, dim=(), keepdim=False: L.extremum(
        "max", a, list(dim), keepdim),
    aten.amin.default: lambda L, a, dim=(), keepdim=False: L.extremum(
        "min", a, list(dim), keepdim),
    aten.max.default: lambda L, a: L.extremum("max", a),
    aten.min.default: lambda L, a: L.extremum("min", a),
    aten.max.dim: lambda L, a, dim, keepdim=False: (
        L.extremum("max", a, dim, keepdim), _Unlowered("aten.max.dim")),
    aten.min.dim: lambda L, a, dim, keepdim=False: (
        L.extremum("min", a, dim, keepdim), _Unlowered("aten.min.dim")),
    aten.mm.default: lambda L, a, b: L.matmul(a, b),
    aten.mv.default: lambda L, a, b: L.matmul(a, b),
    aten.dot.default: lambda L, a, b: L.matmul(a, b),
    aten.matmul.default: lambda L, a, b: L.matmul(a, b),
    aten.linalg_vector_norm.default: lambda L, a, ord=2, dim=None,
    keepdim=False, dtype=None: L.unary("sqrt", L.fsum(
        L.arith("mul", a, a), dim, keepdim)) if ord == 2 else _raise(
        L, f"a vector norm of order {ord}"),
    # shapes and copies
    aten.select.int: lambda L, a, dim, i: _ids(np.take(a, i, axis=dim)),
    aten.slice.Tensor: _slice,
    aten.unsqueeze.default: lambda L, a, d: np.expand_dims(
        a, d % (a.ndim + 1)),
    aten.squeeze.dim: _squeeze,
    aten.squeeze_.dim: _squeeze,
    aten.squeeze.dims: _squeeze,
    aten.squeeze.default: _squeeze,
    aten.view.default: lambda L, a, s: a.reshape(_shape_arg(s)),
    aten._unsafe_view.default: lambda L, a, s: a.reshape(_shape_arg(s)),
    aten.reshape.default: lambda L, a, s: a.reshape(_shape_arg(s)),
    aten.expand.default: _expand,
    aten.t.default: lambda L, a: a.T,
    aten.transpose.int: lambda L, a, d0, d1: np.swapaxes(a, d0, d1),
    aten.permute.default: lambda L, a, dims: np.transpose(a, dims),
    aten.flip.default: lambda L, a, dims: np.flip(a, dims).copy(),
    aten.stack.default: lambda L, ts, dim=0: np.stack(
        L.promote(*ts)[0], axis=dim),
    aten.cat.default: lambda L, ts, dim=0: np.concatenate(
        [t for t in L.promote(*ts)[0] if t.size or t.ndim > 1], axis=dim),
    aten.clone.default: _identity,
    aten.alias.default: _identity,
    aten.detach.default: _identity,
    aten.lift_fresh_copy.default: _identity,
    aten.contiguous.default: _identity,
    aten._to_copy.default: _to_copy,
    aten.copy.default: lambda L, dst, src, non_blocking=False: L.to(
        np.broadcast_to(L.arr(src), dst.shape).copy(), L.kind(dst)
        if dst.size else F),
    aten.select_scatter.default: _select_scatter,
    aten.select_backward.default: lambda L, g, sizes, dim, index:
    _select_scatter(L, _factory(L, sizes, 0.0), g, dim, index),
    aten.slice_backward.default: lambda L, g, sizes, dim, start, end, step:
    _slice_scatter(L, _factory(L, sizes, 0.0), g, dim, start, end, step),
    aten.slice_scatter.default: _slice_scatter,
    aten.index.Tensor: _index,
    # factories
    aten.zeros_like.default: lambda L, a, dtype=None, **_: _factory(
        L, a.shape, 0, dtype, a),
    aten.ones_like.default: lambda L, a, dtype=None, **_: _factory(
        L, a.shape, 1, dtype, a),
    aten.full_like.default: lambda L, a, v, dtype=None, **_: _factory(
        L, a.shape, v, dtype, a),
    aten.scalar_tensor.default: lambda L, v, dtype=None, **_: _factory(
        L, (), v, dtype),
    aten.full.default: lambda L, size, v, dtype=None, **_: _factory(
        L, size, v, dtype),
    aten.zeros.default: lambda L, size, dtype=None, **_: _factory(
        L, size, 0, dtype or torch.float32),
    aten.ones.default: lambda L, size, dtype=None, **_: _factory(
        L, size, 1, dtype or torch.float32),
    aten.new_zeros.default: lambda L, a, size, dtype=None, **_: _factory(
        L, size, 0, dtype, a),
    aten.new_ones.default: lambda L, a, size, dtype=None, **_: _factory(
        L, size, 1, dtype, a),
    aten.new_full.default: lambda L, a, size, v, dtype=None, **_: _factory(
        L, size, v, dtype, a),
}
_INPLACE = {aten.squeeze_.dim}


def _hypot(a, b):
    return torch.sqrt(a * a + b * b)


# Composites decomposed in the trace into ops of LOWERINGS (torch._decomp's
# rules, and hypot as sqrt(a^2 + b^2)); no op here has a lowering of its own,
# so no program that lowered before changes its text.
_DECOMPOSITIONS = {
    **get_decompositions([
        aten.softplus, aten.softplus_backward, aten.logaddexp, aten.silu,
        aten.huber_loss, aten.smooth_l1_loss, aten.mse_loss, aten.logsumexp,
        aten.tanh_backward, aten.sigmoid_backward]),
    aten.hypot.default: _hypot,
}


@dataclasses.dataclass(frozen=True, eq=False)
class Program:
    """One OCP's four callables as scalar SSA over one hoisted table.

    ``ops[i]`` is value i's instruction and ``kinds[i]`` its kind (``"f"``,
    ``"b"``, ``"i"``); ``outputs`` maps ``"step"`` (nx values),
    ``"stage_cost"`` (1), ``"terminal_cost"`` (1, or absent) and ``"lb"`` /
    ``"ub"`` (nu each, or absent) to value numbers.  ``consts`` are the
    hoisted float tensors themselves, in table order, which the program
    reads by offset (``table`` gives their current values); ``literals`` are
    the integer and bool tensors whose values the program holds as literals,
    each with its version counter at the trace.  Inputs are ``x``, ``u``,
    ``p`` (``npar`` columns traced) and the stage index ``k``."""

    nx: int
    nu: int
    npar: int
    ops: tuple
    kinds: tuple
    outputs: dict
    consts: tuple
    literals: tuple = ()

    @property
    def n_table(self) -> int:
        """The number of table entries."""
        return sum(c.numel() for c in self.consts)

    def versions(self):
        """The version counters of the hoisted tensors and of those compiled
        in as literals, or None where one cannot be read (a tensor made
        under ``torch.inference_mode`` has none): the table is then read
        anew at every use."""
        held = self.consts + tuple(t for t, _ in self.literals)
        if any(c.is_inference() for c in held):
            return None
        return tuple(c._version for c in held)

    def table(self, dtype=torch.float64, device="cpu") -> torch.Tensor:
        """The hoisted tensors' current values, flat, in table order; raises
        if an integer or bool tensor compiled in as literals has changed in
        place since the trace."""
        for t, version in self.literals:
            if version is not None and t._version != version:
                raise RuntimeError(
                    "an integer or bool tensor that the OCP's callables "
                    "close over changed in place after the trace; its values "
                    "are compiled into the traced model: build a new OCP")
        if not self.consts:
            return torch.zeros(0, dtype=dtype, device=device)
        return torch.cat([c.detach().reshape(-1).to(device=device,
                                                     dtype=dtype)
                          for c in self.consts])

    @property
    def min_npar(self) -> int:
        """The fewest parameter columns the program reads (0 for none): the
        columns its outputs depend on, not every column traced."""
        roots = [v for vs in self.outputs.values() for v in vs]
        return 1 + max((self.ops[v][2] for v in self.reachable(roots)
                        if self.ops[v][:2] == ("in", "p")), default=-1)

    def reachable(self, roots) -> list:
        """The value numbers ``roots`` depend on, in program order."""
        seen, todo = set(), list(roots)
        while todo:
            v = todo.pop()
            if v in seen:
                continue
            seen.add(v)
            todo.extend(_operands(self.ops[v]))
        return sorted(seen)

    def evaluate(self, roots, *, like, x=None, u=None, p=None, k=None):
        """The values ``roots`` at the inputs given, in plain PyTorch:
        ``x`` (..., nx), ``u`` (..., nu), ``p`` (..., npar) with common
        leading dims, ``k`` an int or an integer tensor of those dims;
        ``like`` gives the float dtype and device.  Returns a list of tensors
        of the leading dims."""
        dt, dev = like.dtype, like.device
        table = self.table(dt, dev)
        ins = {"x": x, "u": u, "p": p}
        env = {}
        for v in self.reachable(roots):
            env[v] = _eval_op(self.ops[v], env, ins, k, table, dt, dev)
        lead = like.shape[:-1]
        out = []
        for r in roots:
            t = env[r]
            if not isinstance(t, torch.Tensor):
                t = torch.tensor(t, dtype=dt, device=dev)
            out.append(t.to(dt).expand(lead) if t.dim() == 0 else t.to(dt))
        return out


def _operands(ins):
    name = ins[0]
    if name in LITERALS or name in ("in", "k", "tab"):
        return ()
    if name == "tabi":
        return (ins[4],)
    return ins[1:]


def _eval_op(ins, env, ins_t, k, table, dt, dev):
    name = ins[0]
    a = [env[i] for i in _operands(ins)]
    if name == "cf":
        return torch.tensor(ins[1], dtype=dt, device=dev)
    if name in ("ci", "cb"):
        return ins[1]
    if name == "in":
        return ins_t[ins[1]][..., ins[2]]
    if name == "k":
        return k
    if name == "tab":
        return table[ins[1]]
    if name == "tabi":
        _, base, stride, dim, _ = ins
        i = a[0]
        if isinstance(i, int):
            return table[base + stride * min(max(i, 0), dim - 1)]
        return aten.index.Tensor(table, [base + stride * i.clamp(0, dim - 1)])
    if name in ("add", "addi"):
        return a[0] + a[1]
    if name in ("sub", "subi"):
        return a[0] - a[1]
    if name in ("mul", "muli"):
        return a[0] * a[1]
    if name == "div":
        return a[0] / a[1]
    if name == "neg":
        return -a[0]
    if name == "recip":
        return 1.0 / a[0]
    if name in ("sin", "cos", "tan", "exp", "log", "sqrt", "abs", "tanh",
                "sigmoid", "log1p", "exp2", "erfinv", "floor", "ceil",
                "round", "sign"):
        return getattr(torch, name)(a[0])
    if name == "pow":
        return torch.pow(a[0], a[1])
    if name == "fmod":
        return torch.fmod(a[0], a[1])
    if name == "rem":
        return torch.remainder(a[0], a[1])
    if name == "max":
        return torch.maximum(a[0], a[1])
    if name == "min":
        return torch.minimum(a[0], a[1])
    if name in COMPARE:
        return getattr(operator, name)(a[0], a[1])
    if name == "and":
        return a[0] & a[1] if isinstance(a[0], torch.Tensor) else (
            a[1] & a[0] if isinstance(a[1], torch.Tensor) else a[0] and a[1])
    if name == "or":
        return a[0] | a[1] if isinstance(a[0], torch.Tensor) else (
            a[1] | a[0] if isinstance(a[1], torch.Tensor) else a[0] or a[1])
    if name == "not":
        return ~a[0] if isinstance(a[0], torch.Tensor) else not a[0]
    if name == "i2f":
        return (a[0].to(dt) if isinstance(a[0], torch.Tensor)
                else torch.tensor(float(a[0]), dtype=dt, device=dev))
    if name == "b2f":
        return torch.where(torch.as_tensor(a[0], device=dev),
                           torch.ones((), dtype=dt, device=dev),
                           torch.zeros((), dtype=dt, device=dev))
    if name == "sel":
        if not isinstance(a[1], torch.Tensor):   # ints or bools
            return torch.where(torch.as_tensor(a[0], device=dev),
                               torch.as_tensor(a[1], device=dev),
                               torch.as_tensor(a[2], device=dev))
        return torch.where(torch.as_tensor(a[0], device=dev), a[1], a[2])
    raise ValueError(f"unknown instruction {name!r}")


class Tracer:
    """Trace callables onto one program: shared inputs, one table, one CSE.

    ``dtype`` is the float inputs' dtype; ``sizes`` maps an input's name to
    its length (``x``, ``u``, ``p``; the stage index ``k`` is a scalar and
    has none)."""

    def __init__(self, dtype, **sizes):
        self.dtype, self.sizes = dtype, sizes
        self.b = _SSA()
        self.consts, self.literals, self.offsets, self.n_table = [], [], {}, 0

    def _hoist(self, t: torch.Tensor):
        """A constant tensor as an id array: a float tensor joins the table
        (once per tensor, wherever it is read), an integer or bool tensor's
        values become literals.  Every hoisted tensor is held, by the Tracer
        and then by its program, so that no other tensor can take its
        address while a key names it."""
        if not t.is_floating_point():
            self.literals.append(
                (t, None if t.is_inference() else t._version))
            kind = _kind_of_dtype(t.dtype)
            vals = t.detach().cpu().numpy()
            return _ids(np.frompyfunc(lambda v: self.b.lit(v, kind), 1, 1)(
                vals)).reshape(vals.shape)
        key = (t.untyped_storage().data_ptr(), t.storage_offset(),
               tuple(t.shape), tuple(t.stride()), t.dtype, t.device)
        if key not in self.offsets:
            self.offsets[key] = self.n_table
            self.consts.append(t)
            self.n_table += t.numel()
        off = self.offsets[key]
        ids = [self.b.leaf(("tab", off + i)) for i in range(t.numel())]
        return _ids(ids).reshape(tuple(t.shape))

    def inputs(self, name):
        if name == "k":
            return _ids(self.b.leaf(("k",), I))
        return _ids([self.b.leaf(("in", name, j))
                     for j in range(self.sizes[name])])

    def trace(self, fn: Callable, names, callable_name: str):
        """Trace ``fn`` on the inputs ``names`` and lower it; returns its
        output structure with id arrays in place of tensors."""
        example = [torch.zeros((), dtype=torch.int64) if n == "k" else
                   torch.zeros((self.sizes[n],), dtype=self.dtype)
                   for n in names]
        try:
            with _OnHost(), _KIndex(), _NoMoves():
                gm = make_fx(torch.func.functionalize(fn, remove="mutations"),
                             decomposition_table=_DECOMPOSITIONS)(*example)
        except RuntimeError as exc:
            if "_local_scalar_dense" in str(exc) or "data-dependent" in str(exc):
                raise NotImplementedError(
                    f"{callable_name} reads a value of its inputs in Python "
                    "(a branch on it, or int() of it), which a trace cannot "
                    f"follow: {exc}") from exc
            raise
        return _Lowering(self.b, self._hoist, callable_name).run(
            gm, [self.inputs(n) for n in names])

    def program(self, outputs, nx, nu, npar) -> Program:
        return Program(nx, nu, npar, tuple(self.b.ops), tuple(self.b.kinds),
                       outputs, tuple(self.consts), tuple(self.literals))


def _flat_float(b, name, out, n):
    """An output, of the instructions ``b``, as n float value numbers."""
    a = np.asarray(out, dtype=object)
    if a.size != n:
        raise ValueError(f"{name} returns {a.size} values, expected {n}")
    ids = []
    for v in a.ravel():
        if b.kinds[v] != F:
            v = b.op("i2f" if b.kinds[v] == I else "b2f", v)
        ids.append(v)
    return tuple(ids)


def trace_ocp(ocp) -> Program:
    """The program of ``ocp``'s dynamics, stage cost, terminal cost (if any)
    and control box (if any), traced in the OCP's dtype; nothing is
    allocated on the OCP's device (``_OnHost``)."""
    npar = max(ocp.npar, 1)
    tr = Tracer(ocp.dtype, x=ocp.nx, u=ocp.nu, p=npar)
    outputs = {
        "step": _flat_float(tr.b, "dynamics", tr.trace(
            ocp.dynamics, "xup", "dynamics"), ocp.nx),
        "stage_cost": _flat_float(tr.b, "stage_cost", tr.trace(
            ocp.stage_cost, "xup", "stage_cost"), 1),
    }
    if ocp.terminal_cost is not None:
        outputs["terminal_cost"] = _flat_float(tr.b, "terminal_cost", tr.trace(
            ocp.terminal_cost, "xp", "terminal_cost"), 1)
    if ocp.control_bounds is not None:
        lb, ub = tr.trace(ocp.control_bounds, "xpk", "control_bounds")
        outputs["lb"] = _flat_float(tr.b, "control_bounds", lb, ocp.nu)
        outputs["ub"] = _flat_float(tr.b, "control_bounds", ub, ocp.nu)
    return tr.program(outputs, ocp.nx, ocp.nu, npar)
