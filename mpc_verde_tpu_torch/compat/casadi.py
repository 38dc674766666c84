"""CasADi-compatible symbolic layer (port of ``mpc_verde_tpu.compat.casadi``).

The CasADi surface the reference's hand-rolled scripts use: ``SX.sym``,
``vertcat`` / ``horzcat`` / ``reshape`` / ``repmat`` / ``diagcat``,
``Function``, ``nlpsol('solver', 'ipopt', ...)`` called with x0 / lbx /
ubx / lbg / ubg / p, ``DM`` numerics with ``.full()``, ``norm_2`` and
``inf``, so that those scripts port with an import swap.

  * ``SX`` is a matrix of scalar expression nodes stored as a numpy object
    array: slicing, assignment (``X[:, k+1] = st_next``), vertcat, horzcat
    and reshape are array shuffles that keep node identity.
  * Column-major semantics throughout (CasADi stores matrices column-major):
    ``reshape`` and ``DM`` indexing follow ``order='F'``, including the
    reference's ``reshape(u0.T, 2N, 1)`` warm-start layout.
  * ``Function`` evaluates the node graph numerically (DM in and out) or
    symbolically (SX in and out: graph substitution).
  * ``nlpsol`` extracts the decision and parameter leaves from
    ``prob['x']`` / ``prob['p']``, evaluates f and g from the node graph as
    torch functions of the packed vectors, and solves with the augmented-
    Lagrangian projected-Newton NLP solver (``solver/nlp.py``), the stand-in
    for IPOPT.  The JAX package compiles that graph once (``jax.jit``); here
    it is evaluated eagerly, node by node, at every call of f and g.

The numpy layer (``SXNode``, ``SX``, ``DM``, ``Function``, ``_eval_nodes``)
is the JAX package's, kept here as the port's own copy; only the tensor
backend of ``_apply_op`` and ``nlpsol`` differ.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

inf = float("inf")
pi = math.pi

# ---------------------------------------------------------------------------
# scalar expression nodes
# ---------------------------------------------------------------------------

_UNARY_OPS = ("sin", "cos", "tan", "exp", "log", "sqrt", "fabs", "atan")


class SXNode:
    """One scalar expression: a leaf symbol, a constant, or an operation."""

    __slots__ = ("op", "args")

    def __init__(self, op, args):
        self.op = op
        self.args = args

    # -- construction helpers ------------------------------------------------
    @staticmethod
    def const(v) -> "SXNode":
        return SXNode("const", (float(v),))

    @staticmethod
    def _coerce(v):
        if isinstance(v, SXNode):
            return v
        if isinstance(v, (int, float, np.integer, np.floating)):
            return SXNode.const(v)
        if isinstance(v, DM) and v.numel() == 1:
            return SXNode.const(float(v))
        return NotImplemented

    def _bin(self, op, other, swap=False):
        o = SXNode._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        a, b = (o, self) if swap else (self, o)
        return SXNode(op, (a, b))

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, swap=True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, swap=True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, swap=True)
    def __truediv__(self, o): return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, swap=True)
    def __pow__(self, o): return self._bin("pow", o)
    def __rpow__(self, o): return self._bin("pow", o, swap=True)
    def __neg__(self): return SXNode("neg", (self,))

    def __repr__(self):
        if self.op == "leaf":
            return self.args[0]
        if self.op == "const":
            return repr(self.args[0])
        return f"{self.op}({', '.join(map(repr, self.args))})"


def _leaf(name: str) -> SXNode:
    return SXNode("leaf", (name,))


def _apply_op(op, vals, backend):
    """Apply one node op to evaluated child values.

    ``backend`` is the ``math`` module (the pure-Python numeric path) or
    ``torch`` (tensors: ``nlpsol``'s functions of the packed vectors).
    Children may themselves be SXNodes when substituting symbolically:
    Python operators then rebuild nodes.  A torch op whose children are all
    constants (Python numbers) runs on the ``math`` path.
    """
    symbolic = any(isinstance(v, SXNode) for v in vals)
    if op == "neg":
        return -vals[0]
    if op == "add":
        return vals[0] + vals[1]
    if op == "sub":
        return vals[0] - vals[1]
    if op == "mul":
        return vals[0] * vals[1]
    if op == "div":
        return vals[0] / vals[1]
    if op == "pow":
        return vals[0] ** vals[1]
    if symbolic:
        return SXNode(op, tuple(SXNode._coerce(v) for v in vals))
    like = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    if backend is math or like is None:
        fn = {"sin": math.sin, "cos": math.cos, "tan": math.tan,
              "exp": math.exp, "log": math.log, "sqrt": math.sqrt,
              "fabs": abs, "atan": math.atan, "atan2": math.atan2,
              "fmin": min, "fmax": max}[op]
        return fn(*vals)
    vals = [v if isinstance(v, torch.Tensor)
            else torch.as_tensor(v, dtype=like.dtype, device=like.device)
            for v in vals]
    fn = {"sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
          "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
          "fabs": torch.abs, "atan": torch.atan, "atan2": torch.atan2,
          "fmin": torch.minimum, "fmax": torch.maximum}[op]
    return fn(*vals)


def _eval_nodes(roots: Sequence[SXNode], env: Dict[int, object], backend):
    """Iteratively evaluate expression nodes (no recursion limit issues).

    ``env`` maps ``id(leaf_node) -> value``.  Returns a list of values
    aligned with ``roots``.
    """
    memo: Dict[int, object] = {}
    for root in roots:
        stack = [(root, False)]
        while stack:
            node, ready = stack.pop()
            nid = id(node)
            if nid in memo:
                continue
            if node.op == "const":
                memo[nid] = node.args[0]
                continue
            if node.op == "leaf":
                try:
                    memo[nid] = env[nid]
                except KeyError:
                    raise KeyError(
                        f"free symbol '{node.args[0]}' is not an input")
                continue
            if ready:
                vals = [memo[id(a)] for a in node.args]
                memo[nid] = _apply_op(node.op, vals, backend)
            else:
                stack.append((node, True))
                for a in node.args:
                    if id(a) not in memo:
                        stack.append((a, False))
    return [memo[id(r)] for r in roots]


# ---------------------------------------------------------------------------
# DM: numeric column-major matrices
# ---------------------------------------------------------------------------

def _to_2d(a) -> np.ndarray:
    arr = np.asarray(a, dtype=np.float64)
    if arr.ndim == 0:
        arr = arr.reshape(1, 1)
    elif arr.ndim == 1:
        arr = arr.reshape(-1, 1)           # CasADi: vectors are columns
    return arr


class DM:
    """Numeric matrix with CasADi's column-major conventions."""

    def __init__(self, value=0.0):
        if isinstance(value, DM):
            self.arr = value.arr.copy()
        else:
            self.arr = _to_2d(value).copy()

    # -- constructors --------------------------------------------------------
    @staticmethod
    def zeros(*shape):
        if len(shape) == 1 and isinstance(shape[0], tuple):
            shape = shape[0]
        n = int(shape[0]); m = int(shape[1]) if len(shape) > 1 else 1
        return DM(np.zeros((n, m)))

    @staticmethod
    def ones(*shape):
        z = DM.zeros(*shape)
        z.arr[:] = 1.0
        return z

    @staticmethod
    def eye(n):
        return DM(np.eye(int(n)))

    # -- CasADi interop surface ----------------------------------------------
    def full(self) -> np.ndarray:
        """Dense numpy array — also callable unbound: ``ca.DM.full(x)``
        (``Casadi/single_shooting_v1.py:13-19``)."""
        if isinstance(self, DM):
            return self.arr.copy()
        return DM(self).arr          # DM.full(non-DM) static-style call

    @property
    def shape(self):
        return self.arr.shape

    def numel(self):
        return int(self.arr.size)

    def size1(self):
        return self.arr.shape[0]

    def size2(self):
        return self.arr.shape[1]

    @property
    def T(self):
        return DM(self.arr.T)

    def reshape(self, shape):
        n, m = shape if isinstance(shape, tuple) else (shape, 1)
        return reshape(self, n, m)

    # -- indexing (column-major flat view for 1-D keys, like CasADi) ---------
    def _flat(self):
        return self.arr.reshape(-1, order="F")

    def __getitem__(self, key):
        if isinstance(key, tuple):
            sub = self.arr[key]
            return DM(sub)
        flat = self._flat()[key]
        return DM(np.atleast_1d(flat))

    def __setitem__(self, key, value):
        v = value.arr if isinstance(value, DM) else np.asarray(value, float)
        if isinstance(key, tuple):
            self.arr[key] = v.reshape(self.arr[key].shape) if np.ndim(v) else v
            return
        flat = self.arr.reshape(-1, order="F").copy()
        flat[key] = v.reshape(-1, order="F") if np.ndim(v) > 0 else v
        self.arr = flat.reshape(self.arr.shape, order="F")

    # -- arithmetic -----------------------------------------------------------
    @staticmethod
    def _val(o):
        if isinstance(o, DM):
            return o.arr
        if isinstance(o, (int, float, np.integer, np.floating)):
            return float(o)
        if isinstance(o, np.ndarray):
            return _to_2d(o)
        return NotImplemented

    def _bin(self, other, fn, swap=False):
        v = DM._val(other)
        if v is NotImplemented:
            return NotImplemented
        a, b = (v, self.arr) if swap else (self.arr, v)
        return DM(fn(a, b))

    def __add__(self, o): return self._bin(o, np.add)
    def __radd__(self, o): return self._bin(o, np.add, swap=True)
    def __sub__(self, o): return self._bin(o, np.subtract)
    def __rsub__(self, o): return self._bin(o, np.subtract, swap=True)
    def __mul__(self, o): return self._bin(o, np.multiply)
    def __rmul__(self, o): return self._bin(o, np.multiply, swap=True)
    def __truediv__(self, o): return self._bin(o, np.divide)
    def __rtruediv__(self, o): return self._bin(o, np.divide, swap=True)
    def __pow__(self, o): return self._bin(o, np.power)
    def __neg__(self): return DM(-self.arr)

    def __matmul__(self, o):
        v = DM._val(o)
        return DM(self.arr @ v)

    def __rmatmul__(self, o):
        v = DM._val(o)
        return DM(v @ self.arr)

    # -- scalar conversions / comparisons -------------------------------------
    def __float__(self):
        return float(self.arr.reshape(-1)[0])

    def __int__(self):
        return int(float(self))

    def __lt__(self, o): return float(self) < float(o)
    def __le__(self, o): return float(self) <= float(o)
    def __gt__(self, o): return float(self) > float(o)
    def __ge__(self, o): return float(self) >= float(o)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.arr, dtype=dtype)

    def __len__(self):
        return self.arr.shape[0]

    def __repr__(self):
        return f"DM({self.arr!r})"


# ---------------------------------------------------------------------------
# SX: symbolic column-major matrices of nodes
# ---------------------------------------------------------------------------

_sym_counter = [0]


def _obj_array(nodes) -> np.ndarray:
    a = np.empty(np.shape(nodes), dtype=object) if not isinstance(
        nodes, np.ndarray) else None
    if a is not None:
        a[...] = nodes
        nodes = a
    if nodes.ndim == 0:
        nodes = nodes.reshape(1, 1)
    elif nodes.ndim == 1:
        nodes = nodes.reshape(-1, 1)
    return nodes


def _const_grid(arr: np.ndarray) -> np.ndarray:
    out = np.empty(arr.shape, dtype=object)
    it = np.nditer(arr, flags=["multi_index"])
    for v in it:
        out[it.multi_index] = SXNode.const(float(v))
    return out


class SX:
    """Symbolic matrix (column-major like CasADi); entries are SXNodes."""

    def __init__(self, value=None):
        if value is None:
            self.data = np.empty((0, 1), dtype=object)
        elif isinstance(value, SX):
            self.data = value.data.copy()
        elif isinstance(value, SXNode):
            d = np.empty((1, 1), dtype=object)
            d[0, 0] = value
            self.data = d
        elif isinstance(value, DM):
            self.data = _const_grid(value.arr)
        elif isinstance(value, np.ndarray) and value.dtype == object:
            self.data = _obj_array(value)
        else:
            self.data = _const_grid(_to_2d(value))

    @staticmethod
    def sym(name: str, n: int = 1, m: int = 1) -> "SX":
        _sym_counter[0] += 1
        uid = _sym_counter[0]
        d = np.empty((int(n), int(m)), dtype=object)
        for j in range(int(m)):
            for i in range(int(n)):
                d[i, j] = _leaf(f"{name}#{uid}[{i},{j}]")
        return SX(d)

    @staticmethod
    def zeros(n, m=1):
        return SX(np.zeros((int(n), int(m))))

    @staticmethod
    def _wrap(data: np.ndarray) -> "SX":
        s = SX.__new__(SX)
        s.data = data
        return s

    # -- shape / rearrangement -------------------------------------------------
    @property
    def shape(self):
        return self.data.shape

    def numel(self):
        return int(self.data.size)

    def size1(self):
        return self.data.shape[0]

    def size2(self):
        return self.data.shape[1]

    @property
    def T(self):
        return SX._wrap(self.data.T.copy())

    def reshape(self, shape):
        n, m = shape if isinstance(shape, tuple) else (shape, 1)
        return reshape(self, n, m)

    # -- indexing (1-D keys use the column-major flat view) --------------------
    def __getitem__(self, key):
        if isinstance(key, tuple):
            sub = self.data[key]
            return SX._wrap(_obj_array(np.asarray(sub, dtype=object))
                            if not isinstance(sub, SXNode) else
                            np.array([[sub]], dtype=object))
        flat = self.data.reshape(-1, order="F")[key]
        if isinstance(flat, SXNode):
            return SX(flat)
        return SX._wrap(_obj_array(np.asarray(flat, dtype=object)))

    def __setitem__(self, key, value):
        vdata = _coerce_sx(value).data
        if isinstance(key, tuple):
            target = self.data[key]
            self.data[key] = vdata.reshape(np.shape(target), order="F") \
                if np.ndim(target) else vdata.reshape(-1)[0]
            return
        flat = self.data.reshape(-1, order="F").copy()
        tgt = flat[key]
        flat[key] = (vdata.reshape(-1, order="F")
                     if np.ndim(tgt) else vdata.reshape(-1)[0])
        self.data = flat.reshape(self.data.shape, order="F")

    # -- arithmetic (elementwise via numpy object dispatch) --------------------
    def __add__(self, o):
        v = _coerce_sx_operand(o)
        return NotImplemented if v is NotImplemented else SX._wrap(self.data + v)

    def __radd__(self, o): return self.__add__(o)

    def __sub__(self, o):
        v = _coerce_sx_operand(o)
        return NotImplemented if v is NotImplemented else SX._wrap(self.data - v)

    def __rsub__(self, o):
        v = _coerce_sx_operand(o)
        return NotImplemented if v is NotImplemented else SX._wrap(v - self.data)

    def __mul__(self, o):
        v = _coerce_sx_operand(o)
        return NotImplemented if v is NotImplemented else SX._wrap(self.data * v)

    def __rmul__(self, o): return self.__mul__(o)

    def __truediv__(self, o):
        v = _coerce_sx_operand(o)
        return NotImplemented if v is NotImplemented else SX._wrap(self.data / v)

    def __rtruediv__(self, o):
        v = _coerce_sx_operand(o)
        return NotImplemented if v is NotImplemented else SX._wrap(v / self.data)

    def __pow__(self, o):
        v = _coerce_sx_operand(o)
        return NotImplemented if v is NotImplemented else SX._wrap(self.data ** v)

    def __neg__(self):
        return SX._wrap(np.negative(self.data))

    def __matmul__(self, o):
        v = _coerce_sx(o)
        return SX._wrap(np.asarray(self.data @ v.data, dtype=object))

    def __rmatmul__(self, o):
        v = _coerce_sx(o)
        return SX._wrap(np.asarray(v.data @ self.data, dtype=object))

    def __repr__(self):
        return f"SX(shape={self.data.shape})"


def _coerce_sx(v) -> SX:
    return v if isinstance(v, SX) else SX(v)


def _coerce_sx_operand(v):
    """Operand for elementwise numpy object-array ops: object array or scalar
    node (so numpy broadcasts it)."""
    if isinstance(v, SX):
        return v.data
    if isinstance(v, SXNode):
        return v
    if isinstance(v, (int, float, np.integer, np.floating)):
        return SXNode.const(v)
    if isinstance(v, (DM, np.ndarray, list)):
        return SX(v if not isinstance(v, list) else np.asarray(v, float)).data
    return NotImplemented


# ---------------------------------------------------------------------------
# free functions: vertcat / horzcat / reshape / repmat / diagcat / norm_2 ...
# ---------------------------------------------------------------------------

def _is_symbolic(*args) -> bool:
    return any(isinstance(a, (SX, SXNode)) for a in args)


def vertcat(*args):
    if len(args) == 0:
        return DM(np.zeros((0, 1)))
    if _is_symbolic(*args):
        mats = [_coerce_sx(a).data for a in args]
        return SX._wrap(np.concatenate(mats, axis=0))
    mats = [DM(a).arr if not isinstance(a, DM) else a.arr for a in args]
    return DM(np.concatenate(mats, axis=0))


def horzcat(*args):
    if len(args) == 0:
        return DM(np.zeros((1, 0)))
    if _is_symbolic(*args):
        mats = [_coerce_sx(a).data for a in args]
        return SX._wrap(np.concatenate(mats, axis=1))
    mats = [DM(a).arr if not isinstance(a, DM) else a.arr for a in args]
    return DM(np.concatenate(mats, axis=1))


def reshape(x, n, m=None):
    """CasADi reshape: column-major reinterpretation; -1 infers a dim."""
    if m is None and isinstance(n, tuple):
        n, m = n
    n, m = int(n), int(m)
    if isinstance(x, (SX, SXNode)):
        sx = _coerce_sx(x)
        total = sx.numel()
        if n == -1:
            n = total // m
        if m == -1:
            m = total // n
        flat = sx.data.reshape(-1, order="F")
        return SX._wrap(flat.reshape((n, m), order="F"))
    dm = x if isinstance(x, DM) else DM(x)
    total = dm.numel()
    if n == -1:
        n = total // m
    if m == -1:
        m = total // n
    return DM(dm.arr.reshape((n, m), order="F"))


def repmat(x, n, m=1):
    if isinstance(x, (SX, SXNode)):
        return SX._wrap(np.tile(_coerce_sx(x).data, (int(n), int(m))))
    dm = x if isinstance(x, DM) else DM(x)
    return DM(np.tile(dm.arr, (int(n), int(m))))


def diagcat(*args):
    if _is_symbolic(*args):
        mats = [_coerce_sx(a).data for a in args]
        n = sum(d.shape[0] for d in mats)
        m = sum(d.shape[1] for d in mats)
        out = _const_grid(np.zeros((n, m)))
        i = j = 0
        for d in mats:
            out[i:i + d.shape[0], j:j + d.shape[1]] = d
            i += d.shape[0]
            j += d.shape[1]
        return SX._wrap(out)
    mats = [(a.arr if isinstance(a, DM) else DM(a).arr) for a in args]
    n = sum(d.shape[0] for d in mats)
    m = sum(d.shape[1] for d in mats)
    out = np.zeros((n, m))
    i = j = 0
    for d in mats:
        out[i:i + d.shape[0], j:j + d.shape[1]] = d
        i += d.shape[0]
        j += d.shape[1]
    return DM(out)


def norm_2(x):
    if isinstance(x, (SX, SXNode)):
        sx = _coerce_sx(x)
        acc = SXNode.const(0.0)
        for node in sx.data.reshape(-1, order="F"):
            acc = acc + node * node
        return SX(SXNode("sqrt", (acc,)))
    v = np.asarray(x if not isinstance(x, DM) else x.arr, float)
    return float(np.linalg.norm(v.reshape(-1)))


def _elementwise_unary(op):
    def fn(x):
        if isinstance(x, SXNode):
            return SXNode(op, (x,))
        if isinstance(x, SX):
            return SX._wrap(np.vectorize(
                lambda nd: SXNode(op, (nd,)), otypes=[object])(x.data))
        if isinstance(x, DM):
            return DM(getattr(np, _NPNAME[op])(x.arr))
        return getattr(math, _MATHNAME[op])(x)
    return fn


_NPNAME = {"sin": "sin", "cos": "cos", "tan": "tan", "exp": "exp",
           "log": "log", "sqrt": "sqrt", "fabs": "abs", "atan": "arctan"}
_MATHNAME = {"sin": "sin", "cos": "cos", "tan": "tan", "exp": "exp",
             "log": "log", "sqrt": "sqrt", "fabs": "fabs", "atan": "atan"}

sin = _elementwise_unary("sin")
cos = _elementwise_unary("cos")
tan = _elementwise_unary("tan")
exp = _elementwise_unary("exp")
log = _elementwise_unary("log")
sqrt = _elementwise_unary("sqrt")
fabs = _elementwise_unary("fabs")
atan = _elementwise_unary("atan")


def atan2(a, b):
    if _is_symbolic(a, b):
        an = SX(a).data[0, 0] if isinstance(a, (SX, DM)) else SXNode._coerce(a)
        bn = SX(b).data[0, 0] if isinstance(b, (SX, DM)) else SXNode._coerce(b)
        return SX(SXNode("atan2", (an, bn)))
    return math.atan2(float(a), float(b))


def fmin(a, b):
    if _is_symbolic(a, b):
        return SX(SXNode("fmin", (SXNode._coerce(a), SXNode._coerce(b))))
    return min(float(a), float(b))


def fmax(a, b):
    if _is_symbolic(a, b):
        return SX(SXNode("fmax", (SXNode._coerce(a), SXNode._coerce(b))))
    return max(float(a), float(b))


def mtimes(a, b):
    a = a if isinstance(a, (SX, DM)) else DM(a)
    return a @ b


# ---------------------------------------------------------------------------
# Function
# ---------------------------------------------------------------------------

def _leaf_grid(sx: SX, what: str) -> np.ndarray:
    """Entries of a pure-symbol matrix; errors if any entry is composite."""
    for node in sx.data.reshape(-1):
        if not isinstance(node, SXNode) or node.op != "leaf":
            raise ValueError(
                f"{what} must be built only from symbols "
                f"(vertcat/reshape of SX.sym results); found {node!r}")
    return sx.data


class Function:
    """``ca.Function(name, ins, outs[, in_names, out_names])``.

    Numeric call -> DM results; symbolic call -> substituted SX graphs.
    Keyword calls (``F(x0=..., p=...)``) return a dict keyed by out names
    (``Casadi/single_shooting_v2.py:145-150`` usage).
    """

    def __init__(self, name: str, ins: Sequence, outs: Sequence,
                 in_names: Optional[Sequence[str]] = None,
                 out_names: Optional[Sequence[str]] = None):
        self.name = name
        self.ins = [_coerce_sx(i) for i in ins]
        self.outs = [_coerce_sx(o) for o in outs]
        self.in_names = list(in_names) if in_names is not None else [
            f"i{k}" for k in range(len(self.ins))]
        self.out_names = list(out_names) if out_names is not None else [
            f"o{k}" for k in range(len(self.outs))]
        self._in_grids = [_leaf_grid(i, f"input {k} of Function '{name}'")
                          for k, i in enumerate(self.ins)]

    def _env_from(self, args: Sequence) -> Dict[int, object]:
        env: Dict[int, object] = {}
        symbolic = False
        for grid, arg in zip(self._in_grids, args):
            if isinstance(arg, (SX, SXNode)):
                asx = _coerce_sx(arg)
                vals = asx.data.reshape(grid.shape, order="F")
                symbolic = True
            else:
                dm = arg if isinstance(arg, DM) else DM(arg)
                vals = dm.arr.reshape(grid.shape, order="F")
            it = np.nditer(np.empty(grid.shape), flags=["multi_index"])
            for _ in it:
                env[id(grid[it.multi_index])] = vals[it.multi_index]
        return env, symbolic

    def __call__(self, *args, **kwargs):
        if kwargs:
            args = tuple(kwargs.get(nm, DM.zeros(*g.shape))
                         for nm, g in zip(self.in_names, self._in_grids))
            named = True
        else:
            named = False
        if len(args) != len(self.ins):
            raise TypeError(
                f"Function '{self.name}' expects {len(self.ins)} inputs")
        env, symbolic = self._env_from(args)

        results = []
        for out in self.outs:
            roots = list(out.data.reshape(-1, order="F"))
            vals = _eval_nodes(roots, env, math)
            if symbolic or any(isinstance(v, SXNode) for v in vals):
                nodes = np.asarray(
                    [SXNode._coerce(v) for v in vals], dtype=object)
                results.append(SX._wrap(
                    nodes.reshape(out.data.shape, order="F")))
            else:
                arr = np.asarray(vals, float).reshape(
                    out.data.shape, order="F")
                results.append(DM(arr))
        if named:
            return dict(zip(self.out_names, results))
        return results[0] if len(results) == 1 else tuple(results)


# ---------------------------------------------------------------------------
# nlpsol
# ---------------------------------------------------------------------------

def _vec(v, size, fill):
    """A bound or guess as a flat column-major numpy vector of ``size``."""
    if v is None:
        return np.full(size, fill)
    a = np.asarray(v if not isinstance(v, DM) else v.arr, float)
    if a.size != size:
        return np.broadcast_to(a.reshape(-1, order="F"), (size,)).copy()
    return a.reshape(-1, order="F")


class _NlpSolver:
    def __init__(self, name: str, plugin: str, prob: dict,
                 opts: Optional[dict] = None, device=None):
        from ..solver.nlp import NLPOptions, make_nlpsol

        opts = dict(opts or {})
        self.name = name

        x_sx = _coerce_sx(prob["x"])
        self._x_leaves = list(
            _leaf_grid(x_sx, "prob['x']").reshape(-1, order="F"))
        if len({id(v) for v in self._x_leaves}) != len(self._x_leaves):
            raise ValueError("prob['x'] repeats a symbol")
        p_sx = _coerce_sx(prob["p"]) if "p" in prob and prob["p"] is not None \
            else SX(np.empty((0, 1), dtype=object))
        self._p_leaves = list(
            _leaf_grid(p_sx, "prob['p']").reshape(-1, order="F"))

        f_sx = _coerce_sx(prob["f"])
        if f_sx.numel() != 1:
            raise ValueError("prob['f'] must be scalar")
        self._f_node = f_sx.data.reshape(-1)[0]
        g_sx = _coerce_sx(prob["g"]) if "g" in prob and prob["g"] is not None \
            else SX(np.empty((0, 1), dtype=object))
        self._g_nodes = list(g_sx.data.reshape(-1, order="F"))

        self.n = len(self._x_leaves)
        self.m = len(self._g_nodes)

        xl, pl, fn, gn = (self._x_leaves, self._p_leaves, self._f_node,
                          self._g_nodes)

        def build_env(xv, pv):
            env = {id(leaf): xv[i] for i, leaf in enumerate(xl)}
            env.update({id(leaf): pv[j] for j, leaf in enumerate(pl)})
            return env

        def as_tensor(v, like):
            # a node that reads no leaf evaluates to a Python number
            return v if isinstance(v, torch.Tensor) else like.sum() * 0.0 + v

        def f_fn(xv, pv):
            return as_tensor(_eval_nodes([fn], build_env(xv, pv), torch)[0], xv)

        g_fn = None
        if self.m:
            def g_fn(xv, pv):
                vals = _eval_nodes(gn, build_env(xv, pv), torch)
                return torch.stack([as_tensor(v, xv) for v in vals])

        # IPOPT-style option passthrough: the tolerance
        io = opts.get("ipopt", {}) if isinstance(opts.get("ipopt"), dict) \
            else {}
        tol = float(io.get("acceptable_tol", io.get("tol", 1e-8)))
        nlp_opts = NLPOptions(tol=max(tol, 1e-9), tol_con=max(tol, 1e-9))
        self._solve = make_nlpsol(f_fn, g_fn, self.n, self.m, nlp_opts,
                                  device=device)
        self._stats = {"success": False, "return_status": "Unsolved",
                       "iterations": 0}

    def __call__(self, x0=None, lbx=None, ubx=None, lbg=None, ubg=None,
                 p=None, **_ignored):
        res = self._solve(_vec(x0, self.n, 0.0),
                          _vec(p, len(self._p_leaves), 0.0),
                          _vec(lbx, self.n, -inf), _vec(ubx, self.n, inf),
                          _vec(lbg, self.m, -inf), _vec(ubg, self.m, inf))
        ok = bool(res.converged)
        self._stats = {
            "success": ok,
            "return_status": "Solve_Succeeded" if ok else "Maximum_Reached",
            "iterations": int(res.iterations),
            "kkt": float(res.kkt), "viol": float(res.viol),
        }
        col = lambda t: DM(t.double().cpu().numpy().reshape(-1, 1))
        return {"x": col(res.x), "f": DM(float(res.f)), "g": col(res.g),
                "lam_g": col(res.lam_g)}

    def stats(self):
        return dict(self._stats)

    def batch_solve(self, x0s, ps=None, lbx=None, ubx=None, lbg=None,
                    ubg=None):
        """Solve a batch of instances of this NLP in one call: (B, n)
        initial guesses and (B, np) parameters, one AL / projected-Newton
        solve over the batch axis.  Returns the ``NLPResult`` with a leading
        batch axis."""
        x0s = np.asarray(x0s, float)
        B = x0s.shape[0]
        if ps is None:
            ps = np.zeros((B, len(self._p_leaves)))
        ps = np.asarray(ps, float).reshape(B, -1)
        return self._solve(x0s, ps, _vec(lbx, self.n, -inf),
                           _vec(ubx, self.n, inf), _vec(lbg, self.m, -inf),
                           _vec(ubg, self.m, inf))


def nlpsol(name: str, plugin: str, prob: dict, opts: Optional[dict] = None,
           device=None):
    """``ca.nlpsol('solver', 'ipopt', {'f','x','g','p'}, opts)`` equivalent.

    The plugin string is accepted for script compatibility; the solve is the
    AL / projected-Newton NLP solver, in float64 as CasADi and IPOPT
    compute.  ``device`` is the port's addition: None is the CUDA device
    (raising where there is none; pass ``device="cpu"`` for the CPU).
    """
    return _NlpSolver(name, plugin, prob, opts, device)


def qpsol(name: str, plugin: str, prob: dict, opts: Optional[dict] = None,
          device=None):
    """QPs go through the same solve path (Newton terminates in one round)."""
    return _NlpSolver(name, plugin, prob, opts, device)
