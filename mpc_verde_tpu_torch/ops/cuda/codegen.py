"""Generate a CUDA device model from a traced program (``trace.py``).

``model_header(program)`` emits one C++ header: a model struct,
``TracedModel``, that meets the concept ``csrc/rollout.cuh`` states, so that
the hand-written kernels K2 (``rollout.cuh``) and K3 (``fused.cuh``, with
K1's ``backward_stage``) are instantiated on it as on the hand-written
unicycle model:

* ``kNX`` / ``kNU``, ``clip`` (``torch.clamp``'s rule), and the stage box
  ``model_box(m, x, p, k, lo, hi)`` on floats, reading p and the stage index;
* ``step`` / ``stage_cost`` / ``terminal_cost``, templates on the scalar type
  ``T`` (``float`` in K2, the dual numbers of ``dual.cuh`` in K3, ``double``
  in the host test); values that do not depend on x or u stay of the plain
  type ``S`` (float in the kernels), so a dual number only carries what
  differentiates; the functions of ``scalar.cuh`` and ``dual.cuh``, and
  those of ``traced_math.cuh`` (tanh, sigmoid, log1p, exp2, erfinv, the
  rounding functions, pow, fmod, remainder), which the header includes only
  where the program calls one, so that a program without them keeps its
  text and its library;
* ``has_terminal_cost`` and ``model_terminal_value``: K3's gN and HN from
  one evaluation of the terminal cost on second-order duals over x_N.

The hoisted table arrives as a device pointer (``TracedModel::tab``); the
program's shape is in the text (``kNX``, ``kNU``, ``kMinNpar``, the table's
size and the dims of the tables read at the stage index), its table's
values never are, so one build serves OCPs that differ only in their
weights.  Literals are written exactly, as hex floats.

``units(program)`` gives the two translation units of the program's library
(``build.py`` builds it at first use): K2's and K3's, each the header's text
followed by the kernels' header and C entry points named with the text's
hash, of the signatures of the kernels library's (``mv_linesearch_forward``,
``mv_linesearch_occupancy`` and the rounds' cost re-base
``mv_trajectory_cost`` in K2's unit, ``mv_fused_backward``), whose model
arguments are the table alone.
"""
from __future__ import annotations

import hashlib
import math

from .trace import COMPARE, I, Program

_C_UNARY = {"sin": "mv_sin", "cos": "mv_cos", "tan": "mv_tan",
            "exp": "mv_exp", "log": "mv_log", "sqrt": "mv_sqrt",
            "abs": "mv_abs", "recip": "mv_recip"}
# the instructions whose device functions csrc/traced_math.cuh holds; a
# program that uses none of them does not include it
_C_MATH = {"tanh": "mv_tanh", "sigmoid": "mv_sigmoid", "log1p": "mv_log1p",
           "exp2": "mv_exp2", "erfinv": "mv_erfinv", "floor": "mv_floor",
           "ceil": "mv_ceil", "round": "mv_round", "sign": "mv_sign",
           "pow": "mv_pow", "fmod": "mv_fmod", "rem": "mv_remainder"}
_C_BINARY = {"add": "+", "sub": "-", "mul": "*", "div": "/", "addi": "+",
             "subi": "-", "muli": "*"}
_C_COMPARE = {"gt": ">", "lt": "<", "ge": ">=", "le": "<=", "eq": "==",
              "ne": "!="}


def _literal(v: float) -> str:
    if math.isnan(v):
        return "S(NAN)"
    if math.isinf(v):
        return "S(INFINITY)" if v > 0 else "S(-INFINITY)"
    return f"S({float(v).hex()})"


def _body(program: Program, roots, varying_inputs) -> list:
    """The declarations computing ``roots``, one line a value ``vN``: a
    float value is of type T where it depends on one of
    ``varying_inputs``, else S."""
    ops, kinds = program.ops, program.kinds
    vary, lines, ctype = {}, [], {}
    for v in program.reachable(roots):
        ins = ops[v]
        name = ins[0]
        if name == "in":
            vary[v] = ins[1] in varying_inputs
        elif name == "sel":
            vary[v] = vary[ins[2]] or vary[ins[3]]
        elif name in ("cf", "ci", "cb", "k", "tab", "tabi"):
            vary[v] = False
        else:
            vary[v] = any(vary[a] for a in ins[1:])
        kind = kinds[v]
        ctype[v] = ("bool" if kind == "b" else "int" if kind == I
                    else "T" if vary[v] else "S")
        a = [f"v{i}" for i in ins[1:]] if name not in (
            "in", "cf", "ci", "cb", "k", "tab", "tabi") else []
        if name == "in":
            expr = f"S(p[{ins[2]}])" if ins[1] == "p" else f"{ins[1]}[{ins[2]}]"
        elif name == "k":
            expr = "k"
        elif name == "cf":
            expr = _literal(ins[1])
        elif name == "ci":
            expr = str(int(ins[1]))
        elif name == "cb":
            expr = "true" if ins[1] else "false"
        elif name == "tab":
            expr = f"S(m.tab[{ins[1]}])"
        elif name == "tabi":
            _, base, stride, dim, iv = ins
            expr = (f"S(m.tab[{base} + {stride} * (v{iv} < 0 ? 0 : (v{iv} > "
                    f"{dim - 1} ? {dim - 1} : v{iv}))])")
        elif name in _C_BINARY:
            expr = f"{a[0]} {_C_BINARY[name]} {a[1]}"
        elif name == "neg":
            expr = f"-{a[0]}"
        elif name in _C_UNARY or name in _C_MATH:
            expr = f"{_C_UNARY.get(name) or _C_MATH[name]}({', '.join(a)})"
        elif name in ("max", "min"):
            expr = f"mv_{name}imum({a[0]}, {a[1]})"
        elif name in COMPARE:
            op = _C_COMPARE[name]
            expr = (f"{a[0]} {op} {a[1]}" if kinds[ins[1]] == I else
                    f"mv_value({a[0]}) {op} mv_value({a[1]})")
        elif name == "and":
            expr = f"{a[0]} && {a[1]}"
        elif name == "or":
            expr = f"{a[0]} || {a[1]}"
        elif name == "not":
            expr = f"!{a[0]}"
        elif name == "i2f":
            expr = f"S({a[0]})"
        elif name == "b2f":
            expr = f"({a[0]} ? S(1) : S(0))"
        elif name == "sel":
            t = ctype[v]
            expr = f"{a[0]} ? {t}({a[1]}) : {t}({a[2]})"
        else:
            raise ValueError(f"no C for instruction {name!r}")
        lines.append(f"  const {ctype[v]} v{v} = {expr};")
    return lines


def _function(program, roots, varying, head, tail):
    """A template on T: ``head``, the declarations of ``roots``, ``tail``."""
    return "\n".join([head, "  using S = typename MvScalar<T>::type;",
                      *_body(program, roots, varying), *tail, "}"])


def uses_traced_math(program: Program) -> bool:
    """Whether ``program`` runs a device function of csrc/traced_math.cuh."""
    return any(ins[0] in _C_MATH for ins in program.ops)


def model_header(program: Program) -> str:
    """The device model of ``program`` (see the module docstring)."""
    nx, nu = program.nx, program.nu
    out = program.outputs
    has_term = "terminal_cost" in out
    math_include = ('#include "traced_math.cuh"\n' if uses_traced_math(program)
                    else "")
    parts = [f"""// A device model generated by mpc_verde_tpu_torch/ops/cuda/codegen.py
// from the trace of an OCP's callables (ops/cuda/trace.py): (nx, nu) =
// ({nx}, {nu}), {len(program.ops)} instructions, {program.n_table} table entries.

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"
#include "scalar.cuh"
{math_include}
namespace {{

struct TracedModel {{
  static constexpr int kNX = {nx}, kNU = {nu};
  static constexpr int kMinNpar = {program.min_npar};
  static constexpr int kTable = {program.n_table};
  const float* tab;  // the hoisted constants, device memory

  // clip = min(max(v, lo), hi), NaN-propagating, as torch.clamp takes it
  // (hi where lo > hi)
  __device__ __forceinline__ static float clip(float v, float lo, float hi) {{
    const float t = v < lo ? lo : v;
    return t > hi ? hi : t;
  }}
}};"""]
    parts.append(_function(
        program, out["step"], ("x", "u"),
        "template <class T>\n__device__ __forceinline__ void step(const "
        f"TracedModel& m, T (&x)[{nx}], const T (&u)[{nu}], const float* p) {{",
        [f"  x[{i}] = T(v{v});" for i, v in enumerate(out["step"])]))
    parts.append(_function(
        program, out["stage_cost"], ("x", "u"),
        "template <class T>\n__device__ __forceinline__ T stage_cost(const "
        f"TracedModel& m, const T (&x)[{nx}], const T (&u)[{nu}], "
        "const float* p) {",
        [f"  return T(v{out['stage_cost'][0]});"]))
    parts.append("__host__ __device__ __forceinline__ constexpr bool "
                 "has_terminal_cost(const TracedModel&) {\n  return "
                 f"{'true' if has_term else 'false'};\n}}")
    head = ("template <class T>\n__device__ __forceinline__ T terminal_cost("
            f"const TracedModel& m, const T (&x)[{nx}], const float* p) {{")
    if has_term:
        parts.append(_function(
            program, out["terminal_cost"], ("x",), head,
            [f"  return T(v{out['terminal_cost'][0]});"]))
    else:
        parts.append(head + "\n  return T(0.0f);\n}")
    box = ("__device__ __forceinline__ void model_box(const TracedModel& m, "
           f"const float (&x)[{nx}], const float* p, int k,\n"
           f"                                          float (&lo)[{nu}], "
           f"float (&hi)[{nu}]) {{")
    if "lb" in out:
        lines = _body(program, out["lb"] + out["ub"], ())
        parts.append("\n".join(
            [box, "  using S = float;", *lines,
             *(f"  lo[{a}] = v{v};" for a, v in enumerate(out["lb"])),
             *(f"  hi[{a}] = v{v};" for a, v in enumerate(out["ub"])), "}"]))
    else:
        parts.append("\n".join(
            [box, f"  for (int a = 0; a < {nu}; ++a) {{",
             "    lo[a] = -INFINITY;", "    hi[a] = INFINITY;", "  }", "}"]))
    parts.append(f"""// K3's terminal value: the gradient and Hessian of the terminal cost at
// x_N, from one evaluation on second-order duals over x_N (zeros without one).
__device__ __forceinline__ void model_terminal_value(const TracedModel& m, const float* xN,
                                                     const float* pN, float (&Vx)[{nx}],
                                                     float (&Vxx)[{nx}][{nx}]) {{
  Dual<{nx}, true> xz[{nx}];
  for (int i = 0; i < {nx}; ++i) xz[i] = Dual<{nx}, true>::var(xN[i], i);
  const Dual<{nx}, true> c = terminal_cost(m, xz, pN);
  for (int i = 0; i < {nx}; ++i) {{
    Vx[i] = c.g[i];
    for (int j = 0; j < {nx}; ++j) Vxx[i][j] = c.hess(i, j);
  }}
}}

}}  // namespace
""")
    return "\n\n".join(parts)


def program_hash(program: Program) -> str:
    """The hash that names the program's entry points: of its header's text."""
    return hashlib.sha256(model_header(program).encode()).hexdigest()[:16]


_K2_ENTRY = """
#include "rollout.cuh"

// K2 on the generated model: the arguments of mv_linesearch_forward
// (rollout.cu), of which `model` and `model_ints` are unused and `tables` is
// the hoisted table (TracedModel::kTable floats, device memory).
extern "C" int mv_linesearch_forward_{h}(
    int B, int N, int npar, const float* x0, const float* xs, const float* us,
    const float* ps, const float* kff, const float* K, const float* model,
    const int* model_ints, const float* tables, const float* alphas, int n_alphas,
    float* xs_out, float* us_out, float* cost_out, int* best_out, int variant, int problems,
    const int* layout, void* stream) {{
  if (tables == nullptr || npar < TracedModel::kMinNpar) return cudaErrorInvalidValue;
  Alphas al;
  LanesLayout L;
  const cudaError_t err = linesearch_prepare(alphas, n_alphas, variant, problems, layout, al, L);
  if (err != cudaSuccess) return err;
  if (B == 0) return 0;
  const RolloutArgs g{{x0, xs, us, ps, kff, K, xs_out, us_out, cost_out, best_out, B, N, npar}};
  return linesearch_run(TracedModel{{tables}}, g, al, variant, L,
                        static_cast<cudaStream_t>(stream));
}}

// K2's registers, local memory and resident blocks an SM on the generated
// model: the arguments of mv_linesearch_occupancy (rollout.cu).
extern "C" int mv_linesearch_occupancy_{h}(int variant, int threads, int smem_bytes, int* out) {{
  return linesearch_occupancy<TracedModel>(variant, threads, smem_bytes, out);
}}

// The rounds' cost re-base on the generated model: the arguments of
// mv_trajectory_cost (rollout.cu), `tables` as above.
extern "C" int mv_trajectory_cost_{h}(
    int B, int N, int npar, const float* xs, const float* us, const float* ps,
    const bool* mask, const float* cost_in, const float* model, const int* model_ints,
    const float* tables, float* cost_out, void* stream) {{
  if (tables == nullptr || npar < TracedModel::kMinNpar) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const CostArgs g{{xs, us, ps, mask, cost_in, cost_out, B, N, npar}};
  return trajectory_cost_run(TracedModel{{tables}}, g, static_cast<cudaStream_t>(stream));
}}
"""

_K3_ENTRY = """
#include "fused.cuh"

// K3 on the generated model: the arguments of mv_fused_backward (fused.cu),
// of which `model` and `model_ints` are unused and `tables` is the hoisted
// table; no timing instantiation (`clocks` must be null).
extern "C" int mv_fused_backward_{h}(
    int use_ddp, int B, int N, int npar, float tol, const float* xs, const float* us,
    const float* ps, const float* reg, const float* ddp, const float* model,
    const int* model_ints, const float* tables, float* kff, float* K, float* dV1, float* dV2,
    float* gmax, int variant, int problems, int threads, const int* strides, void* clocks,
    void* stream) {{
  if (tables == nullptr || npar < TracedModel::kMinNpar || variant < 0 || variant > 1)
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const FusedArgs g{{xs, us, ps, reg, ddp, kff, K, dV1, dV2, gmax, B, N, npar, tol}};
  return fused_run<TracedModel, false>(TracedModel{{tables}}, g, use_ddp != 0, variant, problems,
                                       threads, strides, static_cast<long long*>(clocks),
                                       static_cast<cudaStream_t>(stream));
}}
"""


def units(program: Program) -> dict:
    """The program's translation units, {file name: text}: K2's and K3's."""
    header, h = model_header(program), program_hash(program)
    return {f"traced_rollout_{h}.cu": header + _K2_ENTRY.format(h=h),
            f"traced_fused_{h}.cu": header + _K3_ENTRY.format(h=h)}
