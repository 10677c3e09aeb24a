"""Constant-folding scalar codegen over three kinds of value.

Counterpart of ``manipulapy_tpu/ops/cgen.py``. Every small-matrix quantity
of the exact dynamics is a Python list of *values*, and a value is one of:

* a Python float: a constant (robot geometry), folded at build time, so a
  multiply by a zero screw component disappears and float*float folds;
* a ``torch.Tensor`` of per-scenario values: running the emitter on
  tensors gives the plain PyTorch version of a kernel (the "twin");
* a :class:`CVar`, a symbolic f32 name in an :class:`Emitter`: each
  operation appends one SSA statement ``const float tK = a OP b;``, so
  running the same emitter on CVars gives the straight-line C source of
  the CUDA kernel's device function;
* a :class:`Dual`, a primal value and its tangent (forward mode), each
  itself a float, a tensor or a CVar. Over tensors the tangent carries a
  leading seed axis (m, ...), so one pass gives every column of a
  Jacobian; over CVars it is one scalar per thread, and each operation
  emits the primal statement and then the tangent statements. A tangent
  that is the constant 0 folds away, as the primal's zeros do, and a Dual
  whose tangent folds to 0 becomes its primal.

The arithmetic helpers below fold constants exactly as the JAX package's
do. ``sqrt``, ``sin``, ``cos``, ``clip`` and ``recip`` are the only places
where the kind of value shows. The tangent rules are those of
``jax.linearize`` over the JAX emitter: ``sin' = cos``, ``cos' = -sin``,
``sqrt' = 0.5 / sqrt``, ``(1/d)' = -1/d^2`` and, for a clamp, the tangent
is kept inside the bounds, halved exactly at a bound and 0 outside
(``jnp.clip`` is ``maximum`` then ``minimum``, whose JVPs split ties
evenly). The tensor clamp is ``torch.maximum`` then ``torch.minimum``,
whose derivatives split ties the same way (``torch.clamp``'s is 1 at a
bound), so autograd of the tensor emitter is a cross-check of these
rules; the plain version of a linearization is the Dual emitter.

Emission rules for C (each keeps the C program equal to the twin):

* every folded constant is written as its f32 rounding with an ``f``
  suffix, as JAX rounds a weak-typed Python float against an f32 array; a
  bare double literal would promote the arithmetic to f64;
* a clamp is ``x < lo ? lo : (x > hi ? hi : x)``, which keeps a NaN (as
  ``torch.maximum``/``torch.minimum`` do) where ``fminf``/``fmaxf`` would drop it; an
  infinite bound is left out, which gives the same result;
* maths functions are ``sinf``, ``cosf`` and ``sqrtf``, never the fast
  intrinsics.

Convention: matrices are row-major nested lists; twists are 6-lists
``[w; v]``; transforms are ``(R, p)`` pairs (3x3 list, 3-list).
"""

from __future__ import annotations

import math
import re
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "CVar",
    "Dual",
    "Emitter",
    "c_literal",
    "is_const",
    "add",
    "sub",
    "mul",
    "neg",
    "sqrt",
    "sin",
    "cos",
    "recip",
    "clip",
    "dot",
    "mat_vec",
    "mat_mul",
    "mat_T",
    "cross",
    "compose",
    "adjoint_apply",
    "adjoint_T_apply",
    "ad_apply",
    "ad_T_apply",
    "from_numpy",
    "primal",
    "tangent",
    "c_function",
    "chain_length",
]


def c_literal(x: float) -> str:
    """A C float literal equal to the f32 rounding of ``x``."""
    if not (math.isfinite(x) and abs(x) <= float(np.finfo(np.float32).max)):
        raise ValueError(f"constant {x!r} is not finite in f32")
    v = float(np.float32(x))
    text = "%.9e" % v + "f"
    return f"({text})" if v < 0 or text.startswith("-") else text


class Emitter:
    """Collects the SSA statements of one straight-line C function body."""

    def __init__(self):
        self.lines: List[str] = []
        self._count = 0

    def var(self, expr: str) -> "CVar":
        name = f"t{self._count}"
        self._count += 1
        self.lines.append(f"const float {name} = {expr};")
        return CVar(self, name)

    def ref(self, x) -> str:
        """The C expression of a value: a name or a literal."""
        if isinstance(x, CVar):
            return x.name
        if is_const(x):
            return c_literal(x)
        raise TypeError(f"cannot emit a value of type {type(x).__name__}")


class CVar:
    """A symbolic f32 value; arithmetic on it emits C statements."""

    __slots__ = ("em", "name")

    def __init__(self, em: Emitter, name: str):
        self.em = em
        self.name = name

    def _bin(self, op: str, a, b) -> "CVar":
        if isinstance(a, Dual) or isinstance(b, Dual):
            return NotImplemented  # the Dual's own operator takes over
        return self.em.var(f"{self.em.ref(a)} {op} {self.em.ref(b)}")

    def __add__(self, o):
        return self._bin("+", self, o)

    def __radd__(self, o):
        return self._bin("+", o, self)

    def __sub__(self, o):
        return self._bin("-", self, o)

    def __rsub__(self, o):
        return self._bin("-", o, self)

    def __mul__(self, o):
        return self._bin("*", self, o)

    def __rmul__(self, o):
        return self._bin("*", o, self)

    def __neg__(self):
        return self.em.var(f"-{self.name}")


class Dual:
    """A primal value and its tangent; arithmetic on it follows the
    forward-mode rules. Build one with :func:`dual`."""

    __slots__ = ("p", "t")

    def __init__(self, p, t):
        self.p = p
        self.t = t

    def __add__(self, o):
        return add(self, o)

    def __radd__(self, o):
        return add(o, self)

    def __sub__(self, o):
        return sub(self, o)

    def __rsub__(self, o):
        return sub(o, self)

    def __mul__(self, o):
        return mul(self, o)

    def __rmul__(self, o):
        return mul(o, self)

    def __neg__(self):
        return neg(self)


Value = Union[float, torch.Tensor, CVar, Dual]


def is_const(x: Value) -> bool:
    return isinstance(x, (int, float))


def dual(p: Value, t: Value) -> Value:
    """``Dual(p, t)``, or ``p`` itself when the tangent is the constant 0."""
    if is_const(t) and t == 0.0:
        return p
    return Dual(p, t)


def primal(x: Value) -> Value:
    return x.p if isinstance(x, Dual) else x


def tangent(x: Value) -> Value:
    """The tangent of a value; any value that is not a Dual has tangent 0."""
    return x.t if isinstance(x, Dual) else 0.0


def _duals(a: Value, b: Value) -> bool:
    return isinstance(a, Dual) or isinstance(b, Dual)


def add(a: Value, b: Value) -> Value:
    if is_const(a) and a == 0.0:
        return b
    if is_const(b) and b == 0.0:
        return a
    if _duals(a, b):
        return dual(add(primal(a), primal(b)), add(tangent(a), tangent(b)))
    return a + b


def sub(a: Value, b: Value) -> Value:
    if is_const(b) and b == 0.0:
        return a
    if is_const(a) and is_const(b):
        return a - b
    if is_const(a) and a == 0.0:
        return neg(b)
    if _duals(a, b):
        return dual(sub(primal(a), primal(b)), sub(tangent(a), tangent(b)))
    return a - b


def neg(a: Value) -> Value:
    if isinstance(a, Dual):
        return dual(neg(a.p), neg(a.t))
    return -a


def mul(a: Value, b: Value) -> Value:
    if is_const(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return neg(b)
    if is_const(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return neg(a)
    if _duals(a, b):
        ap, bp = primal(a), primal(b)
        return dual(mul(ap, bp), add(mul(tangent(a), bp), mul(ap, tangent(b))))
    return a * b


def _unary(x: Value, const_fn, c_name: str, torch_fn) -> Value:
    if is_const(x):
        return float(const_fn(x))
    if isinstance(x, CVar):
        return x.em.var(f"{c_name}({x.name})")
    return torch_fn(x)


def sqrt(x: Value) -> Value:
    if isinstance(x, Dual):
        p = sqrt(x.p)
        return dual(p, mul(x.t, mul(0.5, recip(p))))
    return _unary(x, np.sqrt, "sqrtf", torch.sqrt)


def sin(x: Value) -> Value:
    if isinstance(x, Dual):
        return dual(sin(x.p), mul(x.t, cos(x.p)))
    return _unary(x, np.sin, "sinf", torch.sin)


def cos(x: Value) -> Value:
    if isinstance(x, Dual):
        return dual(cos(x.p), mul(x.t, neg(sin(x.p))))
    return _unary(x, np.cos, "cosf", torch.cos)


def recip(x: Value) -> Value:
    """``1 / x`` (a true division, as ``1.0 / d`` in the JAX emitter)."""
    if isinstance(x, Dual):
        r = recip(x.p)
        return dual(r, neg(mul(x.t, mul(r, r))))
    if isinstance(x, CVar):
        return x.em.var(f"{c_literal(1.0)} / {x.name}")
    return 1.0 / x


def _clip_tangent(p: Value, t: Value, lo: float, hi: float) -> Value:
    """The tangent of ``clip(p)``: ``t`` strictly inside the finite bounds,
    ``0.5 t`` at a bound, 0 outside (and 0 for a NaN primal), the JVP of
    ``jnp.clip``."""
    if is_const(t) or is_const(p):
        if is_const(t) and t == 0.0:
            return 0.0
        if is_const(p):
            w = 1.0 if lo < p < hi else (0.5 if p in (lo, hi) else 0.0)
            return mul(t, w)
    bounds = [(op, b) for op, b in ((">", lo), ("<", hi)) if math.isfinite(b)]
    if isinstance(p, CVar):
        em = p.em
        if not bounds:
            return t
        inside = " && ".join(f"{p.name} {op} {c_literal(b)}" for op, b in bounds)
        at = " || ".join(f"{p.name} == {c_literal(b)}" for _, b in bounds)
        half = f"{em.ref(t)} * {c_literal(0.5)}"
        return em.var(f"({inside}) ? {em.ref(t)} : (({at}) ? {half} : {c_literal(0.0)})")
    inside = torch.ones_like(p, dtype=torch.bool)
    at = torch.zeros_like(p, dtype=torch.bool)
    for op, b in bounds:
        inside = inside & ((p > b) if op == ">" else (p < b))
        at = at | (p == b)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    return torch.where(inside, t, torch.where(at, t * 0.5, zero))


def clip(x: Value, lo: float, hi: float) -> Value:
    """Clamp to ``[lo, hi]`` (Python-float bounds, either may be infinite);
    NaN stays NaN on every backend."""
    if isinstance(x, Dual):
        return dual(clip(x.p, lo, hi), _clip_tangent(x.p, x.t, lo, hi))
    if is_const(x):
        return float(np.clip(x, lo, hi))
    if isinstance(x, CVar):
        expr = x.name
        if math.isfinite(hi):
            expr = f"({x.name} > {c_literal(hi)} ? {c_literal(hi)} : {expr})"
        if math.isfinite(lo):
            expr = f"({x.name} < {c_literal(lo)} ? {c_literal(lo)} : {expr})"
        return x.em.var(expr)
    # maximum, then minimum, as jnp.clip: their derivatives split a tie
    # evenly, so autograd of the tensor emitter follows JAX's clamp rule
    # (torch.clamp's derivative is 1 at a bound). Both keep NaN.
    if math.isfinite(lo):
        x = torch.maximum(x, x.new_tensor(lo))
    if math.isfinite(hi):
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def dot(u: Sequence[Value], v: Sequence[Value]) -> Value:
    s: Value = 0.0
    for a, b in zip(u, v):
        s = add(s, mul(a, b))
    return s


def mat_vec(M: Sequence[Sequence[Value]], v: Sequence[Value]) -> List[Value]:
    return [dot(row, v) for row in M]


def mat_mul(A: Sequence[Sequence[Value]], B: Sequence[Sequence[Value]]) -> List[List[Value]]:
    n, k, m = len(A), len(B), len(B[0])
    return [[dot(A[i], [B[r][j] for r in range(k)]) for j in range(m)] for i in range(n)]


def mat_T(A: Sequence[Sequence[Value]]) -> List[List[Value]]:
    return [[A[j][i] for j in range(len(A))] for i in range(len(A[0]))]


def cross(a: Sequence[Value], b: Sequence[Value]) -> List[Value]:
    return [
        sub(mul(a[1], b[2]), mul(a[2], b[1])),
        sub(mul(a[2], b[0]), mul(a[0], b[2])),
        sub(mul(a[0], b[1]), mul(a[1], b[0])),
    ]


Transform = Tuple[List[List[Value]], List[Value]]


def compose(T1: Transform, T2: Transform) -> Transform:
    """(R1, p1) o (R2, p2) = (R1 R2, R1 p2 + p1)."""
    R1, p1 = T1
    R2, p2 = T2
    return mat_mul(R1, R2), [add(x, y) for x, y in zip(mat_vec(R1, p2), p1)]


def adjoint_apply(T: Transform, V: Sequence[Value]) -> List[Value]:
    """``Ad(T) V`` for a twist ``[w; v]``: ``w' = R w``, ``v' = p x (R w) + R v``."""
    R, p = T
    w = mat_vec(R, V[:3])
    v = mat_vec(R, V[3:])
    return w + [add(a, b) for a, b in zip(cross(p, w), v)]


def adjoint_T_apply(T: Transform, F: Sequence[Value]) -> List[Value]:
    """``Ad(T)^T F`` for a wrench ``[m; f]``: ``m' = R^T (m - p x f)``,
    ``f' = R^T f``."""
    R, p = T
    Rt = mat_T(R)
    m, f = F[:3], F[3:]
    m_out = mat_vec(Rt, [sub(a, b) for a, b in zip(m, cross(p, f))])
    return m_out + mat_vec(Rt, f)


def ad_apply(V: Sequence[Value], W: Sequence[Value]) -> List[Value]:
    """Lie bracket ``ad_V W`` for twists."""
    w, v = V[:3], V[3:]
    ww, wv = W[:3], W[3:]
    bottom = [add(a, b) for a, b in zip(cross(v, ww), cross(w, wv))]
    return cross(w, ww) + bottom


def ad_T_apply(V: Sequence[Value], F: Sequence[Value]) -> List[Value]:
    """``ad_V^T F`` for a wrench ``[m; f]``: ``m' = -w x m - v x f``,
    ``f' = -w x f``."""
    w, v = V[:3], V[3:]
    m, f = F[:3], F[3:]
    top = [neg(add(a, b)) for a, b in zip(cross(w, m), cross(v, f))]
    return top + [neg(x) for x in cross(w, f)]


def c_function(name: str, arrays_in, scalars_in, arrays_out, body, preamble=()):
    """The C source of ``static __device__ __forceinline__ void name(...)``
    that runs ``body`` once over CVars.

    ``arrays_in``: ``(name, size)`` of the ``const float`` array inputs;
    ``scalars_in``: names of the ``float`` scalar inputs; ``arrays_out``:
    ``(name, size)`` of the output arrays. ``preamble``: ``(decl, names)``
    pairs, a C parameter declaration and the CVars it defines through
    ``lines``, a function ``em -> (lines, {name: CVar})``. ``body`` takes
    the inputs as keyword arguments (lists of CVars for arrays, CVars for
    scalars, and the preamble's values) and returns one list of values per
    output array. Returns ``(source, statement count)``."""
    em = Emitter()
    kwargs = {a: [CVar(em, f"{a}_{i}") for i in range(size)] for a, size in arrays_in}
    kwargs.update({sc: CVar(em, sc) for sc in scalars_in})
    params = [f"const float {a}[{size}]" for a, size in arrays_in]
    params += [f"float {sc}" for sc in scalars_in]
    head = [f"const float {a}_{i} = {a}[{i}];" for a, size in arrays_in for i in range(size)]
    for decl, make in preamble:
        params.append(decl)
        lines, values = make(em)
        head += lines
        kwargs.update(values)
    params += [f"float {a}[{size}]" for a, size in arrays_out]
    outs = body(**kwargs)
    stores = []
    for (a, size), vals in zip(arrays_out, outs):
        if len(vals) != size:
            raise ValueError(f"{name}: output {a} has {len(vals)} values, not {size}")
        stores += [f"{a}[{i}] = {em.ref(v)};" for i, v in enumerate(vals)]
    text = "\n".join("  " + line for line in head + em.lines + stores)
    source = (
        f"static __device__ __forceinline__ void {name}(\n    "
        + ",\n    ".join(params)
        + f") {{\n{text}\n}}\n"
    )
    return source, len(em.lines)


def from_numpy(arr) -> list:
    """Nested lists of Python floats from an array (constants)."""
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 1:
        return [float(x) for x in a]
    return [from_numpy(row) for row in a]


def chain_length(source: str) -> int:
    """The longest chain of dependent statements in an emitted body
    (:func:`c_function`'s source): each ``const float tK = ...;`` is one
    link after the longest chain among the statements it reads; inputs and
    constants start no chain."""
    depth = {}
    for name, expr in re.findall(r"const float t(\d+) = ([^;]*);", source):
        depth[name] = 1 + max((depth[d] for d in re.findall(r"\bt(\d+)\b", expr)), default=0)
    return max(depth.values(), default=0)
