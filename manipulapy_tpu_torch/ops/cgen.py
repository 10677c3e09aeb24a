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
  Jacobian; over CVars it is one scalar per thread, or a :class:`Seeds`,
  the tangents of a group of G seeds, and each operation emits the primal
  statement once and then the tangent statements, once per seed. A
  tangent that is the constant 0 folds away, as the primal's zeros do, and
  a Dual whose tangent folds to 0 becomes its primal.

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
  infinite bound is left out, which gives the same result; a clamp of zero
  width is ``x != x ? x : bound``, the bound +0.0 where it is zero;
* maths functions are ``sinf``, ``cosf`` and ``sqrtf``, never the fast
  intrinsics.

Convention: matrices are row-major nested lists; twists are 6-lists
``[w; v]``; transforms are ``(R, p)`` pairs (3x3 list, 3-list).
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import math
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "CVar",
    "Dual",
    "Seeds",
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
    "transform_inv_const",
    "adjoint_apply",
    "adjoint_T_apply",
    "ad_apply",
    "ad_T_apply",
    "from_numpy",
    "primal",
    "tangent",
    "seed",
    "keep",
    "KEEP_SOURCE",
    "c_function",
    "chain_length",
    "TEAM_SOURCE",
    "TeamPartition",
    "TeamStep",
    "partition_team",
    "team_function",
]


def c_literal(x: float) -> str:
    """A C float literal equal to the f32 rounding of ``x``."""
    if not (math.isfinite(x) and abs(x) <= float(np.finfo(np.float32).max)):
        raise ValueError(f"constant {x!r} is not finite in f32")
    v = float(np.float32(x))
    text = "%.9e" % v + "f"
    return f"({text})" if v < 0 or text.startswith("-") else text


class Emitter:
    """Collects the SSA statements of one straight-line C function body:
    per statement its C line, its expression and the names of the CVars it
    reads (``operands``, in the expression's order), so that the dependence
    graph needs no parsing of the text (:func:`chain_length`,
    :func:`partition_team`)."""

    def __init__(self):
        self.lines: List[str] = []
        self.exprs: List[str] = []
        self.operands: List[Tuple[str, ...]] = []
        self._count = 0

    def var(self, expr: str, *reads) -> "CVar":
        """A new statement ``const float tK = expr;``; ``reads`` are the
        values the expression names (constants among them are ignored)."""
        name = f"t{self._count}"
        self._count += 1
        self.lines.append(f"const float {name} = {expr};")
        self.exprs.append(expr)
        self.operands.append(tuple(x.name for x in reads if isinstance(x, CVar)))
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
        if isinstance(a, (Dual, Seeds)) or isinstance(b, (Dual, Seeds)):
            return NotImplemented  # the other value's own operator takes over
        return self.em.var(f"{self.em.ref(a)} {op} {self.em.ref(b)}", a, b)

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
        return self.em.var(f"-{self.name}", self)


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


class Seeds:
    """The tangents of a group of seeds, one CVar each: an operation maps
    over the seeds in order, with the other operand (a primal value or a
    constant) shared. So a rule's shared factor (``cos(p)`` in ``sin``'s,
    ``r * r`` in ``recip``'s, ``0.5 * recip(p)`` in ``sqrt``'s) is emitted
    once, as the tensor version computes it once for its seed axis, and each
    seed gets the one-seed program's operations in its order. A seed's zeros
    are run-time values, never folded: as in the tensor version, ``0 * p``
    keeps a NaN and the sign of a zero."""

    __slots__ = ("v",)

    def __init__(self, values):
        self.v = tuple(values)

    def _map(self, fn, o, swap: bool = False) -> "Seeds":
        ov = o.v if isinstance(o, Seeds) else (o,) * len(self.v)
        return Seeds(fn(b, a) if swap else fn(a, b) for a, b in zip(self.v, ov))

    def __add__(self, o):
        return self._map(add, o)

    def __radd__(self, o):
        return self._map(add, o, swap=True)

    def __sub__(self, o):
        return self._map(sub, o)

    def __rsub__(self, o):
        return self._map(sub, o, swap=True)

    def __mul__(self, o):
        return self._map(mul, o)

    def __rmul__(self, o):
        return self._map(mul, o, swap=True)

    def __neg__(self):
        return Seeds(neg(a) for a in self.v)


# The C definition of keep(): an empty asm statement that the compiler
# must assume changes the value, so an expression of a kept value is not
# merged with the same expression of the original. No instruction results.
KEEP_SOURCE = """static __device__ __forceinline__ float mpt_keep(float v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+f"(v));
#endif
  return v;
}
"""


def keep(x: "Value") -> "Value":
    """The same value, opaque to the C compiler (``mpt_keep``, whose source
    is :data:`KEEP_SOURCE`), so that recomputing an expression of it is not
    folded back into the first computation: the emitter can trade a long
    live range for a few recomputed statements. Tensors, constants and
    each part of a Dual or Seeds pass through as they are."""
    if isinstance(x, Dual):
        return Dual(keep(x.p), keep(x.t))
    if isinstance(x, Seeds):
        return Seeds(keep(v) for v in x.v)
    if isinstance(x, CVar):
        return x.em.var(f"mpt_keep({x.name})", x)
    return x


def seed(x, j: int):
    """Seed ``j``'s value of a tangent: a constant (a folded 0) is every
    seed's."""
    return x.v[j] if isinstance(x, Seeds) else x


Value = Union[float, torch.Tensor, CVar, Dual, Seeds]


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
        return x.em.var(f"{c_name}({x.name})", x)
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
        return x.em.var(f"{c_literal(1.0)} / {x.name}", x)
    return 1.0 / x


def _clip_tangent(p: Value, t: Value, lo: float, hi: float) -> Value:
    """The tangent of ``clip(p)``: ``t`` strictly inside the finite bounds,
    ``0.5 t`` at a bound, 0 outside (and 0 for a NaN primal), the JVP of
    ``jnp.clip``."""
    if isinstance(t, Seeds):
        return Seeds(_clip_tangent(p, x, lo, hi) for x in t.v)
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
        return em.var(f"({inside}) ? {em.ref(t)} : (({at}) ? {half} : {c_literal(0.0)})", p, t)
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
    if lo == hi:
        # A bound of zero width (a torque limit of 0 gives [-0, 0]): every
        # number becomes the bound, as +0.0 where it is zero, and NaN stays
        # NaN. The general form gave -0.0 below -0.0 in C and whichever zero
        # torch.minimum picks in a tie.
        v = float(hi) + 0.0
        if is_const(x):
            return x if math.isnan(x) else v
        if isinstance(x, CVar):
            return x.em.var(f"({x.name} != {x.name} ? {x.name} : {c_literal(v)})", x)
        return torch.where(torch.isnan(x), x, x.new_tensor(v))
    if is_const(x):
        return float(np.clip(x, lo, hi))
    if isinstance(x, CVar):
        expr = x.name
        if math.isfinite(hi):
            expr = f"({x.name} > {c_literal(hi)} ? {c_literal(hi)} : {expr})"
        if math.isfinite(lo):
            expr = f"({x.name} < {c_literal(lo)} ? {c_literal(lo)} : {expr})"
        return x.em.var(expr, x)
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


def transform_inv_const(T: Transform) -> Transform:
    """Inverse of a constant transform (host-side folding)."""
    R, p = T
    Rt = mat_T(R)
    return Rt, [neg(x) for x in mat_vec(Rt, p)]


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


def _emit(arrays_in, scalars_in, arrays_out, body, preamble=()):
    """Run ``body`` once over CVars (see :func:`c_function`); returns the
    emitter, the C parameters, the head's lines and the stores as ``(array,
    index, value)``."""
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
            raise ValueError(f"output {a} has {len(vals)} values, not {size}")
        stores += [(a, i, v) for i, v in enumerate(vals)]
    return em, params, head, stores


def c_function(name: str, arrays_in, scalars_in, arrays_out, body, preamble=(), emitter=None):
    """The C source of ``static __device__ __forceinline__ void name(...)``
    that runs ``body`` once over CVars.

    ``arrays_in``: ``(name, size)`` of the ``const float`` array inputs;
    ``scalars_in``: names of the ``float`` scalar inputs; ``arrays_out``:
    ``(name, size)`` of the output arrays. ``preamble``: ``(decl, names)``
    pairs, a C parameter declaration and the CVars it defines through
    ``lines``, a function ``em -> (lines, {name: CVar})``. ``body`` takes
    the inputs as keyword arguments (lists of CVars for arrays, CVars for
    scalars, and the preamble's values) and returns one list of values per
    output array. Returns ``(source, statement count)``; ``emitter``, a
    list, receives the :class:`Emitter` (its statements' operands)."""
    em, params, head, outs = _emit(arrays_in, scalars_in, arrays_out, body, preamble)
    if emitter is not None:
        emitter.append(em)
    stores = [f"{a}[{i}] = {em.ref(v)};" for a, i, v in outs]
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


def chain_length(em: Emitter) -> int:
    """The longest chain of dependent statements of an emitter's body: each
    statement is one link after the longest chain among the statements it
    reads (its recorded operands); inputs and constants start no chain."""
    depth: Dict[str, int] = {}
    for i, reads in enumerate(em.operands):
        depth[f"t{i}"] = 1 + max((depth[r] for r in reads if r in depth), default=0)
    return max(depth.values(), default=0)


# ---------------------------------------------------------------------------
# A body split over a team of warps
# ---------------------------------------------------------------------------
#
# The emitted body of a step is straight-line code with no two statements
# alike, so the lanes of a warp cannot share it: a team of W warps runs it
# instead, each warp its own straight-line program, while the lanes carry
# independent problems (scenarios, line-search alphas). The statements are
# partitioned into W warp programs over P phases, a barrier of the team
# between phases. A statement reads values that its own warp computed
# (earlier in the same phase or in an earlier one: registers), or values of
# another warp from an earlier phase, through a shared-memory slot (or the
# output the value was stored to). Every statement keeps its text, so each
# value keeps its bits.

# C helpers of a team step: its barrier and the asynchronous copies with
# which a kernel brings the next step's rows in. On the host
# (MPT_HOST_TEAM) the barrier hands over to the team's next thread (the
# harness runs each thread as a coroutine, in thread order between
# barriers) and a copy is a plain guarded copy.
TEAM_SOURCE = """#ifndef MPT_TEAM_SOURCE
#define MPT_TEAM_SOURCE
#if defined(MPT_HOST_TEAM)
extern "C" void mpt_host_yield(void);
#endif
// Barrier `bar` (1..15) of one team of `threads` threads, whole warps.
static __device__ __forceinline__ void mpt_team_sync(int bar, int threads) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;" :: "r"(bar), "r"(threads) : "memory");
#elif defined(MPT_HOST_TEAM)
  (void)bar;
  (void)threads;
  mpt_host_yield();
#endif
}
// One float from global to shared memory, zero where not `ok`; on the card
// cp.async, completed by mpt_team_wait_all after mpt_team_commit.
static __device__ __forceinline__ void mpt_team_copy(float* dst, const float* src, bool ok) {
#if defined(__CUDA_ARCH__)
  const unsigned int to = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n"
               :: "r"(to), "l"(src), "r"(ok ? 4 : 0) : "memory");
#else
  *dst = ok ? *src : 0.0f;
#endif
}
// Four floats (16 aligned bytes) likewise.
static __device__ __forceinline__ void mpt_team_copy4(float* dst, const float* src, bool ok) {
#if defined(__CUDA_ARCH__)
  const unsigned int to = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"
               :: "r"(to), "l"(src), "r"(ok ? 16 : 0) : "memory");
#else
  for (int i = 0; i < 4; ++i) dst[i] = ok ? src[i] : 0.0f;
#endif
}
static __device__ __forceinline__ void mpt_team_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
#endif
}
static __device__ __forceinline__ void mpt_team_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
#endif
}
#endif
"""

# The partitioner's cost model, in issue slots of one warp: a statement
# costs 1, a clamp 3, a division 12, a square root 10, a sine or cosine 24
# (libdevice's sinf/cosf), and its result is ready TEAM_LATENCY later; a
# barrier costs TEAM_BARRIER. The partition is a list schedule of each phase
# under a budget of issue slots a warp, and the budget (TEAM_BUDGETS) is the
# one whose estimate (each phase's latest finish, plus its barrier) is least.
TEAM_LATENCY, TEAM_BARRIER, TEAM_SLACK = 4, 20, 60
TEAM_BUDGETS = (40, 60, 80, 120, 180, 300, 10**9)


def _cost(expr: str) -> int:
    if "sinf(" in expr or "cosf(" in expr:
        return 24
    if "sqrtf(" in expr:
        return 10
    if " / " in expr:
        return 12
    return 3 if "?" in expr else 1


@dataclasses.dataclass(frozen=True)
class TeamPartition:
    """Statement i runs on warp ``place[i][1]`` in phase ``place[i][0]``."""

    warps: int
    phases: int
    place: Tuple[Tuple[int, int], ...]
    estimate: int  # the cost model's time of one step, in issue slots

    @property
    def critical(self) -> int:
        """The team's critical length: over the phases, the sum of the
        largest warp's statement count."""
        count = [[0] * self.warps for _ in range(self.phases)]
        for p, w in self.place:
            count[p][w] += 1
        return sum(max(row) for row in count)


def _graph(em: Emitter):
    index = {f"t{i}": i for i in range(len(em.lines))}
    preds = [sorted({index[r] for r in reads if r in index}) for reads in em.operands]
    succs: List[List[int]] = [[] for _ in preds]
    for i, ps in enumerate(preds):
        for u in ps:
            succs[u].append(i)
    return preds, succs


def _schedule(preds, succs, cost, warps: int, budget: int):
    """Phase by phase: the warp that is least far on takes the most urgent
    statement it may run (highest path of latency to the end), preferring
    one whose operands it holds unless another is more urgent by
    TEAM_SLACK. A statement whose operands of this phase lie on two warps
    waits for the next phase."""
    N = len(preds)
    lat = [c + TEAM_LATENCY for c in cost]
    urgency = [0] * N
    for i in range(N - 1, -1, -1):
        urgency[i] = lat[i] + max((urgency[s] for s in succs[i]), default=0)
    phase, warp, finish = [-1] * N, [-1] * N, [0] * N
    waiting = [len(ps) for ps in preds]
    shared: list = []
    home: List[list] = [[] for _ in range(warps)]

    def release(i):  # i may run on any warp from the next phase on
        heapq.heappush(shared, (-urgency[i], i))
        ws = [warp[u] for u in preds[i]]
        if ws:
            heapq.heappush(home[max(set(ws), key=ws.count)], (-urgency[i], i))

    def top(h):
        while h and phase[h[0][1]] >= 0:
            heapq.heappop(h)
        return h[0] if h else None

    for i in range(N):
        if not waiting[i]:
            release(i)
    placed, p, estimate = 0, 0, 0
    while placed < N:
        clock, done = [0] * warps, [False] * warps
        bound: List[list] = [[] for _ in range(warps)]
        deferred, seen = [], [set() for _ in range(warps)]
        latest = 0
        while True:
            w = min((v for v in range(warps) if not done[v]), key=lambda v: clock[v], default=None)
            if w is None:
                break
            if clock[w] >= budget:
                done[w] = True
                continue
            own = [c for c in (top(bound[w]), top(home[w])) if c is not None]
            pick = min(own) if own else None
            other = top(shared)
            if other is not None and (pick is None or -other[0] > -pick[0] + TEAM_SLACK):
                pick = other
            if pick is None:
                done[w] = True
                continue
            i = pick[1]
            start = clock[w]
            for u in preds[i]:
                if phase[u] == p:
                    start = max(start, finish[u])
                elif warp[u] != w and u not in seen[w]:
                    seen[w].add(u)  # one load from shared memory
                    clock[w] += 1
                    start = max(start, clock[w])
            phase[i], warp[i] = p, w
            finish[i], clock[w] = start + lat[i], start + cost[i]
            latest = max(latest, finish[i])
            placed += 1
            for s in succs[i]:
                waiting[s] -= 1
                if not waiting[s]:
                    ws = {warp[u] for u in preds[s] if phase[u] == p}
                    if len(ws) == 1:
                        heapq.heappush(bound[ws.pop()], (-urgency[s], s))
                    else:
                        deferred.append(s)
        for s in deferred:
            release(s)
        for w in range(warps):
            for _, s in bound[w]:
                if phase[s] < 0:
                    release(s)
        estimate += latest + TEAM_BARRIER
        p += 1
    return tuple(zip(phase, warp)), p, estimate


_PARTITIONS: Dict[Tuple[str, int], TeamPartition] = {}


def partition_team(em: Emitter, warps: int) -> TeamPartition:
    """Partition the emitter's statements into ``warps`` warp programs over
    phases (see :func:`_schedule`), the budget chosen by the cost model.
    Cached by the body's text."""
    key = (hashlib.sha256("\n".join(em.lines).encode()).hexdigest(), warps)
    if key not in _PARTITIONS:
        preds, succs = _graph(em)
        cost = [_cost(e) for e in em.exprs]
        best = None
        for budget in TEAM_BUDGETS if warps > 1 else (10**9,):
            place, phases, estimate = _schedule(preds, succs, cost, warps, budget)
            if best is None or estimate < best.estimate:
                best = TeamPartition(warps, phases, place, estimate)
        _PARTITIONS[key] = best
    return _PARTITIONS[key]


@dataclasses.dataclass(frozen=True)
class TeamStep:
    """The C source of a body split over a team (:func:`team_function`) and
    what the tests and the kernel table read of it."""

    source: str
    partition: TeamPartition
    statements: int
    reads: Tuple[Tuple[int, ...], ...]  # the statements each statement reads
    slots: int  # shared-memory slots a lane (the most live at once)
    # Per value that another warp reads: (statement, its slot or -1 where it
    # is read from the output it was stored to, phase written, ((warp,
    # phase) of each other warp's first read, ...)).
    crossings: Tuple[Tuple[int, int, int, Tuple[Tuple[int, int], ...]], ...]
    chain: int  # longest chain of dependent statements


def team_function(prefix: str, arrays_in, scalars_in, arrays_out, body, layout, warps: int) -> TeamStep:
    """``body`` (as for :func:`c_function`) split over a team of ``warps``
    warps: one ``static __device__`` function ``{prefix}_w{w}`` per warp
    that runs its statements of every phase with ``mpt_team_sync(bar,
    32 * warps)`` between phases (P - 1 barriers: the caller meets after
    the last phase), and ``{prefix}(w, bar, ...)`` that calls warp w's.

    ``layout`` places the inputs and outputs in shared memory: ``{array:
    (pointer, offset, stride)}`` for each input array (element i at
    ``pointer[(offset + i) * stride]``, ``stride`` a C expression) and
    ``{array: (pointer, offset)}`` for each output (stride ``MPT_TS``); the
    slots are ``sl[k * MPT_TS]``. The pointers, already at the lane's own
    column, are the functions' parameters after ``bar``, in the order of
    ``layout``, then ``sl``, then the scalar inputs. A warp reads an input
    or another warp's value once, at its first use, and keeps it; a slot is
    reused once every warp that reads its value has done so (interval
    colouring over the phases). Also defines ``{PREFIX}_W``, ``_P`` and
    ``_SLOTS``."""
    em, _, _, outs = _emit(arrays_in, scalars_in, arrays_out, body)
    part = partition_team(em, warps)
    N, P = len(em.lines), part.phases
    preds, _ = _graph(em)
    index = {f"t{i}": i for i in range(N)}
    inputs = {f"{a}_{i}": (a, i) for a, size in arrays_in for i in range(size)}
    # Where each output is stored: (warp, phase) and C location.
    store_at: Dict[Tuple[int, int], List[Tuple[str, str]]] = {}
    home_of: Dict[int, str] = {}  # statement -> the output location that holds it
    for a, i, v in outs:
        ptr, off = layout[a]
        loc = f"{ptr}[{off + i} * MPT_TS]"
        if isinstance(v, CVar) and v.name in index:
            k = index[v.name]
            home_of.setdefault(k, loc)
            store_at.setdefault((part.place[k][1], part.place[k][0]), []).append((loc, v.name))
        else:
            store_at.setdefault((0, 0), []).append((loc, em.ref(v)))
    # First read of each value by each other warp.
    first: Dict[Tuple[int, int], int] = {}
    for i, ps in enumerate(preds):
        p, w = part.place[i]
        for u in ps:
            if part.place[u][1] != w:
                first[(u, w)] = min(first.get((u, w), P), p)
    readers: Dict[int, List[Tuple[int, int]]] = {}
    for (u, w), p in sorted(first.items()):
        readers.setdefault(u, []).append((w, p))
    # Slots: values without an output location, interval [written, last first read].
    slot: Dict[int, int] = {}
    free: list = []  # (last read phase, slot)
    nslots = 0
    for u in sorted((u for u in readers if u not in home_of), key=lambda u: (part.place[u][0], u)):
        start, end = part.place[u][0], max(p for _, p in readers[u])
        if free and free[0][0] < start:
            _, k = heapq.heappop(free)
        else:
            k, nslots = nslots, nslots + 1
        slot[u] = k
        heapq.heappush(free, (end, k))
    crossings = tuple((u, slot.get(u, -1), part.place[u][0], tuple(readers[u])) for u in sorted(readers))
    # Per warp and phase, its statements in program order.
    program: List[List[List[int]]] = [[[] for _ in range(P)] for _ in range(warps)]
    for i, (p, w) in enumerate(part.place):
        program[w][p].append(i)
    pointers = list(dict.fromkeys([layout[a][0] for a, _ in arrays_in] + [layout[a][0] for a, _ in arrays_out]))
    out_ptrs = {layout[a][0] for a, _ in arrays_out}
    params = ["int bar"] + [
        f"float* {ptr}" if ptr in out_ptrs else f"const float* __restrict__ {ptr}" for ptr in pointers
    ] + ["float* sl"] + [f"float {sc}" for sc in scalars_in]
    args = ", ".join(["bar"] + pointers + ["sl"] + list(scalars_in))
    macro = prefix.upper()
    text = [f"#define {macro}_W {warps}\n#define {macro}_P {P}\n#define {macro}_SLOTS {max(nslots, 1)}\n"]
    for w in range(warps):
        lines, have = [], set(scalars_in)

        def read(r):  # an input's or another warp's value, at its first use
            if r in have:
                return
            have.add(r)
            if r in inputs:
                a, e = inputs[r]
                ptr, off, stride = layout[a]
                lines.append(f"const float {r} = {ptr}[{off + e} * {stride}];")
            elif r in index and part.place[index[r]][1] != w:
                u = index[r]
                lines.append(f"const float {r} = {home_of.get(u, f'sl[{slot.get(u)} * MPT_TS]')};")

        for p in range(P):
            lines.append(f"// phase {p}")
            for i in program[w][p]:
                for r in em.operands[i]:
                    read(r)
                lines.append(em.lines[i])
                have.add(f"t{i}")
            for i in program[w][p]:
                if i in slot:
                    lines.append(f"sl[{slot[i]} * MPT_TS] = t{i};")
            for loc, ref in store_at.get((w, p), []):
                read(ref)
                lines.append(f"{loc} = {ref};")
            if p + 1 < P:
                lines.append(f"mpt_team_sync(bar, {32 * warps});")
        text.append(
            f"static __device__ __forceinline__ void {prefix}_w{w}(\n    " + ", ".join(params) + ") {\n"
            + "\n".join("  " + line for line in lines) + "\n}\n"
        )
    cases = "\n".join(f"    case {w}: {prefix}_w{w}({args}); break;" for w in range(warps))
    text.append(
        f"// Warp w of the team runs its program of the step.\n"
        f"static __device__ __forceinline__ void {prefix}(\n    int w, " + ", ".join(params)
        + f") {{\n  switch (w) {{\n{cases}\n  }}\n}}\n"
    )
    return TeamStep("".join(text), part, N, tuple(map(tuple, preds)), nslots, crossings, chain_length(em))
