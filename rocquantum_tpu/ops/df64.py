"""Double-float (df64) simulation: f64-grade accuracy from paired f32 planes.

Each f64 plane is carried as a **hi/lo float32 pair** (a "double-float"),
and every multiply-add runs compensated arithmetic:

    x  =  hi + lo,   |lo| <= ulp(hi)/2    (~49-bit effective mantissa)

Error-free transformations (two-sum, two-prod) keep each gate's arithmetic
exact to ~2^-48 relative — end-to-end circuit error vs exact f64 is
~1e-13..1e-14, versus ~1e-7 for plain f32. Accuracy contract: **~1e-14
per-op**, not the pair engine's exact 2^-53.

Design rules (same discipline as pairsim, adapted to df64):
  * gates are strictly FLAT roll+mask XOR-diagonal passes over four f32
    planes (re_hi, re_lo, im_hi, im_lo) — rolls/selects are pure data
    movement (exact), the combine is compensated;
  * REDUCTIONS (norms, expectations, collapse norms) first promote
    hi + lo -> one flat f64 array, so every scalar this module returns is
    exact-f64 grade;
  * coefficients are split hi/lo at f64 precision (host numpy for concrete
    params, device f64 scalar math for traced params — requires
    ``jax_enable_x64``, which ``set_precision`` turns on).

Reference parity: this is the rebuild's answer to the reference's
``ROCQ_PRECISION_DOUBLE`` regime (rocquantum/include/rocquantum/
hipStateVec.h:7-15): the same real-FMA-pair kernel shape as
single_qubit_kernels.hip:49-71, with each f64 FMA expanded into its
compensated-f32 equivalent.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import config


def _require_x64():
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "the df64 engine needs jax_enable_x64 for its (scalar) "
            "coefficient splits and (flat) f64 reductions — call "
            "rocquantum_tpu.set_precision('double') or "
            "jax.config.update('jax_enable_x64', True) first")


# ---------------------------------------------------------------------------
# Error-free transformations (f32 values, f64 error terms)
# ---------------------------------------------------------------------------
# The pure-f32 formulations (Knuth two-sum, Dekker two-prod) hold only if
# the compiler never rewrites across statements: a backend that contracts
# ``s - a*b`` into an fma with the UNROUNDED product (XLA:CPU's LLVM does)
# silently destroys the compensation. So the error terms are computed
# through native f64 on every backend — exact by construction (24-bit
# operands), immune to contraction (an f64 fma of exact-in-f64 products is
# the same value), and cheaper than Dekker. On an H100 the f32 forms were
# in fact bit-exact; the 8e-8 norm drift a df64 circuit showed there came
# from the dropped f64 -> f32 -> f64 convert pair of the hi/lo split, which
# ``split_planes`` prevents (PERF.md, Findings).


def _f64(x):
    _require_x64()
    return jnp.asarray(x, jnp.float64)


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    return s, ((_f64(a) + _f64(b)) - _f64(s)).astype(jnp.float32)


def quick_two_sum(a, b):
    """two_sum; the classical |a| >= |b| precondition is not needed with
    f64 error terms."""
    return two_sum(a, b)


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b)."""
    p = a * b
    return p, (_f64(a) * _f64(b) - _f64(p)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# df64 arithmetic on (hi, lo) pairs
# ---------------------------------------------------------------------------

def df_add(x: Tuple, y: Tuple) -> Tuple:
    """IEEE-style accurate double-float add (Knuth/QD "ieee_add", 20 flops):
    robust under cancellation, unlike the 11-flop sloppy add."""
    s, e = two_sum(x[0], y[0])
    t, f = two_sum(x[1], y[1])
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return quick_two_sum(s, e)


def df_neg(x: Tuple) -> Tuple:
    return -x[0], -x[1]

def df_sub(x: Tuple, y: Tuple) -> Tuple:
    return df_add(x, df_neg(y))


def df_mul(x: Tuple, y: Tuple) -> Tuple:
    """Double-float product (QD mul): exact two_prod of the hi parts plus
    the two cross terms (the lo*lo term is below the result ulp)."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def df_select(mask, x: Tuple, y: Tuple) -> Tuple:
    """Elementwise mask-select (pure movement, exact)."""
    return jnp.where(mask, x[0], y[0]), jnp.where(mask, x[1], y[1])


# ---------------------------------------------------------------------------
# Scalar coefficient splits
# ---------------------------------------------------------------------------

def split_f64_host(v) -> Tuple[float, float]:
    """An f64 Python/numpy scalar as an exact (hi, lo) pair of
    f32-representable Python floats (host math; no x64 needed)."""
    v = np.float64(v)
    hi = np.float32(v)
    lo = np.float32(v - np.float64(hi))
    return float(hi), float(lo)


def split_f64(v):
    """A (possibly traced) f64 value as an exact (hi, lo) f32 pair."""
    if isinstance(v, (float, int, np.floating, np.integer)):
        return split_f64_host(v)
    return split_planes(jnp.asarray(v, jnp.float64))


def split_planes(x: jnp.ndarray):
    """An f64 array as an exact (hi, lo) f32 pair.

    The hi part is rounded by ``reduce_precision`` while still f64: a plain
    f64 -> f32 -> f64 round trip is a convert pair XLA drops when it allows
    excess precision (its default on the GPU), which made every lo plane
    zero and left df64 circuits at f32 accuracy on an H100 (PERF.md,
    Findings)."""
    hi64 = jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=23)
    return hi64.astype(jnp.float32), (x - hi64).astype(jnp.float32)


def _split_rows(rows):
    """Nested scalar rows (pairsim.op_rows_targets output) -> rows of
    (hi, lo) pairs. ``None`` (real matrix marker) passes through."""
    if rows is None:
        return None
    return [[split_f64(v) for v in row] for row in rows]


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------
# A df64 statevector is four flat f32 planes: (re_hi, re_lo, im_hi, im_lo).

def init_df64(n: int):
    """|0...0> as four f32 planes (four DISTINCT buffers — compiled df64
    programs donate all four, and donation rejects aliased arguments)."""
    from .statevec import one_hot
    return (one_hot(1 << n, 0, jnp.float32),
            jnp.zeros((1 << n,), jnp.float32),
            jnp.zeros((1 << n,), jnp.float32),
            jnp.zeros((1 << n,), jnp.float32))


def promote_f64(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    """The exact f64 value hi + lo (flat f64 elementwise: exact on this
    stack). Every reduction in this module starts here."""
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def state_to_pair_f64(state):
    """df64 state -> the exact-f64 (re, im) pair (pairsim-compatible)."""
    rh, rl, ih, il = state
    return promote_f64(rh, rl), promote_f64(ih, il)


def state_from_pair_f64(re: jnp.ndarray, im: jnp.ndarray):
    """Exact-f64 (re, im) pair -> df64 planes (correctly-rounded split)."""
    return split_planes(re) + split_planes(im)


# ---------------------------------------------------------------------------
# Gate application: flat roll+mask XOR-diagonal, compensated combine
# ---------------------------------------------------------------------------

def _apply_real_elementwise_df(hi, lo, mat_df, targets: Sequence[int]):
    """Apply a real 2^m x 2^m matrix (entries = (hi, lo) pairs) to one df64
    plane pair via the flat XOR-diagonal formulation (pairsim
    ._apply_real_elementwise with the arithmetic swapped for df64):
    out = sum_d partner_d(x) * coef_d, partner fetch = two rolls + a
    bit-mask select per plane (movement, exact), product/sum = df_mul/df_add.
    """
    n = hi.size.bit_length() - 1
    m = len(targets)
    iota = jax.lax.iota(jnp.int32, 1 << n)

    def bitmask(q):
        return ((iota >> q) & 1).astype(bool)

    tmasks = [bitmask(q) for q in targets]

    def partner(pair, q):
        s = 1 << q
        mask = bitmask(q)
        return (jnp.where(mask, jnp.roll(pair[0], s), jnp.roll(pair[0], -s)),
                jnp.where(mask, jnp.roll(pair[1], s), jnp.roll(pair[1], -s)))

    def _is_zero(e):
        return isinstance(e[0], float) and e[0] == 0.0 and e[1] == 0.0

    def coef(d):
        def rec(j, r):
            if j == m:
                return mat_df[r][r ^ d]
            hi_e = rec(j + 1, r | (1 << j))
            lo_e = rec(j + 1, r)
            if hi_e is lo_e:
                return hi_e
            return df_select(tmasks[j], hi_e, lo_e)
        return rec(0, 0)

    out = None
    for d in range(1 << m):
        if all(_is_zero(mat_df[r][r ^ d]) for r in range(1 << m)):
            continue  # structurally-zero XOR-diagonal
        term = (hi, lo)
        for j in range(m):
            if (d >> j) & 1:
                term = partner(term, targets[j])
        term = df_mul(term, coef(d))
        out = term if out is None else df_add(out, term)
    if out is None:
        out = jnp.zeros_like(hi), jnp.zeros_like(lo)
    return out


def apply_matrix_df64(state, m_re_df, m_im_df, targets: Sequence[int]):
    """Dense m-qubit matrix, entries pre-split into (hi, lo) pairs;
    ``m_im_df=None`` marks a REAL matrix (half the passes)."""
    rh, rl, ih, il = state
    a = _apply_real_elementwise_df(rh, rl, m_re_df, targets)
    b = _apply_real_elementwise_df(ih, il, m_re_df, targets)
    if m_im_df is None:
        return a[0], a[1], b[0], b[1]
    c = _apply_real_elementwise_df(ih, il, m_im_df, targets)
    d = _apply_real_elementwise_df(rh, rl, m_im_df, targets)
    re = df_sub(a, c)
    im = df_add(b, d)
    return re[0], re[1], im[0], im[1]


def _op_rows_df(op, params_resolved=None):
    """A CircuitIR GateOp -> (m_re_df, m_im_df|None, targets) with controls
    embedded — pairsim resolves the rows at f64, this splits them hi/lo."""
    from . import pairsim
    m_re, m_im, tgts = pairsim.op_rows_targets(
        op, params_resolved, dtype=jnp.float64)
    return _split_rows(m_re), _split_rows(m_im), tgts


def apply_op_df64(state, op, params_resolved: Sequence = None):
    """Apply one CircuitIR GateOp to the df64 state."""
    if op.name == "D2M":
        # two-qubit diagonal (interpreter._base_matrix D2M convention):
        # one flat masked multiply — comm-free at any qubit under sharding.
        m = np.asarray(op.matrix, np.complex128)
        if op.is_adjoint:
            m = np.conj(m)
        t0, t1 = op.targets
        rh = state[0]
        n = rh.size.bit_length() - 1
        iota = jax.lax.iota(jnp.int32, 1 << n)
        b0 = ((iota >> t0) & 1).astype(bool)
        b1 = ((iota >> t1) & 1).astype(bool)

        def sel(part):
            v = [[split_f64_host(getattr(m[i, j], part)) for j in range(2)]
                 for i in range(2)]
            return df_select(b0, df_select(b1, v[1][1], v[1][0]),
                             df_select(b1, v[0][1], v[0][0]))

        d_re = sel("real")
        re = (state[0], state[1])
        im = (state[2], state[3])
        if not np.any(m.imag):
            a, b = df_mul(re, d_re), df_mul(im, d_re)
            return a[0], a[1], b[0], b[1]
        d_im = sel("imag")
        new_re = df_sub(df_mul(re, d_re), df_mul(im, d_im))
        new_im = df_add(df_mul(re, d_im), df_mul(im, d_re))
        return new_re[0], new_re[1], new_im[0], new_im[1]
    m_re_df, m_im_df, tgts = _op_rows_df(op, params_resolved)
    return apply_matrix_df64(state, m_re_df, m_im_df, tgts)


# ---------------------------------------------------------------------------
# Reductions / measurement (promote -> exact flat f64)
# ---------------------------------------------------------------------------

def norm2_df64(state) -> jnp.ndarray:
    re, im = state_to_pair_f64(state)
    return jnp.sum(re * re + im * im)


def probs_df64(state) -> jnp.ndarray:
    """|amplitude|^2 as exact flat f64."""
    re, im = state_to_pair_f64(state)
    return re * re + im * im


def expval_pauli_product_z_df64(state, qubits: Sequence[int]):
    from .pairsim import expval_pauli_product_z_pair
    re, im = state_to_pair_f64(state)
    return expval_pauli_product_z_pair(re, im, qubits)


def expval_pauli_string_df64(state, ops: Sequence[tuple]):
    """<psi| P |psi>: Pauli applications stay in df64 (X/Y/Z entries are
    exactly representable), the overlap reduction promotes to f64."""
    zs = [q for ch, q in ops if ch == "Z"]
    if all(ch in ("I", "Z") for ch, _ in ops):
        return expval_pauli_product_z_df64(state, zs) if zs \
            else norm2_df64(state)
    one = (1.0, 0.0)
    zero = (0.0, 0.0)
    px = [[zero, one], [one, zero]]
    pz = [[one, zero], [zero, df_neg(one)]]
    py_im = [[zero, df_neg(one)], [one, zero]]
    cur = state
    for ch, q in ops:
        if ch == "I":
            continue
        if ch == "X":
            cur = apply_matrix_df64(cur, px, None, [q])
        elif ch == "Z":
            cur = apply_matrix_df64(cur, pz, None, [q])
        else:  # Y: purely imaginary matrix — parts swap with signs
            rh, rl, ih, il = cur
            a = _apply_real_elementwise_df(ih, il, py_im, [q])
            b = _apply_real_elementwise_df(rh, rl, py_im, [q])
            cur = -a[0], -a[1], b[0], b[1]
    re, im = state_to_pair_f64(state)
    pre, pim = state_to_pair_f64(cur)
    return jnp.sum(re * pre + im * pim)


def expval_terms_df64(state, terms, coeffs):
    """sum_k coeffs[k] * <P_k> (PauliOperator-style terms)."""
    total = jnp.zeros((), jnp.float64)
    for term, c in zip(terms, coeffs):
        if len(term) == 0:
            ev = norm2_df64(state)
        else:
            ev = expval_pauli_string_df64(state, term)
        total = total + jnp.asarray(c, jnp.float64) * ev
    return total


def prob_one_df64(state, qubit: int):
    from .pairsim import prob_one_pair
    re, im = state_to_pair_f64(state)
    return prob_one_pair(re, im, qubit)


def collapse_df64(state, qubit: int, outcome):
    """Project + renormalize: mask in df64 (movement), norm at exact f64,
    the inverse-norm scale re-split into an (hi, lo) coefficient."""
    rh, rl, ih, il = state
    n = rh.size.bit_length() - 1
    iota = jax.lax.iota(jnp.int32, 1 << n)
    keep = ((iota >> qubit) & 1) == jnp.asarray(outcome, jnp.int32)
    z = jnp.zeros((), jnp.float32)
    rh, rl = jnp.where(keep, rh, z), jnp.where(keep, rl, z)
    ih, il = jnp.where(keep, ih, z), jnp.where(keep, il, z)
    re, im = promote_f64(rh, rl), promote_f64(ih, il)
    norm = jnp.sqrt(jnp.sum(re * re + im * im))
    inv = 1.0 / jnp.maximum(norm, jnp.asarray(1e-12, jnp.float64))
    s = split_f64(inv)
    a = df_mul((rh, rl), s)
    b = df_mul((ih, il), s)
    return a[0], a[1], b[0], b[1]


def sample_df64(state, qubits: Sequence[int], shots: int, key):
    """Categorical draws over the marginal (bins feed draws, not state —
    the f32 view marginal is enough, exactly like pairsim.sample_pair)."""
    from .density import _diag_marginal
    rh, rl, ih, il = state
    n = rh.size.bit_length() - 1
    p32 = probs_df64(state).astype(jnp.float32)
    marg = _diag_marginal(p32, list(qubits), n)
    logits = jnp.log(jnp.maximum(marg, 1e-38))
    return jax.random.categorical(key, logits, shape=(shots,)).astype(
        jnp.int32)


# ---------------------------------------------------------------------------
# Compiled df64 programs (the Circuit.flush-shaped entry point)
# ---------------------------------------------------------------------------

from ..utils.cache import BoundedCache  # noqa: E402

_DF64_EXEC_CACHE = BoundedCache()


def compile_df64_ir(ir, sharding=None):
    """A jitted ``f(rh, rl, ih, il, params) -> state`` for a CircuitIR,
    cached by structural key (the df64 twin of pairsim.compile_pair_ir;
    params stay runtime inputs so executables are reused across parameter
    updates). With ``sharding`` (flat NamedSharding over the 'sv' axis, all
    four planes identical), SWAP_BITS relabels lower to the all-to-all
    and rolls touch only scheduled-local bits, exactly like the pair
    engine."""
    _require_x64()
    from ..compiler.ir import ParamRef
    baked = tuple(float(p) for op in ir.ops for p in op.params
                  if not isinstance(p, ParamRef))
    key = ("df64", ir.structural_key(), baked, sharding)
    fn = _DF64_EXEC_CACHE.get(key)
    if fn is not None:
        return fn
    from ..compiler.interpreter import _resolve_params
    from ..compiler.sharded_schedule import SWAP_BITS
    from . import statevec as sv
    ops = list(ir.ops)

    def run(rh, rl, ih, il, params):
        state = (rh, rl, ih, il)
        for op in ops:
            if op.name == SWAP_BITS:
                a, b = op.targets
                state = tuple(sv.swap_index_bits(p, a, b, use_transpose=True)
                              for p in state)
            elif op.name == "PERMUTE_BITS":
                d, s = ((op.controls, op.targets) if op.is_adjoint
                        else (op.targets, op.controls))
                state = tuple(sv.permute_index_bits(p, d, s)
                              for p in state)
            else:
                state = apply_op_df64(state, op, _resolve_params(op, params))
            if sharding is not None:
                state = tuple(jax.lax.with_sharding_constraint(p, sharding)
                              for p in state)
        return state

    fn = jax.jit(run, donate_argnums=(0, 1, 2, 3))
    _DF64_EXEC_CACHE[key] = fn
    return fn
