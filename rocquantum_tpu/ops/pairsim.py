"""Float-pair simulation: the complex state as (re, im) REAL arrays.

This module runs the double-precision simulation in explicit real
arithmetic instead of complex128 (it was built for a backend without a
working complex128; ROADMAP Design 1 measures native complex128 against it
on the GPU before either goes): a gate is

    re' = M_re @ re - M_im @ im      im' = M_re @ im + M_im @ re

where each ``@`` is a strictly FLAT roll+mask formulation (no dot/einsum
and no multi-dimensional f64 view; see _apply_real_elementwise). Real
matrices skip the two
``M_im`` passes. This is also what
the reference's ``ROCQ_PRECISION_DOUBLE`` kernels ultimately execute:
explicit real FMA pairs (hipStateVec.h:7-15, single_qubit_kernels.hip:49-71).

Works at any real dtype; defaults to ``config.real_dtype()`` (f64 when
``set_precision("double")`` is active — the intended use).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from . import gates as G



def init_pair(n: int, dtype=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """|0...0> as a float pair."""
    dt = dtype or config.real_dtype()
    from .statevec import one_hot
    re = one_hot(1 << n, 0, dt)
    return re, jnp.zeros((1 << n,), dt)


def _controlled_rows(m_re, m_im, m: int, c: int):
    """Embed 2^m x 2^m gate-part SCALAR ROWS into the 2^(m+c) controlled
    matrix (controls = HIGH matrix-index bits): identity everywhere except
    the all-controls-one block. Rows stay nested Python lists of
    scalars."""
    dim = 1 << (m + c)
    sub = 1 << m
    full_re = [[1.0 if i == j else 0.0 for j in range(dim)]
               for i in range(dim)]
    full_im = None if m_im is None else         [[0.0] * dim for _ in range(dim)]
    for i in range(sub):
        for j in range(sub):
            full_re[dim - sub + i][dim - sub + j] = m_re[i][j]
            if m_im is not None:
                full_im[dim - sub + i][dim - sub + j] = m_im[i][j]
    return full_re, full_im


def _apply_real_elementwise(vec: jnp.ndarray, mat,
                            targets: Sequence[int]) -> jnp.ndarray:
    """Apply a real 2^m x 2^m matrix to a real vector via flat roll+mask
    arithmetic, never einsum/dot_general; m is small (<=4)."""
    n = vec.size.bit_length() - 1
    m = len(targets)
    # STRICTLY FLAT 1-D formulation (no size-2 axis views, no f64 axis
    # reductions): the partner amplitude x[idx ^ 2^q] is two flat rolls + a bit-mask
    # select, and  out = sum_d partner_d(x) * coef_d  with coef_d the
    # mask-selected XOR-diagonal mat[r, r ^ d] — pure fused 1-D math.
    x = vec
    iota = jax.lax.iota(jnp.int32, 1 << n)

    def bitmask(q):
        return ((iota >> q) & 1).astype(bool)

    def partner(arr, q):
        s = 1 << q
        return jnp.where(bitmask(q), jnp.roll(arr, s),
                         jnp.roll(arr, -s))

    tmasks = [bitmask(q) for q in targets]

    def coef(d):
        # nested mask-select over the target bits: value mat[r][r ^ d]
        def rec(j, r):
            if j == m:
                return mat[r][r ^ d]
            return jnp.where(tmasks[j], rec(j + 1, r | (1 << j)),
                             rec(j + 1, r))
        return rec(0, 0)

    out = None
    for d in range(1 << m):
        if all(isinstance(mat[r][r ^ d], float) and mat[r][r ^ d] == 0.0
               for r in range(1 << m)):
            continue  # structurally-zero XOR-diagonal (e.g. diagonal gates)
        term = x
        for j in range(m):
            if (d >> j) & 1:
                term = partner(term, targets[j])
        term = term * coef(d)
        out = term if out is None else out + term
    if out is None:
        out = jnp.zeros_like(x)
    return out.reshape(vec.shape)


def apply_matrix_pair(re: jnp.ndarray, im: jnp.ndarray,
                      m_re: jnp.ndarray, m_im: Optional[jnp.ndarray],
                      targets: Sequence[int]):
    """Dense m-qubit matrix given as (re, im) parts; ``m_im=None`` marks a
    REAL matrix (half the passes — RY/X/H/CNOT territory)."""
    a = _apply_real_elementwise(re, m_re, targets)
    b = _apply_real_elementwise(im, m_re, targets)
    if m_im is None:
        return a, b
    c = _apply_real_elementwise(im, m_im, targets)
    d = _apply_real_elementwise(re, m_im, targets)
    return a - c, b + d


def _rows_from_numpy(mh):
    """Nested scalar rows (re, im|None) from a host complex matrix —
    Python floats, never a device array (see _controlled_rows)."""
    dim = mh.shape[0]
    re_rows = [[float(mh[i, j].real) for j in range(dim)]
               for i in range(dim)]
    # EXACTLY zero, not allclose: this engine's contract is f64 accuracy,
    # and a numerically-constructed unitary with ~1e-9 imaginary parts
    # must keep them (dropping them injects invisible 1e-9 errors)
    if not np.any(np.imag(mh)):
        return re_rows, None
    im_rows = [[float(mh[i, j].imag) for j in range(dim)]
               for i in range(dim)]
    return re_rows, im_rows


# ---------------------------------------------------------------------------
# Accurate f64 trig for traced scalars
# ---------------------------------------------------------------------------
# Scalar trig routes through a (64,) array whose other 63 elements carry
# tiny DISTINCT offsets — XLA cannot hoist the op back to a scalar through
# a uniform broadcast — and element 0 (offset exactly 0.0) is extracted:
# the returned value IS the array computation of the input, bit-for-bit.
# An earlier backend computed traced scalar f64 trig at f32 accuracy;
# ROADMAP Design 4 lists this decoy for removal once the GPU shows it
# unneeded.

_DECOY_NP = np.arange(64, dtype=np.float64) * 2.0 ** -60


def acc_cos_sin_f64(x, add=None, half=False):
    """(cos, sin) of ``x`` (+ ``add``, / 2 if ``half``) at true f64
    accuracy, for host or traced scalars (see note above). All sensitive
    arithmetic (the optional add, the halving, the trig) happens in
    (64,)-array form; only exact movement extracts the scalar."""
    if isinstance(x, (int, float, np.floating, np.integer)) and (
            add is None or isinstance(add, (int, float, np.floating,
                                            np.integer))):
        v = np.float64(x) + (np.float64(add) if add is not None else 0.0)
        if half:
            v = v * 0.5
        return np.float64(np.cos(v)), np.float64(np.sin(v))
    v = jnp.asarray(x, jnp.float64) + jnp.asarray(_DECOY_NP)
    if add is not None:
        v = v + jnp.asarray(add, jnp.float64)
    if half:
        v = v * 0.5
    return jnp.cos(v)[0], jnp.sin(v)[0]


def _is_f64(dt) -> bool:
    return jnp.dtype(dt) == jnp.dtype(jnp.float64)


def _trig_half(theta, dt):
    if _is_f64(dt):
        return acc_cos_sin_f64(theta, half=True)
    theta = jnp.asarray(theta, dt)
    return jnp.cos(theta / 2), jnp.sin(theta / 2)


def _ry_rows(theta, dtype=None):
    c, s = _trig_half(theta, dtype or config.real_dtype())
    return [[c, -s], [s, c]], None


def _rx_rows(theta, dtype=None):
    c, s = _trig_half(theta, dtype or config.real_dtype())
    return [[c, 0.0], [0.0, c]], [[0.0, -s], [-s, 0.0]]


def _rz_rows(theta, dtype=None):
    c, s = _trig_half(theta, dtype or config.real_dtype())
    return [[c, 0.0], [0.0, c]], [[-s, 0.0], [0.0, s]]


def _p_rows(lam, dtype=None):
    dt = dtype or config.real_dtype()
    if _is_f64(dt):
        c, s = acc_cos_sin_f64(lam)
    else:
        lam = jnp.asarray(lam, dt)
        c, s = jnp.cos(lam), jnp.sin(lam)
    return ([[1.0, 0.0], [0.0, c]],
            [[0.0, 0.0], [0.0, s]])


def _rzz_rows(theta, dtype=None):
    c, s = _trig_half(theta, dtype or config.real_dtype())
    re = [[0.0] * 4 for _ in range(4)]
    im = [[0.0] * 4 for _ in range(4)]
    for k, sg in enumerate((-1.0, 1.0, 1.0, -1.0)):
        re[k][k] = c
        im[k][k] = sg * s
    return re, im


def _u3_rows(theta, phi, lam, dtype=None):
    dt = dtype or config.real_dtype()
    if _is_f64(dt):
        # accurate-array trig for every angle (incl. phi+lam, summed in
        # array form); the entry PRODUCTS below remain scalar f64 muls
        c, s = acc_cos_sin_f64(theta, half=True)
        cl, sl = acc_cos_sin_f64(lam)
        cp, sp = acc_cos_sin_f64(phi)
        cpl, spl = acc_cos_sin_f64(phi, add=lam)
    else:
        theta = jnp.asarray(theta, dt)
        phi = jnp.asarray(phi, dt)
        lam = jnp.asarray(lam, dt)
        c, s = jnp.cos(theta / 2), jnp.sin(theta / 2)
        cl, sl = jnp.cos(lam), jnp.sin(lam)
        cp, sp = jnp.cos(phi), jnp.sin(phi)
        cpl, spl = jnp.cos(phi + lam), jnp.sin(phi + lam)
    re = [[c, -cl * s],
          [cp * s, cpl * c]]
    im = [[0.0, -sl * s],
          [sp * s, spl * c]]
    return re, im


_ROWS_BUILDERS = {"RX": _rx_rows, "RY": _ry_rows, "RZ": _rz_rows,
                  "P": _p_rows, "PHASE": _p_rows, "U3": _u3_rows,
                  "RZZ": _rzz_rows}


def gate_rows(name: str, params=(), dtype=None):
    """(re, im) SCALAR ROWS of a named gate's matrix; ``im`` is None for
    real matrices. Traced params supported (the energy-fn path).
    ``dtype`` overrides the row dtype for parameterized gates (the df64
    engine requests f64 rows regardless of the global precision)."""
    key = name.upper()
    if key in ("CNOT", "CX"):
        key = "X"
    if key in _ROWS_BUILDERS:
        return _ROWS_BUILDERS[key](*params, dtype=dtype)
    if key in G.FIXED:
        return _rows_from_numpy(np.asarray(G.FIXED[key]))
    raise ValueError(f"Unknown gate name: {name}")


def _rows_adjoint(m_re, m_im):
    dim = len(m_re)
    re_t = [[m_re[j][i] for j in range(dim)] for i in range(dim)]
    if m_im is None:
        return re_t, None
    im_t = [[-m_im[j][i] for j in range(dim)] for i in range(dim)]
    return re_t, im_t


def op_rows_targets(op, params_resolved: Sequence = None, dtype=None):
    """Resolve a CircuitIR GateOp to ``(m_re, m_im|None, targets)`` scalar
    rows with controls EMBEDDED (controls = high matrix-index bits appended
    to targets). ``params_resolved`` overrides ``op.params`` (already-
    resolved traced values). Implicitly-controlled names (CNOT/CZ/CRX/...
    /CSWAP, incl. the DSL form carrying the control in ``targets``)
    normalize exactly like the complex interpreter's _split_op."""
    from ..compiler.interpreter import _split_op
    base, ctrls, tgts0 = _split_op(op)
    if (base, tuple(ctrls), tuple(tgts0)) != \
            (op.name.upper(), tuple(op.controls), tuple(op.targets)):
        import dataclasses as _dc
        op = _dc.replace(op, name=base, targets=tuple(tgts0),
                         controls=tuple(ctrls))
    pvals = tuple(op.params) if params_resolved is None \
        else tuple(params_resolved)
    rdt = dtype or config.real_dtype()
    if op.matrix is not None:
        if isinstance(op.matrix, np.ndarray):
            m_re, m_im = _rows_from_numpy(
                np.asarray(op.matrix, np.complex128))
        else:  # traced matrix (adjoint-grad embeds tracers); entries
            # extracted as scalars — the array itself may already be
            # f32-rounded on this stack (fp32-path only)
            m = jnp.asarray(op.matrix)
            dim = m.shape[0]
            m_re = [[jnp.real(m[i, j]).astype(rdt)
                     for j in range(dim)] for i in range(dim)]
            m_im = [[jnp.imag(m[i, j]).astype(rdt)
                     for j in range(dim)] for i in range(dim)]
    else:
        m_re, m_im = gate_rows(op.name, pvals, dtype=dtype)
    if op.is_adjoint:
        m_re, m_im = _rows_adjoint(m_re, m_im)
    tgts = list(op.targets)
    if op.controls:
        m_re, m_im = _controlled_rows(m_re, m_im, len(tgts),
                                      len(op.controls))
        tgts = tgts + list(op.controls)
    return m_re, m_im, tgts


def apply_op_pair(re: jnp.ndarray, im: jnp.ndarray, op,
                  params_resolved: Sequence = None):
    """Apply one CircuitIR GateOp to the pair state."""
    if op.name == "D2M":
        # two-qubit DIAGONAL with packed values d[bit_t0, bit_t1]
        # (interpreter._base_matrix D2M convention): one exact flat
        # masked-multiply pass, comm-free at any qubit under sharding.
        # Entries stay PYTHON scalars (device-materialized small f64
        # arrays silently round to f32 on this stack).
        m = np.asarray(op.matrix, np.complex128)
        if op.is_adjoint:
            m = np.conj(m)
        t0, t1 = op.targets
        n = re.size.bit_length() - 1
        iota = jax.lax.iota(jnp.int32, 1 << n)
        b0 = ((iota >> t0) & 1).astype(bool)
        b1 = ((iota >> t1) & 1).astype(bool)

        def sel(part):
            vals = [[float(getattr(m[i, j], part)) for j in range(2)]
                    for i in range(2)]
            return jnp.where(b0, jnp.where(b1, vals[1][1], vals[1][0]),
                             jnp.where(b1, vals[0][1], vals[0][0]))

        d_re = sel("real")
        if not np.any(m.imag):
            return re * d_re, im * d_re
        d_im = sel("imag")
        return re * d_re - im * d_im, re * d_im + im * d_re
    m_re, m_im, tgts = op_rows_targets(op, params_resolved, dtype=re.dtype)
    return apply_matrix_pair(re, im, m_re, m_im, tgts)


def norm2_pair(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(re * re + im * im)


def expval_pauli_product_z_pair(re: jnp.ndarray, im: jnp.ndarray,
                                qubits: Sequence[int]) -> jnp.ndarray:
    """<Z...Z> on the pair state: parity-weighted probabilities via
    bit-mask sign flips, strictly FLAT (see _apply_real_elementwise)."""
    n = re.size.bit_length() - 1
    s = re * re + im * im
    iota = jax.lax.iota(jnp.int32, 1 << n)
    for q in sorted(set(int(q) for q in qubits)):
        s = jnp.where(((iota >> q) & 1).astype(bool), -s, s)
    return jnp.sum(s)


_PAULI_ROWS = {
    "X": ([[0.0, 1.0], [1.0, 0.0]], None),
    "Y": (None, [[0.0, -1.0], [1.0, 0.0]]),
    "Z": ([[1.0, 0.0], [0.0, -1.0]], None),
}


def expval_pauli_string_pair(re: jnp.ndarray, im: jnp.ndarray,
                             ops: Sequence[tuple]) -> jnp.ndarray:
    """<psi| P |psi> for a Pauli string [(char, qubit), ...]: apply P to a
    copy, then Re<psi|phi> = sum(re*phi_re + im*phi_im)."""
    zs = [q for ch, q in ops if ch == "Z"]
    if all(ch in ("I", "Z") for ch, _ in ops):
        return expval_pauli_product_z_pair(re, im, zs) if zs \
            else norm2_pair(re, im)
    pre, pim = re, im
    for ch, q in ops:
        if ch == "I":
            continue
        mr, mi = _PAULI_ROWS[ch]
        if mr is None:
            # purely imaginary matrix (Y): (re+i im)(i Mi) -> parts swap
            a = _apply_real_elementwise(pim, mi, [q])
            b = _apply_real_elementwise(pre, mi, [q])
            pre, pim = -a, b
        else:
            pre, pim = apply_matrix_pair(pre, pim, mr, mi, [q])
    return jnp.sum(re * pre + im * pim)


def expval_terms_pair(re: jnp.ndarray, im: jnp.ndarray, terms, coeffs):
    """Sum_k coeffs[k] * <P_k> for PauliOperator-style terms
    [((char, qubit), ...), ...]."""
    total = jnp.zeros((), re.dtype)
    for term, c in zip(terms, coeffs):
        if len(term) == 0:
            ev = norm2_pair(re, im)  # identity term
        else:
            ev = expval_pauli_string_pair(re, im, term)
        total = total + jnp.asarray(c, re.dtype) * ev
    return total


# ---------------------------------------------------------------------------
# Dynamics: measurement / collapse / sampling on the pair state
# ---------------------------------------------------------------------------
# Same discipline as gate application: strictly FLAT f64 arithmetic where
# the result feeds the STATE (collapse norms, single-qubit probabilities —
# flat elementwise + flat full reductions). Marginal histograms only feed sampling draws and
# host readback, so they downcast the exactly-computed |amp|^2 vector to
# f32 and use the ordinary view machinery (rocsvSample / rocsvMeasure
# semantics, hipStateVec.h:327+; measurement_kernels.hip:37-247).

def probs_pair(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """|amplitude|^2 vector — one exact flat f64 elementwise pass."""
    return re * re + im * im


def prob_one_pair(re: jnp.ndarray, im: jnp.ndarray, qubit: int):
    """P(qubit = 1): bit-masked flat reduction (exact in f64)."""
    n = re.size.bit_length() - 1
    iota = jax.lax.iota(jnp.int32, 1 << n)
    bit = ((iota >> qubit) & 1).astype(re.dtype)
    return jnp.sum((re * re + im * im) * bit)


def collapse_pair(re: jnp.ndarray, im: jnp.ndarray, qubit: int, outcome):
    """Project onto ``qubit = outcome`` (0/1, static or traced) and
    renormalize — flat mask + flat norm reduction, all exact f64."""
    n = re.size.bit_length() - 1
    iota = jax.lax.iota(jnp.int32, 1 << n)
    bit = (iota >> qubit) & 1
    keep = bit == jnp.asarray(outcome, jnp.int32)
    re = jnp.where(keep, re, jnp.zeros((), re.dtype))
    im = jnp.where(keep, im, jnp.zeros((), im.dtype))
    norm = jnp.sqrt(jnp.sum(re * re + im * im))
    inv = 1.0 / jnp.maximum(norm, jnp.asarray(config.eps(), norm.dtype))
    return re * inv, im * inv


def _marginal_view_f32(re: jnp.ndarray, im: jnp.ndarray,
                       qubits: Sequence[int]) -> jnp.ndarray:
    """Marginal via the ordinary axis-sum view machinery on the f32
    downcast of the exact |amp|^2 (f64 axis reductions are broken on this
    stack): histogram-bin grade, for sampling draws only."""
    from .density import _diag_marginal
    n = re.size.bit_length() - 1
    return _diag_marginal(probs_pair(re, im).astype(jnp.float32),
                          list(qubits), n)


# above this many outcomes the exact path's one-reduction-per-bin cost
# stops being worth it for anything but full-register reads
_EXACT_MARGINAL_BINS = 256


def marginal_probs_pair(re: jnp.ndarray, im: jnp.ndarray,
                        qubits: Sequence[int]) -> jnp.ndarray:
    """Marginal probability vector over ``qubits`` (qubits[0] = LSB of the
    outcome index, statevec.marginal_probs convention) at FULL f64
    accuracy where feasible: the full-register identity read is the exact
    |amp|^2 vector itself, and small marginals (<= 256 outcomes) use one
    exact flat masked f64 reduction per outcome. Larger partial marginals
    fall back to the f32 view path (they feed histograms, not state)."""
    qubits = list(qubits)
    n = re.size.bit_length() - 1
    k = len(qubits)
    if qubits == list(range(n)):
        return probs_pair(re, im)
    if (1 << k) <= _EXACT_MARGINAL_BINS:
        p64 = probs_pair(re, im)
        iota = jax.lax.iota(jnp.int32, 1 << n)
        zero = jnp.zeros((), p64.dtype)
        outs = []
        for out in range(1 << k):
            keep = None
            for j, q in enumerate(qubits):
                m = ((iota >> q) & 1) == ((out >> j) & 1)
                keep = m if keep is None else (keep & m)
            outs.append(jnp.sum(jnp.where(keep, p64, zero)))
        return jnp.stack(outs)
    return _marginal_view_f32(re, im, qubits)


def sample_pair(re: jnp.ndarray, im: jnp.ndarray, qubits: Sequence[int],
                shots: int, key) -> jnp.ndarray:
    """Draw ``shots`` outcomes from the marginal over ``qubits`` (Gumbel
    categorical, like statevec.sample). Bins feed draws, not state — the
    cheap f32 view marginal is enough."""
    marg = _marginal_view_f32(re, im, qubits)
    logits = jnp.log(jnp.maximum(marg, 1e-38))
    return jax.random.categorical(key, logits, shape=(shots,)).astype(
        jnp.int32)


def slice_pair(re: jnp.ndarray, im: jnp.ndarray, start: int, size: int):
    """(re, im) of amplitudes [start, start+size) — the
    rocsvGetStateVectorSlice analog on the pair state."""
    return (jax.lax.dynamic_slice(re, (start,), (size,)),
            jax.lax.dynamic_slice(im, (start,), (size,)))


# ---------------------------------------------------------------------------
# Batched (flat) fp64: batchSize WITHOUT leaving the strictly-flat forms
# ---------------------------------------------------------------------------
# The reference threads batchSize through every kernel including the fp64
# builds (hipStateVec.h:7-15,61). A (batch, 2^n) vmap would be the obvious
# JAX shape, but this engine keeps to strictly flat f64 forms (see
# _apply_real_elementwise) — so the batch index lives in extra TOP index bits of ONE flat state of
# b_pad * 2^n amplitudes (b_pad = b rounded up to a power of two; padded
# elements hold all-zero amplitudes, which every gate preserves):
#   * gates target qubits < n, so the flat roll+mask machinery above is
#     per-element automatically — compile_pair_ir programs run UNCHANGED;
#   * per-element reductions are b masked flat f64 sums (exact);
#   * histogram-grade marginals/draws downcast to f32 first, where 2-D
#     views are fine.

def _pad_batch(b: int) -> int:
    return 1 << max(b - 1, 0).bit_length()


def init_pair_batched(n: int, b: int, dtype=None):
    """|0...0>^b as ONE flat pair of b_pad * 2^n amplitudes."""
    dt = dtype or config.real_dtype()
    size = _pad_batch(b) << n
    if size >= (1 << 31):  # flat index math below is int32 iota
        raise ValueError(
            f"batched pair state of {size} amplitudes exceeds the int32 "
            f"index range (b={b} padded x 2^{n})")
    re = jnp.zeros((size,), dt).at[jnp.arange(b) << n].set(1.0)
    return re, jnp.zeros((size,), dt)


def _element_mask(re, n: int, k: int):
    iota = jax.lax.iota(jnp.int32, re.size)
    return (iota >> n) == k


def _per_element_sums(s, n: int, b: int):
    """(b,) of exact masked flat f64 sums — one reduction per element."""
    zero = jnp.zeros((), s.dtype)
    return jnp.stack([jnp.sum(jnp.where(_element_mask(s, n, k), s, zero))
                      for k in range(b)])


def prob_one_pair_batched(re, im, qubit: int, n: int, b: int):
    """Per-element P(qubit = 1) -> (b,)."""
    iota = jax.lax.iota(jnp.int32, re.size)
    bit = ((iota >> qubit) & 1).astype(bool)
    s = jnp.where(bit, re * re + im * im, jnp.zeros((), re.dtype))
    return _per_element_sums(s, n, b)


def collapse_pair_batched(re, im, qubit: int, outcomes, n: int, b: int):
    """Project element k onto ``qubit = outcomes[k]`` and renormalize each
    element — outcome lookup and the per-element inverse norms broadcast
    back as flat mask-weighted sums (exact f64 elementwise)."""
    iota = jax.lax.iota(jnp.int32, re.size)
    bit = (iota >> qubit) & 1
    want = jnp.asarray(outcomes, jnp.int32)[iota >> n]  # int gather: movement
    keep = bit == want
    re = jnp.where(keep, re, jnp.zeros((), re.dtype))
    im = jnp.where(keep, im, jnp.zeros((), im.dtype))
    s = re * re + im * im
    scale = jnp.zeros(re.shape, re.dtype)
    for k in range(b):
        m = _element_mask(re, n, k)
        norm = jnp.sqrt(jnp.sum(jnp.where(m, s, jnp.zeros((), s.dtype))))
        inv = 1.0 / jnp.maximum(norm, jnp.asarray(config.eps(), norm.dtype))
        scale = scale + jnp.where(m, inv, jnp.zeros((), re.dtype))
    # padded elements (k >= b) are all-zero: scale 0 keeps them zero
    return re * scale, im * scale


def expval_terms_pair_batched(re, im, terms, coeffs, n: int, b: int):
    """Per-element sum_k coeffs[k] * <P_k> -> (b,). Pauli applications are
    flat (targets < n, per-element by construction); only the final
    overlap reduction goes per-element."""
    total = jnp.zeros((b,), re.dtype)
    for term, c in zip(terms, coeffs):
        zs = [q for ch, q in term if ch == "Z"]
        if len(term) == 0 or all(ch in ("I", "Z") for ch, _ in term):
            s = re * re + im * im
            iota = jax.lax.iota(jnp.int32, re.size)
            for q in sorted(set(int(q) for q in zs)):
                s = jnp.where(((iota >> q) & 1).astype(bool), -s, s)
            ev = _per_element_sums(s, n, b)
        else:
            pre, pim = re, im
            for ch, q in term:
                if ch == "I":
                    continue
                mr, mi = _PAULI_ROWS[ch]
                if mr is None:
                    a = _apply_real_elementwise(pim, mi, [q])
                    bb = _apply_real_elementwise(pre, mi, [q])
                    pre, pim = -a, bb
                else:
                    pre, pim = apply_matrix_pair(pre, pim, mr, mi, [q])
            ev = _per_element_sums(re * pre + im * pim, n, b)
        total = total + jnp.asarray(c, re.dtype) * ev
    return total


def _probs_f32_rows(re, im, n: int, b: int):
    """(b, 2^n) f32 |amp|^2 rows: exact flat f64 squares, THEN the f32
    downcast and the (movement-only) reshape."""
    p = (re * re + im * im).astype(jnp.float32)
    return p.reshape(-1, 1 << n)[:b]


def marginal_probs_pair_batched(re, im, qubits, n: int, b: int):
    """Per-element marginals -> (b, 2^len(qubits)) at FULL f64 accuracy
    where feasible (same contract as the unbatched twin): the
    full-register read is the exact |amp|^2 itself (reshape is pure
    movement), small marginals use one exact masked flat f64 reduction per
    (element, outcome) — bounded by the same _EXACT_MARGINAL_BINS total so
    program size stays flat — and larger partials ride the f32 view
    machinery (they feed histograms, not state)."""
    qubits = list(qubits)
    k = len(qubits)
    if qubits == list(range(n)):
        return (re * re + im * im).reshape(-1, 1 << n)[:b]
    if b << k <= _EXACT_MARGINAL_BINS:
        p64 = re * re + im * im
        iota = jax.lax.iota(jnp.int32, re.size)
        zero = jnp.zeros((), p64.dtype)
        rows = []
        for el in range(b):
            el_mask = _element_mask(re, n, el)
            outs = []
            for out in range(1 << k):
                keep = el_mask
                for j, q in enumerate(qubits):
                    keep = keep & (((iota >> q) & 1) == ((out >> j) & 1))
                outs.append(jnp.sum(jnp.where(keep, p64, zero)))
            rows.append(jnp.stack(outs))
        return jnp.stack(rows)
    from .density import _diag_marginal
    rows = _probs_f32_rows(re, im, n, b)
    return jax.vmap(lambda p: _diag_marginal(p, qubits, n))(rows)


def sample_pair_batched(re, im, qubits, shots: int, keys, n: int, b: int):
    """Per-element categorical draws -> (b, shots); keys is (b, 2)."""
    from .density import _diag_marginal
    rows = _probs_f32_rows(re, im, n, b)

    def draw(p, key):
        marg = _diag_marginal(p, list(qubits), n)
        logits = jnp.log(jnp.maximum(marg, 1e-38))
        return jax.random.categorical(key, logits, shape=(shots,)).astype(
            jnp.int32)

    return jax.vmap(draw)(rows, keys)


def slice_pair_batched(re, im, start: int, size: int, n: int, b: int):
    """Per-element amplitude slices -> (b, size) pair: one reshape + one
    2-D slice per part (pure movement, O(1) program ops regardless of
    b)."""
    def cut(x):
        rows = x.reshape(-1, 1 << n)[:b]
        return jax.lax.dynamic_slice_in_dim(rows, start, size, axis=1)
    return cut(re), cut(im)


def statevector_pair_batched(re, im, n: int, b: int):
    """(b, 2^n) readback rows (drops the padded elements; reshape/slice are
    pure movement)."""
    return re.reshape(-1, 1 << n)[:b], im.reshape(-1, 1 << n)[:b]


# Jitted host entry points (static circuit metadata, dynamic state).
slice_pair_jit = jax.jit(slice_pair, static_argnums=(2, 3))
prob_one_pair_jit = jax.jit(prob_one_pair, static_argnums=(2,))
collapse_pair_jit = jax.jit(collapse_pair, static_argnums=(2, 3))
probs_pair_jit = jax.jit(probs_pair)
marginal_probs_pair_jit = jax.jit(
    marginal_probs_pair, static_argnames=("qubits",))
sample_pair_jit = jax.jit(sample_pair, static_argnames=("qubits", "shots"))
expval_terms_pair_jit = jax.jit(
    expval_terms_pair, static_argnames=("terms", "coeffs"))
expval_pauli_string_pair_jit = jax.jit(
    expval_pauli_string_pair, static_argnames=("ops",))

# batched twins (flat layout; n/b static)
prob_one_pair_batched_jit = jax.jit(prob_one_pair_batched,
                                    static_argnums=(2, 3, 4))
collapse_pair_batched_jit = jax.jit(collapse_pair_batched,
                                    static_argnums=(2, 4, 5))
expval_terms_pair_batched_jit = jax.jit(
    expval_terms_pair_batched,
    static_argnames=("terms", "coeffs", "n", "b"))
marginal_probs_pair_batched_jit = jax.jit(
    marginal_probs_pair_batched, static_argnames=("qubits", "n", "b"))
sample_pair_batched_jit = jax.jit(
    sample_pair_batched, static_argnames=("qubits", "shots", "n", "b"))
slice_pair_batched_jit = jax.jit(slice_pair_batched,
                                 static_argnums=(2, 3, 4, 5))
statevector_pair_batched_jit = jax.jit(statevector_pair_batched,
                                       static_argnums=(2, 3))


# ---------------------------------------------------------------------------
# Compiled pair programs (the fp64 Circuit.flush path)
# ---------------------------------------------------------------------------

from ..utils.cache import BoundedCache  # noqa: E402

_PAIR_EXEC_CACHE = BoundedCache()


def compile_pair_ir(ir, sharding=None):
    """A jitted ``f(re, im, params) -> (re, im)`` for a CircuitIR, cached by
    structural key (the fp64 twin of interpreter.compile_ir: no fusion,
    just the exact sequential pair ops; params stay runtime inputs so executables are reused across
    parameter updates).

    With ``sharding`` (flat-state NamedSharding over the 'sv' mesh axis,
    both parts identically sharded), SWAP_BITS relabels run as constrained
    rank-5 transposes (XLA lowers them to an all-to-all, exactly like
    the complex engine) and everything else stays the strictly-flat pair
    math: rolls touch only scheduled-local target bits, so XLA partitions
    them as thin edge exchanges, and controls/diagonals are pure
    elementwise masks — comm-free on device-selecting bits."""
    from ..compiler.ir import ParamRef
    # concrete params BAKE into the program (structural_key masks their
    # values for structure-keyed consumers) — key on them too
    baked = tuple(float(p) for op in ir.ops for p in op.params
                  if not isinstance(p, ParamRef))
    key = ("pair", ir.structural_key(), baked, sharding)
    fn = _PAIR_EXEC_CACHE.get(key)
    if fn is not None:
        return fn
    from ..compiler.interpreter import _resolve_params
    from ..compiler.sharded_schedule import SWAP_BITS
    from . import statevec as sv
    ops = list(ir.ops)

    def run(re, im, params):
        for op in ops:
            if op.name == SWAP_BITS:
                # always the transpose form: the einsum form would run an
                # f64 dot (inexact on this stack); transposes are pure data
                # movement. Only the sharded scheduler emits SWAP_BITS.
                a, b = op.targets
                re = sv.swap_index_bits(re, a, b, use_transpose=True)
                im = sv.swap_index_bits(im, a, b, use_transpose=True)
            elif op.name == "PERMUTE_BITS":
                d, s = ((op.controls, op.targets) if op.is_adjoint
                        else (op.targets, op.controls))
                re = sv.permute_index_bits(re, d, s)
                im = sv.permute_index_bits(im, d, s)
            else:
                re, im = apply_op_pair(re, im, op,
                                       _resolve_params(op, params))
            if sharding is not None:
                re = jax.lax.with_sharding_constraint(re, sharding)
                im = jax.lax.with_sharding_constraint(im, sharding)
        return re, im

    fn = jax.jit(run, donate_argnums=(0, 1))
    _PAIR_EXEC_CACHE[key] = fn
    return fn
