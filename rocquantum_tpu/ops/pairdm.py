"""Float-pair density-matrix engine: fp64 open-system simulation.

The double-precision twin of ops/density.py, built on ops/pairsim.py: rho is
the flattened ``(2^(2n),)`` matrix held as ``(re, im)`` REAL f64 arrays
(see pairsim's module docstring). Row (ket) bits are the HIGH n index bits, exactly like the
complex engine, so ``U rho U†`` applies the gate's rows at ``q + n`` and the
CONJUGATED rows at ``q``; a Kraus channel applies the dense superoperator
``S = sum_i K_i (x) conj(K_i)`` over the (col, row) bit pair
(reference: hipDensityMat.cpp — Kraus kernels :23-72, channels :254-713,
ideal gates :714-983, expectations :77-131/:514-613; fp64 mode
hipStateVec.h:7-15).

Arithmetic discipline (same as pairsim): anything feeding the STATE or an
exact expectation uses strictly FLAT f64 elementwise math + FLAT full
reductions; marginal
histograms feed only sampling draws / host readback, so they downcast the
exactly-computed diagonal to f32 and use the ordinary view machinery.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from . import pairsim
from .pairsim import apply_matrix_pair, _rows_from_numpy


def init_density_pair(n: int, dtype=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """|0...0><0...0| as a flat 2^(2n) float pair."""
    return pairsim.init_pair(2 * n, dtype=dtype)


def rows_conj(m_re, m_im):
    """Entrywise conjugate of scalar rows (the COLUMN-side matrix of
    ``U rho U†``)."""
    if m_im is None:
        return m_re, None
    dim = len(m_re)
    return m_re, [[-m_im[i][j] for j in range(dim)] for i in range(dim)]


def apply_op_pair_dm(re: jnp.ndarray, im: jnp.ndarray, op, n: int,
                     params_resolved: Sequence = None):
    """rho' = U rho U† for one CircuitIR GateOp on logical qubits: rows at
    the row bits (q + n), conjugated rows at the column bits (q). Controls
    embed on both sides (a controlled-U conjugates to controlled-conj(U))."""
    m_re, m_im, tgts = pairsim.op_rows_targets(op, params_resolved,
                                               dtype=re.dtype)
    re, im = apply_matrix_pair(re, im, m_re, m_im, [t + n for t in tgts])
    c_re, c_im = rows_conj(m_re, m_im)
    return apply_matrix_pair(re, im, c_re, c_im, list(tgts))


def apply_kraus_at_pair_dm(re: jnp.ndarray, im: jnp.ndarray,
                           kraus_ops: List, row_pos: Sequence[int],
                           col_pos: Sequence[int]):
    """rho' = sum_i K_i rho K_i† with row/column qubit axes at ARBITRARY
    flat index-bit positions (the sharded density path's primitive after
    locality relabeling — density.apply_kraus_at's pair twin). One dense
    superoperator pass for 1-2q channels; >= 3 qubits accumulate per
    Kraus term (the superop's XOR-diagonal loop costs 4^(2m) coefficient
    selects, the per-term form 2 * 4^m)."""
    from . import density as dmops
    if len(row_pos) >= 3:
        acc_re = acc_im = None
        for k in kraus_ops:
            m_re, m_im = _rows_from_numpy(np.asarray(k, np.complex128))
            tr, ti = apply_matrix_pair(re, im, m_re, m_im, list(row_pos))
            c_re, c_im = rows_conj(m_re, m_im)
            tr, ti = apply_matrix_pair(tr, ti, c_re, c_im, list(col_pos))
            acc_re = tr if acc_re is None else acc_re + tr
            acc_im = ti if acc_im is None else acc_im + ti
        return acc_re, acc_im
    s = dmops.kraus_superoperator(kraus_ops, xp=np)
    m_re, m_im = _rows_from_numpy(np.asarray(s, np.complex128))
    return apply_matrix_pair(re, im, m_re, m_im,
                             list(col_pos) + list(row_pos))


def apply_kraus_pair_dm(re: jnp.ndarray, im: jnp.ndarray, kraus_ops: List,
                        targets: Sequence[int], n: int):
    """rho' = sum_i K_i rho K_i† on logical qubits (row bits at q + n)."""
    return apply_kraus_at_pair_dm(re, im, kraus_ops,
                                  [t + n for t in targets], list(targets))


def apply_channel_pair_dm(re: jnp.ndarray, im: jnp.ndarray,
                          channel_type: str, prob: float,
                          targets: Sequence[int], n: int):
    """Named single-qubit channel on each target (hipDensityMatApplyChannel
    surface, hipDensityMat.cpp:984)."""
    from . import density as dmops
    kraus = dmops.CHANNELS[channel_type.lower()](prob)
    for t in targets:
        re, im = apply_kraus_pair_dm(re, im, kraus, [t], n)
    return re, im


# ---------------------------------------------------------------------------
# Measurement / expectations (flat-exact where the result feeds state)
# ---------------------------------------------------------------------------

def _diag_mask(n: int) -> jnp.ndarray:
    """Boolean mask of the 2^(2n) flat indices on rho's diagonal
    (row bits == col bits)."""
    iota = jax.lax.iota(jnp.int32, 1 << (2 * n))
    return (iota >> n) == (iota & ((1 << n) - 1))


def trace_pair_dm(re: jnp.ndarray, n: int) -> jnp.ndarray:
    """Tr(rho): flat masked f64 reduction (exact)."""
    return jnp.sum(jnp.where(_diag_mask(n), re, jnp.zeros((), re.dtype)))


def purity_pair_dm(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Tr(rho^2) = sum_ij |rho_ij|^2 (rho Hermitian) — one exact flat
    pass."""
    return jnp.sum(re * re + im * im)


def probabilities_pair_dm(re: jnp.ndarray, n: int) -> jnp.ndarray:
    """diag(rho) as an f32 2^n vector (feeds sampling draws and host
    readback, not state — the exact f64 diagonal stays flat-masked in the
    trace/expectation paths)."""
    return jnp.diagonal(re.astype(jnp.float32).reshape((1 << n, 1 << n)))


def prob_one_pair_dm(re: jnp.ndarray, qubit: int, n: int) -> jnp.ndarray:
    """P(qubit = 1) = sum of diagonal entries with row bit set (exact)."""
    iota = jax.lax.iota(jnp.int32, 1 << (2 * n))
    keep = _diag_mask(n) & (((iota >> (qubit + n)) & 1) == 1)
    return jnp.sum(jnp.where(keep, re, jnp.zeros((), re.dtype)))


def collapse_pair_dm(re: jnp.ndarray, im: jnp.ndarray, qubit: int,
                     outcome: int, n: int):
    """rho' = P rho P / Tr(P rho P): keep entries whose row AND col bit at
    ``qubit`` equal ``outcome`` — flat masks + flat trace, all exact."""
    iota = jax.lax.iota(jnp.int32, 1 << (2 * n))
    o = jnp.asarray(outcome, jnp.int32)
    keep = (((iota >> (qubit + n)) & 1) == o) & (((iota >> qubit) & 1) == o)
    re = jnp.where(keep, re, jnp.zeros((), re.dtype))
    im = jnp.where(keep, im, jnp.zeros((), im.dtype))
    tr = trace_pair_dm(re, n)
    inv = 1.0 / jnp.maximum(tr, jnp.asarray(config.eps(), tr.dtype))
    return re * inv, im * inv


def marginal_probs_pair_dm(re: jnp.ndarray, qubits: Sequence[int],
                           n: int) -> jnp.ndarray:
    from . import density as dmops
    return dmops._diag_marginal(probabilities_pair_dm(re, n), qubits, n)


def sample_pair_dm(re: jnp.ndarray, qubits: Sequence[int], shots: int,
                   key: jax.Array) -> jnp.ndarray:
    n = (re.size.bit_length() - 1) // 2
    marg = marginal_probs_pair_dm(re, qubits, n)
    logits = jnp.log(jnp.maximum(marg, 1e-38))
    return jax.random.categorical(key, logits, shape=(shots,)).astype(
        jnp.int32)


def expval_pauli_product_z_pair_dm(re: jnp.ndarray, qubits: Sequence[int],
                                   n: int) -> jnp.ndarray:
    """Tr((Z...Z) rho): parity-signed flat masked diagonal sum (exact)."""
    iota = jax.lax.iota(jnp.int32, 1 << (2 * n))
    s = jnp.where(_diag_mask(n), re, jnp.zeros((), re.dtype))
    for q in sorted(set(int(q) for q in qubits)):
        s = jnp.where(((iota >> (q + n)) & 1).astype(bool), -s, s)
    return jnp.sum(s)


def expval_z_pair_dm(re: jnp.ndarray, qubit: int, n: int) -> jnp.ndarray:
    return expval_pauli_product_z_pair_dm(re, [qubit], n)


def expval_pauli_string_pair_dm(re: jnp.ndarray, im: jnp.ndarray,
                                ops: Sequence[tuple], n: int) -> jnp.ndarray:
    """Tr(P rho): apply P's rows to the ROW bits only, then the exact flat
    diagonal trace of the result (density.expval_pauli_string_dm scheme)."""
    pre, pim = re, im
    for ch, q in ops:
        if ch == "I":
            continue
        mr, mi = pairsim._PAULI_ROWS[ch]
        if mr is None:  # Y: purely imaginary rows, parts swap
            a = pairsim._apply_real_elementwise(pim, mi, [q + n])
            b = pairsim._apply_real_elementwise(pre, mi, [q + n])
            pre, pim = -a, b
        else:
            pre, pim = apply_matrix_pair(pre, pim, mr, mi, [q + n])
    return trace_pair_dm(pre, n)


def expval_terms_pair_dm(re: jnp.ndarray, im: jnp.ndarray, terms, coeffs,
                         n: int) -> jnp.ndarray:
    """Sum_k coeffs[k] * Tr(P_k rho) for PauliOperator-style terms."""
    total = jnp.zeros((), re.dtype)
    for term, c in zip(terms, coeffs):
        if len(term) == 0:
            ev = trace_pair_dm(re, n)
        elif all(p == "Z" for p, _ in term):
            ev = expval_pauli_product_z_pair_dm(
                re, [q for _, q in term], n)
        else:
            ev = expval_pauli_string_pair_dm(re, im, term, n)
        total = total + jnp.asarray(c, re.dtype) * ev
    return total


# Jitted host entry points (static metadata, dynamic state).
trace_pair_dm_jit = jax.jit(trace_pair_dm, static_argnums=(1,))
purity_pair_dm_jit = jax.jit(purity_pair_dm)
prob_one_pair_dm_jit = jax.jit(prob_one_pair_dm, static_argnums=(1, 2))
collapse_pair_dm_jit = jax.jit(collapse_pair_dm, static_argnums=(2, 3, 4))
marginal_probs_pair_dm_jit = jax.jit(marginal_probs_pair_dm,
                                     static_argnames=("qubits", "n"))
sample_pair_dm_jit = jax.jit(sample_pair_dm,
                             static_argnames=("qubits", "shots"))
expval_z_pair_dm_jit = jax.jit(expval_z_pair_dm, static_argnums=(1, 2))
expval_pauli_product_z_pair_dm_jit = jax.jit(
    expval_pauli_product_z_pair_dm, static_argnames=("qubits", "n"))
expval_pauli_string_pair_dm_jit = jax.jit(
    expval_pauli_string_pair_dm, static_argnames=("ops", "n"))
expval_terms_pair_dm_jit = jax.jit(
    expval_terms_pair_dm, static_argnames=("terms", "coeffs", "n"))
