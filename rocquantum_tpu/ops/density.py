"""Density-matrix simulation engine with Kraus noise channels.

JAX replacement for the reference hipDensityMat engine
(reference: rocquantum/src/hipDensityMat/hipDensityMat.cpp — Kraus
application kernels :23-72, bit-flip :254, phase-flip :295, depolarizing
:364, amplitude damping :650, ideal gates U rho U† :714-983, expectations
:77-131 and :514-613; API surface hipDensityMat.hpp:38-230).

Representation: rho is a flat ``(2**(2n),)`` complex array — the flattened
dense ``2^n x 2^n`` matrix with the ROW (ket) index in the HIGH n bits. This
makes rho literally a 2n-qubit state vector, so every statevector primitive
is reused: ``U rho U†`` = apply ``U`` to row-qubit axes (q+n) and ``conj(U)``
to column-qubit axes (q). Channels are sums over Kraus terms, traced into one
jitted program per circuit segment.

Helpers accept/return the ``(2^n, 2^n)`` matrix view at the API boundary.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from . import gates as _g
from . import statevec as sv


def num_qubits_of(rho: jnp.ndarray) -> int:
    size = rho.shape[-1] if rho.ndim == 1 else rho.shape[-1] * rho.shape[-2]
    n2 = size.bit_length() - 1
    if (1 << n2) != size or n2 % 2:
        raise ValueError(f"density matrix size {size} is not 4**n")
    return n2 // 2


def init_density(num_qubits: int, dtype=None) -> jnp.ndarray:
    """|0...0><0...0| (hipDensityMatCreateState + initialize,
    hipDensityMat.cpp state setup)."""
    from .statevec import one_hot
    return one_hot(1 << (2 * num_qubits), 0,
                   dtype or config.complex_dtype())


def to_matrix(rho: jnp.ndarray) -> jnp.ndarray:
    n = num_qubits_of(rho)
    return rho.reshape((1 << n, 1 << n))


def from_matrix(mat: jnp.ndarray) -> jnp.ndarray:
    return mat.reshape((-1,))


def from_statevector(state: jnp.ndarray) -> jnp.ndarray:
    """rho = |psi><psi|."""
    return from_matrix(jnp.outer(state, jnp.conj(state)))


# ---------------------------------------------------------------------------
# Unitary evolution
# ---------------------------------------------------------------------------

def apply_matrix_dm(rho: jnp.ndarray, matrix: jnp.ndarray,
                    targets: Sequence[int]) -> jnp.ndarray:
    """rho' = U rho U† (ideal-gate path, hipDensityMat.cpp:714-983)."""
    n = num_qubits_of(rho)
    matrix = jnp.asarray(matrix, dtype=rho.dtype)
    rho = sv.apply_matrix(rho, matrix, [t + n for t in targets])     # U rho
    rho = sv.apply_matrix(rho, jnp.conj(matrix), list(targets))      # ... U†
    return rho


def apply_controlled_matrix_dm(rho: jnp.ndarray, matrix: jnp.ndarray,
                               controls: Sequence[int],
                               targets: Sequence[int]) -> jnp.ndarray:
    """Controlled-U on rho (hipDensityMat controlled-1q kernels :837-983)."""
    n = num_qubits_of(rho)
    matrix = jnp.asarray(matrix, dtype=rho.dtype)
    rho = sv.apply_controlled_matrix(rho, matrix,
                                     [c + n for c in controls],
                                     [t + n for t in targets])
    rho = sv.apply_controlled_matrix(rho, jnp.conj(matrix),
                                     list(controls), list(targets))
    return rho


def apply_gate_dm(rho: jnp.ndarray, name: str, targets: Sequence[int],
                  controls: Sequence[int] = (), params: Sequence = (),
                  adjoint: bool = False) -> jnp.ndarray:
    """Named-gate application (apply_gate with adjoint flag,
    py_hip_density_mat.cpp:44-64)."""
    name = name.upper()
    from ..compiler.interpreter import _IMPLICIT_CTRL
    if name in _IMPLICIT_CTRL and not controls:
        base = _IMPLICIT_CTRL[name]
        n_tgt = 2 if base == "SWAP" else 1
        controls, targets = list(targets[:-n_tgt]), list(targets[-n_tgt:])
        mat = _g.gate_matrix(base, params)
    elif name in _IMPLICIT_CTRL:
        mat = _g.gate_matrix(_IMPLICIT_CTRL[name], params)
    else:
        mat = _g.gate_matrix(name, params)
    if adjoint:
        mat = jnp.conj(mat).T
    if controls:
        return apply_controlled_matrix_dm(rho, mat, list(controls), list(targets))
    return apply_matrix_dm(rho, mat, list(targets))


# ---------------------------------------------------------------------------
# Kraus channels
# ---------------------------------------------------------------------------

def kraus_superoperator(kraus_ops: List, dtype=None, xp=jnp):
    """S = sum_i K_i (x) conj(K_i): the channel as ONE (4^m, 4^m) matrix on
    the flattened rho's (row ⊗ col) index pair.

    rho'[r', c'] = sum_i K_i[r', r] conj(K_i)[c', c] rho[r, c] — so applying
    S over the combined index (r·2^m + c) IS the whole channel: one state
    pass instead of 2 passes + an add per Kraus term (the reference looped
    terms through apply_single_qubit_kraus_kernel + accumulate_kernel,
    hipDensityMat.cpp:23-72). Pass ``xp=np`` for a host-side matrix usable
    as a GateOp matrix (trace-time constant)."""
    conj = xp.conj
    mats = [xp.asarray(k) if dtype is None else xp.asarray(k, dtype)
            for k in kraus_ops]
    s = None
    for k in mats:
        term = xp.kron(k, conj(k))
        s = term if s is None else s + term
    return s


def _apply_kraus_terms(rho2n: jnp.ndarray, kraus_ops: List[jnp.ndarray],
                       row_pos: Sequence[int],
                       col_pos: Sequence[int]) -> jnp.ndarray:
    """Per-term accumulate: sum_i (K_i on row bits)(conj K_i on col bits).
    Two rank-(2m+1) passes per term instead of one rank-(4m+1) superop pass
    — the form used for m >= 4 targets, which keeps views at most 17 axes
    (the reference's own loop was per-term, hipDensityMat.cpp:23-72)."""
    acc = None
    for k in kraus_ops:
        k = jnp.asarray(k, rho2n.dtype)
        term = sv.apply_matrix(rho2n, k, list(row_pos))
        term = sv.apply_matrix(term, jnp.conj(k), list(col_pos))
        acc = term if acc is None else acc + term
    return acc


# superop view rank is 4m+1; m >= 4 targets take the per-term path, which
# keeps views at most 17 axes
_MAX_SUPEROP_TARGETS = 3


def apply_kraus(rho: jnp.ndarray, kraus_ops: List[jnp.ndarray],
                targets: Sequence[int]) -> jnp.ndarray:
    """rho' = sum_i K_i rho K_i† (generic channel entry,
    hipDensityMatApplyChannel, hipDensityMat.cpp:984; kernel :23-72) —
    executed as one superoperator matrix over (col, row) index bits
    (per-term accumulate for wide channels, see _apply_kraus_terms)."""
    n = num_qubits_of(rho)
    if len(targets) > _MAX_SUPEROP_TARGETS:
        return _apply_kraus_terms(rho, kraus_ops,
                                  [t + n for t in targets], list(targets))
    s = kraus_superoperator(kraus_ops, dtype=rho.dtype)
    pos = list(targets) + [t + n for t in targets]
    return sv.apply_matrix(rho, s, pos)


def apply_kraus_at(rho2n: jnp.ndarray, kraus_ops: List[jnp.ndarray],
                   row_pos: Sequence[int],
                   col_pos: Sequence[int]) -> jnp.ndarray:
    """rho' = sum_i K_i rho K_i† with the row/column qubit axes at ARBITRARY
    index-bit positions of the flattened 2n-qubit view — the primitive the
    sharded density path needs after locality relabeling has moved row bit
    q+n / col bit q to other physical positions."""
    if len(row_pos) > _MAX_SUPEROP_TARGETS:
        return _apply_kraus_terms(rho2n, kraus_ops, row_pos, col_pos)
    s = kraus_superoperator(kraus_ops, dtype=rho2n.dtype)
    return sv.apply_matrix(rho2n, s, list(col_pos) + list(row_pos))


_CNOT01 = np.zeros((4, 4))
_CNOT01[[0, 3, 2, 1], [0, 1, 2, 3]] = 1.0  # ctrl = bit0, tgt = bit1


def superop_kernel_ops(s, q: int, qn: int):
    """Factor a 1q-channel superoperator S (4x4 on flat bits (q, qn),
    q = LSB) into fused-kernel ops instead of one dense 2q matrix:

        S = C . (|0><0|_qn (x) A0  +  |1><1|_qn (x) A1) . C,
        C = CNOT(ctrl=q, tgt=qn)

    which lowers to  [CNOT, U(q, A0), CU(qn -> q, A1 A0^-1), CNOT]  — ordinary
    gates, so a channel layer rides the same fused gate stream as the gates
    around it (instead of one dense 4x4 einsum pass per channel; the
    reference looped Kraus terms + accumulate,
    hipDensityMat.cpp:23-72). Every S = sum K (x) conj(K) block-
    diagonalizes this way iff each Kraus term's (K (x) conj(K)) preserves
    the bit-parity grading — true for all built-in channels. Returns the
    GateOp list, or None when S doesn't factor (fall back to the dense
    matrix path)."""
    from ..compiler.ir import GateOp

    s = np.asarray(s, np.complex128)
    if s.shape != (4, 4):
        return None
    if np.allclose(s, np.diag(np.diag(s)), atol=1e-14):
        # diagonal superop (phase-flip family): ONE comm-free "D2" masked
        # multiply — needs no pairing at any qubit and zero collectives
        # under sharding
        v = np.diag(s)
        return [GateOp("D2M", (q, qn), (), (),
                       np.array([[v[0], v[2]], [v[1], v[3]]]))]
    m = s.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    u_, sig, vt = np.linalg.svd(m)
    if sig[1] < 1e-12 * max(sig[0], 1e-30):
        # operator-Schmidt rank 1: S = A (x) B — two plain 1q kernel ops
        # (a unitary channel [single Kraus term])
        a = u_[:, 0].reshape(2, 2) * np.sqrt(sig[0])
        b = vt[0].reshape(2, 2) * np.sqrt(sig[0])
        return [GateOp("UNITARY", (q,), (), (), b),
                GateOp("UNITARY", (qn,), (), (), a)]
    sp = _CNOT01 @ s @ _CNOT01
    scale = max(np.max(np.abs(sp)), 1e-30)
    eq, df = np.ix_([0, 1], [0, 1]), np.ix_([2, 3], [2, 3])
    off = max(np.max(np.abs(sp[np.ix_([0, 1], [2, 3])])),
              np.max(np.abs(sp[np.ix_([2, 3], [0, 1])])))
    if off > 1e-12 * scale:
        return None
    a0, a1 = sp[eq], sp[df]
    cnot = GateOp("X", (qn,), (q,))
    ops = [cnot]
    if not np.allclose(a0, np.eye(2), atol=1e-14):
        ops.append(GateOp("UNITARY", (q,), (), (), a0))
    if not np.allclose(a1, a0, atol=1e-14):
        det = np.linalg.det(a0)
        if abs(det) < 1e-6 * scale * scale:
            return None  # A0 not invertible: keep the dense superop
        b = a1 @ np.linalg.inv(a0)
        ops.append(GateOp("UNITARY", (q,), (qn,), (), b))
    ops.append(cnot)
    return ops


def _chan(mats):
    return [np.asarray(m, dtype=np.complex128) for m in mats]


def bit_flip_kraus(p: float):
    """(hipDensityMat.cpp:254-282)"""
    return _chan([np.sqrt(1 - p) * _g.I, np.sqrt(p) * _g.X])


def phase_flip_kraus(p: float):
    """(hipDensityMat.cpp:295-362)"""
    return _chan([np.sqrt(1 - p) * _g.I, np.sqrt(p) * _g.Z])


def depolarizing_kraus(p: float):
    """(hipDensityMat.cpp:364-446: sqrt(p/3) X/Y/Z weights)"""
    return _chan([np.sqrt(1 - p) * _g.I, np.sqrt(p / 3) * _g.X,
                  np.sqrt(p / 3) * _g.Y, np.sqrt(p / 3) * _g.Z])


def amplitude_damping_kraus(gamma: float):
    """(hipDensityMat.cpp:650-713: K0 = diag(1, sqrt(1-gamma)),
    K1 = sqrt(gamma) sigma+)"""
    k0 = np.array([[1, 0], [0, np.sqrt(1 - gamma)]], dtype=np.complex128)
    k1 = np.array([[0, np.sqrt(gamma)], [0, 0]], dtype=np.complex128)
    return [k0, k1]


CHANNELS = {
    "bit_flip": bit_flip_kraus,
    "phase_flip": phase_flip_kraus,
    "depolarizing": depolarizing_kraus,
    "amplitude_damping": amplitude_damping_kraus,
}


def apply_channel(rho: jnp.ndarray, channel_type: str, prob: float,
                  targets: Sequence[int]) -> jnp.ndarray:
    """Apply a named single-qubit channel to each target qubit."""
    try:
        kraus = CHANNELS[channel_type.lower()](prob)
    except KeyError:
        raise ValueError(f"Unknown noise channel: {channel_type!r}. "
                         f"Supported: {sorted(CHANNELS)}")
    for t in targets:
        rho = apply_kraus(rho, kraus, [t])
    return rho


# ---------------------------------------------------------------------------
# Measurement / expectations
# ---------------------------------------------------------------------------

def probabilities_dm(rho: jnp.ndarray) -> jnp.ndarray:
    """diag(rho) — computational-basis probabilities."""
    n = num_qubits_of(rho)
    return jnp.real(jnp.diagonal(to_matrix(rho))).astype(config.real_dtype())


def trace_dm(rho: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(probabilities_dm(rho))


def purity(rho: jnp.ndarray) -> jnp.ndarray:
    m = to_matrix(rho)
    return jnp.real(jnp.sum(m * jnp.conj(m.T))).astype(config.real_dtype())


def _diag_marginal(probs: jnp.ndarray, qubits: Sequence[int], n: int):
    qubits = list(qubits)
    desc = sorted(qubits, reverse=True)
    dims = sv._exposed_view_dims(n, desc)
    marg = probs.reshape(dims).sum(axis=tuple(range(0, len(dims), 2)))
    cur_pos = {q: i for i, q in enumerate(desc)}
    k = len(qubits)
    perm = [cur_pos[qubits[k - 1 - j]] for j in range(k)]
    return marg.transpose(perm).reshape((-1,))


def marginal_probs_dm(rho: jnp.ndarray, qubits: Sequence[int]) -> jnp.ndarray:
    n = num_qubits_of(rho)
    return _diag_marginal(probabilities_dm(rho), qubits, n)


def sample_dm(rho: jnp.ndarray, qubits: Sequence[int], shots: int,
              key: jax.Array) -> jnp.ndarray:
    marg = marginal_probs_dm(rho, qubits)
    logits = jnp.log(jnp.maximum(marg, 1e-38))
    return jax.random.categorical(key, logits, shape=(shots,)).astype(jnp.int32)


def prob_one_dm(rho: jnp.ndarray, qubit: int) -> jnp.ndarray:
    n = num_qubits_of(rho)
    probs = probabilities_dm(rho).reshape(
        (1 << (n - 1 - qubit), 2, 1 << qubit))
    return jnp.sum(probs[:, 1, :])


def collapse_dm(rho: jnp.ndarray, qubit: int, outcome: int) -> jnp.ndarray:
    """Project rho onto qubit=outcome and renormalize by the trace."""
    n = num_qubits_of(rho)
    proj = np.zeros((2, 2), dtype=np.complex128)
    proj[outcome, outcome] = 1.0
    rho2 = apply_matrix_dm(rho, jnp.asarray(proj, rho.dtype), [qubit])
    tr = trace_dm(rho2)
    return rho2 / jnp.maximum(tr, config.eps()).astype(rho.dtype)


def expval_z_dm(rho: jnp.ndarray, qubit: int) -> jnp.ndarray:
    """Tr(Z_q rho) (hipDensityMat.cpp:77-131, :447)."""
    return (1.0 - 2.0 * prob_one_dm(rho, qubit)).astype(config.real_dtype())


def expval_pauli_product_z_dm(rho: jnp.ndarray,
                              qubits: Sequence[int]) -> jnp.ndarray:
    """Tr((Z...Z) rho) via parity-weighted diagonal
    (hipDensityMat.cpp:514-613)."""
    n = num_qubits_of(rho)
    probs = probabilities_dm(rho)
    desc = sorted(set(qubits), reverse=True)
    dims = sv._exposed_view_dims(n, desc)
    probs = probs.reshape(dims)
    sign = jnp.asarray([1.0, -1.0], dtype=probs.dtype)
    for i in range(len(desc)):
        shape = [1] * len(dims)
        shape[2 * i + 1] = 2
        probs = probs * sign.reshape(shape)
    return jnp.sum(probs).astype(config.real_dtype())


def expval_pauli_string_dm(rho: jnp.ndarray, ops: Sequence[tuple]) -> jnp.ndarray:
    """Tr(P rho) for a general Pauli string: apply P to the row index only,
    then trace (utils/hamiltonian.py basis-change scheme collapses to this
    single pass — no mutate-and-restore)."""
    n = num_qubits_of(rho)
    phi = rho
    for pauli_char, q in ops:
        if pauli_char == "I":
            continue
        phi = sv.apply_matrix(
            phi, jnp.asarray(_g.PAULI[pauli_char], rho.dtype), [q + n])
    return jnp.real(jnp.trace(to_matrix(phi))).astype(config.real_dtype())


# Jitted host entry points
prob_one_dm_jit = jax.jit(prob_one_dm, static_argnums=(1,))
collapse_dm_jit = jax.jit(collapse_dm, static_argnums=(1, 2))
expval_z_dm_jit = jax.jit(expval_z_dm, static_argnums=(1,))
sample_dm_jit = jax.jit(sample_dm, static_argnames=("qubits", "shots"))
purity_dm_jit = jax.jit(purity)
expval_pauli_product_z_dm_jit = jax.jit(expval_pauli_product_z_dm,
                                        static_argnames=("qubits",))
expval_pauli_string_dm_jit = jax.jit(expval_pauli_string_dm,
                                     static_argnames=("ops",))
