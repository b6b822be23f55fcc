"""Reversible (O(1)-memory) adjoint differentiation.

Plain ``jax.grad`` through the circuit interpreter is mathematically adjoint
differentiation, but reverse-mode AD stores every intermediate state —
O(gates x 2^n) memory, which caps circuit depth at large n. Quantum
circuits are unitary, so intermediates can instead be RECONSTRUCTED during
the backward sweep by applying inverse gates: the classic adjoint method
(two live state vectors total, regardless of depth).

``reversible_execute`` is a drop-in for ``interpreter.execute`` whose custom
VJP implements that sweep:

    ket   <- U_k^dagger ket        (reconstruct the pre-gate state)
    grad_k = 2 Re <bra | dU_k/dtheta | ket>
    bra   <- U_k^dagger bra        (propagate the cotangent)

This realizes the BASELINE.json north star ("adjoint differentiation ...
on device") beyond what parameter-shift or plain AD offer: one forward +
one backward pass, constant memory. The reference's gradient story was
parameter-shift (api.py:694-734) plus an IR-reversal compiler pass
(AdjointGeneration.cpp) that never computed gradients.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from . import config
from .compiler.interpreter import _base_matrix, _split_op
from .compiler.ir import GateOp, ParamRef  # noqa: F401 (ParamRef re-exported for callers)
from .ops import statevec as sv


def _apply(state, op, params, adjoint=False):
    base, controls, targets = _split_op(op)
    mat = _base_matrix(op, params)
    if adjoint:
        mat = jnp.conj(mat).T
    return sv.apply_controlled_matrix(state, mat, controls, targets)


def _is_parameterized(op: GateOp) -> bool:
    from .compiler.ir import ParamRef as _PR
    return any(isinstance(p, _PR) for p in op.params)


def _adjoint_group(group):
    import dataclasses as _dc
    return [_dc.replace(o, is_adjoint=not o.is_adjoint)
            for o in reversed(group)]


def make_reversible_execute(ops: Sequence[GateOp]):
    """Build ``f(state, params) -> state`` with the O(1)-memory VJP.

    ``ops`` must be purely unitary GateOps (no measurement); parameters are
    ParamRef slots into the ``params`` vector.

    The forward pass runs through the full fused interpreter (diagonal
    fusion, consolidation); the backward sweep fuses runs of
    NON-parameterized gates the same way — a CNOT ring between RY columns
    costs one fused pass each direction instead of one pass per gate. Only
    the parameterized gates step one-by-one (each needs its own
    ⟨bra|dU|ket⟩).
    """
    from .compiler.interpreter import execute as _exec

    ops = list(ops)
    for op in ops:
        if op.name in ("SWAP_BITS", "PERMUTE_BITS"):
            continue
        if op.matrix is None and op.name.upper() in ("UNITARY",):
            raise ValueError("UNITARY op requires a matrix")

    def _forward(state, params):
        return _exec(state, ops, params)

    @jax.custom_vjp
    def run(state, params):
        return _forward(state, params)

    def fwd(state, params):
        out = _forward(state, params)
        return out, (out, params)

    def bwd(res, ct):
        out, params = res
        ket = out            # reconstructed state, walked backward
        bra = ct             # cotangent, walked backward
        grads = jnp.zeros_like(params)
        idx = len(ops) - 1
        while idx >= 0:
            if not _is_parameterized(ops[idx]):
                # maximal run of parameter-free gates: invert in ONE fused
                # program. ket <- G^dagger ket (plain adjoint); the
                # cotangent needs the TRANSPOSE (JAX complex cotangents
                # transpose without conjugation): U^T x = conj(U^dagger
                # conj(x)), so conjugate around the same fused adjoint.
                j = idx
                while j >= 0 and not _is_parameterized(ops[j]):
                    j -= 1
                adj = _adjoint_group(ops[j + 1:idx + 1])
                ket = _exec(ket, adj, params)
                bra = jnp.conj(_exec(jnp.conj(bra), adj, params))
                idx = j
                continue
            op = ops[idx]
            # reconstruct the state BEFORE this gate (exactly: U is unitary)
            ket = _apply(ket, op, params, adjoint=True)
            # one-gate vjp: gets JAX's complex-cotangent conventions right
            # while touching only this gate — memory stays O(1) in depth
            _, vjp_fn = jax.vjp(
                lambda s, p, _op=op: _apply(s, _op, p), ket, params)
            bra, dparams = vjp_fn(bra)
            grads = grads + dparams
            idx -= 1
        return bra, grads

    run.defvjp(fwd, bwd)
    return run


def reversible_energy_fn(kernel_func, num_qubits: int, hamiltonian,
                         num_params: int):
    """Energy function whose gradient runs the O(1)-memory adjoint sweep
    (drop-in alternative to api.make_energy_fn)."""
    from .api import _Recorder, _expval_terms_traced

    rec = _Recorder(num_qubits)
    func = getattr(kernel_func, "__wrapped__", kernel_func)
    func(rec, *[ParamRef(i) for i in range(num_params)])
    # NB: concrete (fixed-angle) params stay concrete — re-parametrizing
    # them would allocate ParamRef indices colliding with the kernel's own
    # ParamRef(0..P-1) slots
    run = make_reversible_execute(rec.ops)
    terms_key = tuple(tuple(t) for t, _ in hamiltonian.terms)
    coeffs = np.asarray([c for _, c in hamiltonian.terms], dtype=float)

    def energy(param_vec):
        state = sv.init_state(num_qubits)
        state = run(state, param_vec)
        return _expval_terms_traced(
            state, terms_key, jnp.asarray(coeffs, config.real_dtype()))

    return energy
