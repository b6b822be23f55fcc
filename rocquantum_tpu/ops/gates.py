"""Gate matrix library.

JAX analog of the reference's name->matrix tables
(reference: rocquantum/src/simulator.cpp:28-48, GateFusion.cpp:40-83,
hipStateVec.cpp named-gate entry points). Parameterized gates are functions of
a (possibly traced) angle so circuits JIT with dynamic parameters.

Matrix convention for multi-target gates: for ``targets=[t0, t1, ...]`` the
matrix row/column index has ``t0`` as the least-significant bit, matching the
reference's generic-matrix kernel convention
(multi_qubit_kernels.hip:37-115, targets[0] -> LSB of the gathered index).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import config

_SQRT1_2 = 1.0 / np.sqrt(2.0)


# ---------------------------------------------------------------------------
# Fixed (non-parameterized) gates, as numpy arrays (cast at use site).
# ---------------------------------------------------------------------------

I = np.eye(2, dtype=np.complex128)
X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
H = np.array([[_SQRT1_2, _SQRT1_2], [_SQRT1_2, -_SQRT1_2]], dtype=np.complex128)
S = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
SDG = np.array([[1, 0], [0, -1j]], dtype=np.complex128)
T = np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=np.complex128)
TDG = np.array([[1, 0], [0, np.exp(-1j * np.pi / 4)]], dtype=np.complex128)

# Two-qubit gates; targets=[t0, t1], t0 = LSB of the 2-bit index.
# CNOT convention: targets=[target, control] i.e. index bit0=target, bit1=control.
# We instead always expand controlled gates via the control mechanism, but a
# dense CNOT/CZ/SWAP matrix is useful for fusion and tensor-network nodes.
SWAP = np.array(
    [[1, 0, 0, 0],
     [0, 0, 1, 0],
     [0, 1, 0, 0],
     [0, 0, 0, 1]], dtype=np.complex128)

PAULI = {"I": I, "X": X, "Y": Y, "Z": Z}


# ---------------------------------------------------------------------------
# Parameterized gates. Return jnp arrays; `theta` may be a tracer.
# ---------------------------------------------------------------------------

def _cplx(re, im):
    """Combine real/imag parts with ``lax.complex`` (no complex
    multiply)."""
    return jax.lax.complex(re, im)


def rx_parts(theta):
    """(re, im) parts of RX; see _cplx for why parts are first-class."""
    theta = jnp.asarray(theta, dtype=config.real_dtype())
    c = jnp.cos(theta / 2)
    s = jnp.sin(theta / 2)
    z = jnp.zeros_like(c)
    return (jnp.stack([jnp.stack([c, z]), jnp.stack([z, c])]),
            jnp.stack([jnp.stack([z, -s]), jnp.stack([-s, z])]))


def rx(theta):
    return _cplx(*rx_parts(theta))


def ry_parts(theta):
    theta = jnp.asarray(theta, dtype=config.real_dtype())
    c = jnp.cos(theta / 2)
    s = jnp.sin(theta / 2)
    return jnp.stack([jnp.stack([c, -s]), jnp.stack([s, c])]), None


def ry(theta):
    re, _ = ry_parts(theta)
    return _cplx(re, jnp.zeros_like(re))


def rz_parts(theta):
    theta = jnp.asarray(theta, dtype=config.real_dtype())
    c = jnp.cos(theta / 2)
    s = jnp.sin(theta / 2)
    z = jnp.zeros_like(c)
    return (jnp.stack([jnp.stack([c, z]), jnp.stack([z, c])]),
            jnp.stack([jnp.stack([-s, z]), jnp.stack([z, s])]))


def rz(theta):
    return _cplx(*rz_parts(theta))


def phase_parts(lam):
    lam = jnp.asarray(lam, dtype=config.real_dtype())
    one = jnp.ones((), config.real_dtype())
    z = jnp.zeros((), config.real_dtype())
    return (jnp.stack([jnp.stack([one, z]), jnp.stack([z, jnp.cos(lam)])]),
            jnp.stack([jnp.stack([z, z]), jnp.stack([z, jnp.sin(lam)])]))


def phase(lam):
    return _cplx(*phase_parts(lam))


def rzz_parts(theta):
    theta = jnp.asarray(theta, dtype=config.real_dtype())
    c = jnp.cos(theta / 2)
    s = jnp.sin(theta / 2)
    return (jnp.diag(jnp.stack([c, c, c, c])),
            jnp.diag(jnp.stack([-s, s, s, -s])))


def rzz(theta):
    """exp(-i theta/2 Z@Z): the native two-qubit diagonal entangler (QAOA's
    cost-layer term without the CNOT sandwich). targets[0] is the matrix
    LSB; the diagonal is [e^-, e^+, e^+, e^-] over (b1, b0)."""
    return _cplx(*rzz_parts(theta))


def u3_parts(theta, phi, lam):
    theta = jnp.asarray(theta, dtype=config.real_dtype())
    phi = jnp.asarray(phi, dtype=config.real_dtype())
    lam = jnp.asarray(lam, dtype=config.real_dtype())
    c = jnp.cos(theta / 2)
    s = jnp.sin(theta / 2)
    z = jnp.zeros_like(c)
    # [[c, -e^{i lam} s], [e^{i phi} s, e^{i (phi+lam)} c]]
    re = jnp.stack([jnp.stack([c, -jnp.cos(lam) * s]),
                    jnp.stack([jnp.cos(phi) * s, jnp.cos(phi + lam) * c])])
    im = jnp.stack([jnp.stack([z, -jnp.sin(lam) * s]),
                    jnp.stack([jnp.sin(phi) * s, jnp.sin(phi + lam) * c])])
    return re, im


def u3(theta, phi, lam):
    return _cplx(*u3_parts(theta, phi, lam))


# Registry: name -> (num_targets, num_params, builder). Controlled named gates
# (CNOT, CZ, CRX, ...) are expressed as {controls} + base gate at circuit level.
FIXED = {
    "I": I, "X": X, "Y": Y, "Z": Z, "H": H, "S": S, "SDG": SDG,
    "T": T, "TDG": TDG, "SWAP": SWAP,
}

PARAMETERIZED = {
    "RX": rx, "RY": ry, "RZ": rz, "P": phase, "PHASE": phase, "U3": u3,
    "RZZ": rzz,
}

# (re, im)-part builders for the float-pair engines (ops/pairsim.py);
# im=None marks a REAL matrix (half the apply passes).
PARAMETERIZED_PARTS = {
    "RX": rx_parts, "RY": ry_parts, "RZ": rz_parts, "P": phase_parts,
    "PHASE": phase_parts, "U3": u3_parts, "RZZ": rzz_parts,
}


def gate_matrix(name: str, params=()) -> jnp.ndarray:
    """Look up / build the unitary for a named gate (uncontrolled part)."""
    key = name.upper()
    if key in FIXED:
        return jnp.asarray(FIXED[key], dtype=config.complex_dtype())
    if key in PARAMETERIZED:
        return PARAMETERIZED[key](*params)
    raise ValueError(f"Unknown gate name: {name}")


def is_parameterized(name: str) -> bool:
    return name.upper() in PARAMETERIZED
