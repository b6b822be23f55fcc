"""Plain numpy (complex128) reference for gate application, independent of
the package's gate tables and kernels."""

import numpy as np

_FIXED = {
    "I": np.eye(2),
    "X": np.array([[0, 1], [1, 0]]),
    "Y": np.array([[0, -1j], [1j, 0]]),
    "Z": np.diag([1.0, -1.0]),
    "H": np.array([[1, 1], [1, -1]]) / np.sqrt(2),
    "S": np.diag([1, 1j]),
    "SDG": np.diag([1, -1j]),
    "T": np.diag([1, np.exp(1j * np.pi / 4)]),
    "TDG": np.diag([1, np.exp(-1j * np.pi / 4)]),
    "SWAP": np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]]),
}

# controlled names -> (base gate, number of controls)
_CONTROLLED = {"CNOT": ("X", 1), "CX": ("X", 1), "CZ": ("Z", 1),
               "CRX": ("RX", 1), "CRY": ("RY", 1), "CRZ": ("RZ", 1),
               "CCX": ("X", 2)}


def gate_matrix(name, params=()):
    name = name.upper()
    if name in _FIXED:
        return np.asarray(_FIXED[name], np.complex128)
    th = float(params[0]) if params else 0.0
    c, s = np.cos(th / 2), np.sin(th / 2)
    if name == "RX":
        return np.array([[c, -1j * s], [-1j * s, c]])
    if name == "RY":
        return np.array([[c, -s], [s, c]], np.complex128)
    if name == "RZ":
        return np.diag([np.exp(-0.5j * th), np.exp(0.5j * th)])
    if name in ("P", "PHASE"):
        return np.diag([1.0, np.exp(1j * th)])
    if name == "RZZ":
        e, f = np.exp(-0.5j * th), np.exp(0.5j * th)
        return np.diag([e, f, f, e])
    raise KeyError(name)


def apply(psi, u, targets, controls=()):
    """Apply ``u`` (targets[0] = LSB of its index) to ``targets`` where
    every control qubit is 1; qubit q is bit q of the state index."""
    psi = np.asarray(psi, np.complex128)
    n = psi.size.bit_length() - 1
    t = psi.reshape((2,) * n).copy()
    idx = [slice(None)] * n
    for q in controls:
        idx[n - 1 - q] = 1
    sub = t[tuple(idx)]
    rem = [q for q in range(n - 1, -1, -1) if q not in controls]
    m = len(targets)
    axes = [rem.index(q) for q in reversed(targets)]
    sub = np.moveaxis(sub, axes, list(range(m)))
    shape = sub.shape
    sub = (np.asarray(u) @ sub.reshape(1 << m, -1)).reshape(shape)
    t[tuple(idx)] = np.moveaxis(sub, list(range(m)), axes)
    return t.reshape(-1)


def apply_op(psi, name, targets, controls=(), params=()):
    """Named-gate form; CNOT/CZ/CRY/CCX given as targets + controls."""
    name = name.upper()
    if name in _CONTROLLED:
        base, _ = _CONTROLLED[name]
        return apply(psi, gate_matrix(base, params), targets, controls)
    return apply(psi, gate_matrix(name, params), targets, controls)


def run(n, ops):
    """ops: iterable of (name, targets, controls, params) from |0...0>."""
    psi = np.zeros(1 << n, np.complex128)
    psi[0] = 1.0
    for name, targets, controls, params in ops:
        psi = apply_op(psi, name, targets, controls, params)
    return psi
