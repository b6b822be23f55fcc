"""Smoke test of the simulator's main path on one NVIDIA H100.

Usage, from the repository root:

    python chip_smoke.py                # the one-card phases
    python chip_smoke.py --four-cards   # a state sharded over four cards

Every phase drives a public entry point at its full size and checks what
comes out against a plain reference, with the tolerance and precision
stated beside it. A failed phase raises, so the script exits non-zero and
prints no result; it also refuses any backend but the GPU. Earlier lines
report each phase's wall time, compile time and the device's
``peak_bytes_in_use`` (the process peak so far); the last line of standard
output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rocquantum_tpu as rocq  # noqa: E402
from rocquantum_tpu.compiler.ir import CircuitIR  # noqa: E402
from rocquantum_tpu.density_circuit import DensityCircuit  # noqa: E402
from rocquantum_tpu.models import qft_ir  # noqa: E402
from rocquantum_tpu.utils.cache import enable_compilation_cache  # noqa: E402

# Sizes of the full run: 30 qubits of complex64 is an 8 GiB state; the
# sharded run puts 32 qubits (32 GiB) over four cards.
ANSATZ_N, ANSATZ_REF_N, ANSATZ_LAYERS = 30, 20, 4
QFT_N = 30
GRAD_N, GRAD_LAYERS = 26, 2
DENSITY_N, DENSITY_REF_N = 13, 6
DOUBLE_N, DOUBLE_REF_N = 26, 12
TN_DIM, TN_REF_DIM = 4096, 64
SHARDED_N, SHARDED_CMP_N, SHARDED_CARDS = 32, 30, 4

# Tolerances. complex64 phases compare against float64 numpy; the errors
# they allow are a few hundred single-precision roundings, far below what a
# wrong gate, a wrong qubit or a TF32 product (about 1e-3 per operation)
# would give.
C64_STATE_TOL = 1e-4    # ||psi - psi_ref||_2, both of unit norm
C64_NORM_TOL = 1e-4     # |<psi|psi> - 1| after the full-size circuit
C64_ENERGY_TOL = 1e-3   # |E - E_ref| for an n-term Ising energy
QFT_TOL = 1e-3          # max_j |sqrt(N) psi_j - exp(2 pi i j k / N)|
GRAD_TOL = 2e-3         # |adjoint - parameter shift| per component
TRACE_TOL = 1e-4        # |Tr rho - 1|
DM_TOL = 1e-5           # max |rho - rho_ref|, complex64 against float64
F64_NORM_TOL = 1e-12    # double precision: norm drift at full size
F64_STATE_TOL = 1e-12   # double precision: max |psi - psi_ref|
TN_RTOL = 1e-4          # sliced against unsliced, relative to |unsliced|


class SmokeFailure(AssertionError):
    """A phase's result is outside its stated tolerance."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# Plain numpy references (float64 / complex128)
# ---------------------------------------------------------------------------

def np_ry(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def np_apply_1q(psi: np.ndarray, u: np.ndarray, q: int) -> np.ndarray:
    n = psi.size.bit_length() - 1
    v = psi.reshape(1 << (n - 1 - q), 2, 1 << q)
    return np.einsum("ab,xby->xay", u, v).reshape(-1)


def np_apply_cnot(psi: np.ndarray, c: int, t: int) -> np.ndarray:
    idx = np.arange(psi.size)
    return psi[np.where((idx >> c) & 1, idx ^ (1 << t), idx)]


def np_ansatz_state(n: int, thetas: np.ndarray) -> np.ndarray:
    psi = np.zeros(1 << n, np.complex128)
    psi[0] = 1.0
    for layer in thetas:
        for q in range(n):
            psi = np_apply_1q(psi, np_ry(layer[q]), q)
        for q in range(n):
            psi = np_apply_cnot(psi, q, (q + 1) % n)
    return psi


def np_ising_energy(psi: np.ndarray, field: float = 0.5) -> float:
    """E = -sum_i Z_i Z_{i+1} - field * sum_i X_i on a ring."""
    n = psi.size.bit_length() - 1
    probs = np.abs(psi) ** 2
    idx = np.arange(psi.size)
    energy = 0.0
    for q in range(n):
        parity = ((idx >> q) ^ (idx >> ((q + 1) % n))) & 1
        energy -= float(np.sum(probs * (1 - 2 * parity)))
        v = psi.reshape(1 << (n - 1 - q), 2, 1 << q)
        energy -= field * 2.0 * float(np.sum(np.conj(v[:, 0]) * v[:, 1]).real)
    return energy


def ising_operator(n: int, field: float = 0.5) -> "rocq.PauliOperator":
    terms = {f"Z{q} Z{(q + 1) % n}": -1.0 for q in range(n)}
    terms.update({f"X{q}": -field for q in range(n)})
    return rocq.PauliOperator(terms)


def ansatz(c, thetas: np.ndarray, offset: int = 0) -> None:
    """RY column + CNOT ring per layer, on qubits offset..offset+width-1."""
    width = thetas.shape[1]
    for layer in thetas:
        for q in range(width):
            c.ry(layer[q], offset + q)
        for q in range(width):
            c.cx(offset + q, offset + (q + 1) % width)


# ---------------------------------------------------------------------------
# On-device reductions (one program each; no state leaves the card)
# ---------------------------------------------------------------------------

@jax.jit
def _norm(state):
    return jnp.sum(jnp.real(state) ** 2 + jnp.imag(state) ** 2)


@jax.jit
def _pair_norm(re, im):
    return jnp.sum(re * re + im * im)


@jax.jit
def _dm_trace(rho):
    dim = 1 << ((rho.shape[0].bit_length() - 1) // 2)
    return jnp.trace(rho.reshape(dim, dim))


@jax.jit
def _qft_error(state, k):
    """max_j |sqrt(N) psi_j - exp(2 pi i j k / N)|; j*k mod N is exact in
    uint32 (N <= 2^32 wraps mod 2^32, then the mask takes it mod N)."""
    size = state.shape[0]
    j = jax.lax.iota(jnp.uint32, size)
    r = (j * k.astype(jnp.uint32)) & jnp.uint32(size - 1)
    phase = (2.0 * math.pi / size) * r.astype(jnp.float32)
    scale = math.sqrt(size)
    dr = jnp.real(state) * scale - jnp.cos(phase)
    di = jnp.imag(state) * scale - jnp.sin(phase)
    return jnp.max(jnp.sqrt(dr * dr + di * di))


def logical_state(circ):
    """The circuit's state in logical qubit order. Readbacks restore the
    order that swap elision and the sharded scheduler permute; a one-
    amplitude slice does it without moving the state to the host."""
    circ.get_statevector_slice(0, 1)
    return circ.state


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(count: int = 1) -> dict:
    """a. The backend is the GPU and the card an H100; nothing else runs."""
    backend = jax.default_backend()
    check(backend == "gpu", f"backend is {backend!r}, not 'gpu'")
    devices = jax.devices()
    kind = devices[0].device_kind
    check("H100" in kind, f"device_kind {kind!r} is not an H100")
    check(len(devices) >= count,
          f"need {count} cards, JAX sees {len(devices)}")
    return {"kind": kind, "count": len(devices)}


def phase_ansatz(n: int = ANSATZ_N, n_ref: int = ANSATZ_REF_N,
                 layers: int = ANSATZ_LAYERS, shots: int = 1000,
                 seed: int = 11) -> dict:
    """b. RY + CNOT-ring ansatz through Circuit: norm, Ising energy and
    shots at n; amplitudes and energy at n_ref against numpy (complex64
    against complex128)."""
    rng = np.random.default_rng(seed)
    c = rocq.Circuit(n, rocq.Simulator(seed=seed))
    ansatz(c, rng.uniform(0, 2 * math.pi, size=(layers, n)))
    c.flush()
    norm = float(_norm(c.state))
    check(abs(norm - 1.0) <= C64_NORM_TOL, f"n={n} norm {norm}")
    energy = c.expval(ising_operator(n))
    check(math.isfinite(energy) and abs(energy) <= 1.5 * n,
          f"n={n} energy {energy}")
    m = min(10, n)
    samples = c.sample(list(range(m)), shots)
    check(samples.shape == (shots,) and samples.min() >= 0
          and samples.max() < (1 << m), "shots out of range")
    p1 = float(c.get_probabilities([0])[1])
    freq = float(np.mean(samples & 1))
    sigma = math.sqrt(max(p1 * (1 - p1), 1e-6) / shots)
    check(abs(freq - p1) <= 5 * sigma + 1e-3,
          f"qubit-0 shot frequency {freq} against P(1)={p1}")
    del c

    thetas = rng.uniform(0, 2 * math.pi, size=(layers, n_ref))
    r = rocq.Circuit(n_ref, rocq.Simulator(seed=seed))
    ansatz(r, thetas)
    psi = r.get_statevector()
    ref = np_ansatz_state(n_ref, thetas)
    state_err = float(np.linalg.norm(psi - ref))
    check(state_err <= C64_STATE_TOL, f"n={n_ref} state error {state_err}")
    e_ref = np_ising_energy(ref)
    e_err = abs(r.expval(ising_operator(n_ref)) - e_ref)
    check(e_err <= C64_ENERGY_TOL, f"n={n_ref} energy error {e_err}")
    return {"norm_drift": abs(norm - 1.0), "energy": energy,
            "ref_state_err": state_err, "ref_energy_err": e_err}


def phase_qft(n: int = QFT_N, k: int = None) -> dict:
    """c. QFT of a basis state |k> through compile_program, compared on the
    device with exp(2 pi i j k / N) / sqrt(N)."""
    if k is None:
        k = (0x9E3779B9 % (1 << n)) | 1
    ir = CircuitIR(n, name=f"qft{n}_basis")
    for b in range(n):
        if (k >> b) & 1:
            ir.add("X", [b])
    ir.ops.extend(qft_ir(n).ops)
    prog = rocq.compile_program(ir, rocq.Simulator(seed=1))
    c = prog.run()
    err = float(_qft_error(logical_state(c), jnp.uint32(k)))
    check(err <= QFT_TOL, f"QFT n={n} k={k} max error {err}")
    return {"k": k, "max_err": err}


def phase_adjoint_grad(n: int = GRAD_N, layers: int = GRAD_LAYERS,
                       seed: int = 5) -> dict:
    """d. adjoint_grad of the Ising energy against parameter shift on two
    parameters (complex64)."""
    rng = np.random.default_rng(seed)
    params = rng.uniform(0, 2 * math.pi, size=layers * n)
    obs = ising_operator(n)

    def kern(q, *theta):
        ansatz(q, np.asarray(theta, dtype=object).reshape(layers, n))

    sim = rocq.Simulator(seed=seed)
    value, grads = rocq.adjoint_grad(kern, n, sim, params, obs,
                                     return_value=True)

    def energy(p):
        c = rocq.Circuit(n, sim)
        ansatz(c, np.asarray(p).reshape(layers, n))
        return c.expval(obs)

    errs = []
    for i in (0, layers * n - 1):
        plus, minus = params.copy(), params.copy()
        plus[i] += math.pi / 2
        minus[i] -= math.pi / 2
        shift = 0.5 * (energy(plus) - energy(minus))
        errs.append(abs(float(grads[i]) - shift))
    check(max(errs) <= GRAD_TOL, f"gradient errors {errs}")
    check(abs(value - energy(params)) <= C64_ENERGY_TOL,
          "adjoint_grad value differs from the forward energy")
    return {"grad_errs": errs, "energy": value}


def _np_density_run(n: int, thetas: np.ndarray, p: float) -> np.ndarray:
    """rho after layers of RY column, depolarizing(p) on every qubit, CNOT
    chain — dense complex128 matrices on n qubits."""
    dim = 1 << n
    eye2 = np.eye(2)
    paulis = [np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]]),
              np.diag([1.0, -1.0])]

    def embed(u, q):
        # qubit 0 is the least-significant index bit
        full = np.ones((1, 1))
        for b in range(n - 1, -1, -1):
            full = np.kron(full, u if b == q else eye2)
        return full

    rho = np.zeros((dim, dim), np.complex128)
    rho[0, 0] = 1.0
    for layer in thetas:
        for q in range(n):
            u = embed(np_ry(layer[q]), q)
            rho = u @ rho @ u.conj().T
        for q in range(n):
            rho = (1 - p) * rho + (p / 3) * sum(
                embed(s, q) @ rho @ embed(s, q).conj().T for s in paulis)
        for q in range(n - 1):
            idx = np.arange(dim)
            perm = np.where((idx >> q) & 1, idx ^ (1 << (q + 1)), idx)
            rho = rho[perm][:, perm]
    return rho


def _density_run(n: int, thetas: np.ndarray, p: float, seed: int):
    dc = DensityCircuit(n, rocq.Simulator(seed=seed))
    for layer in thetas:
        for q in range(n):
            dc.ry(float(layer[q]), q)
        for q in range(n):
            dc.apply_channel("depolarizing", p, [q])
        for q in range(n - 1):
            dc.cx(q, q + 1)
    dc.flush()
    return dc


def phase_density(n: int = DENSITY_N, n_ref: int = DENSITY_REF_N,
                  layers: int = 2, p: float = 0.02, seed: int = 3) -> dict:
    """e. DensityCircuit with depolarizing layers: Tr rho = 1 at n on the
    device; the whole rho at n_ref against numpy (complex64 against
    complex128)."""
    rng = np.random.default_rng(seed)
    dc = _density_run(n, rng.uniform(0, 2 * math.pi, size=(layers, n)), p,
                      seed)
    tr = complex(_dm_trace(dc.state))
    check(abs(tr - 1.0) <= TRACE_TOL, f"n={n} Tr rho = {tr}")
    z = dc.expval(rocq.PauliOperator({"Z0": 1.0}))
    check(math.isfinite(z) and abs(z) <= 1.0 + TRACE_TOL, f"<Z0> = {z}")
    del dc

    thetas = rng.uniform(0, 2 * math.pi, size=(layers, n_ref))
    rho = _density_run(n_ref, thetas, p, seed).get_density_matrix()
    err = float(np.max(np.abs(rho - _np_density_run(n_ref, thetas, p))))
    check(err <= DM_TOL, f"n={n_ref} density error {err}")
    return {"trace_err": abs(tr - 1.0), "ref_err": err}


def phase_double(n: int = DOUBLE_N, n_ref: int = DOUBLE_REF_N,
                 layers: int = 2, seed: int = 17) -> dict:
    """f. set_precision("double"): norm drift at n, amplitudes at n_ref
    against numpy (float64 against complex128)."""
    rng = np.random.default_rng(seed)
    rocq.set_precision("double")
    try:
        c = rocq.Circuit(n, rocq.Simulator(seed=seed))
        ansatz(c, rng.uniform(0, 2 * math.pi, size=(layers, n)))
        c.flush()
        state = c.state
        norm = float(_pair_norm(*state) if isinstance(state, tuple)
                     else _norm(state))
        drift = abs(norm - 1.0)
        check(drift <= F64_NORM_TOL, f"n={n} double norm drift {drift}")
        del c, state
        thetas = rng.uniform(0, 2 * math.pi, size=(layers, n_ref))
        r = rocq.Circuit(n_ref, rocq.Simulator(seed=seed))
        ansatz(r, thetas)
        err = float(np.max(np.abs(r.get_statevector()
                                  - np_ansatz_state(n_ref, thetas))))
        check(err <= F64_STATE_TOL, f"n={n_ref} double state error {err}")
    finally:
        rocq.set_precision("single")
    return {"norm_drift": drift, "ref_err": err}


def _ring_network(d: int, seed: int):
    from rocquantum_tpu.tensornet import Tensor, TensorNetwork
    rng = np.random.default_rng(seed)
    mats = [((rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
             / math.sqrt(2 * d)).astype(np.complex64) for _ in range(3)]
    tn = TensorNetwork()
    for m, labels in zip(mats, ("ab", "bc", "ca")):
        tn.add_tensor(Tensor.from_numpy(m, list(labels)))
    return tn, mats


def _contract_scalar(tn, slices: int) -> complex:
    cfg = {"num_slices": slices} if slices > 1 else {}
    return complex(np.asarray(tn.contract(cfg).to_numpy()).reshape(()))


def phase_tensornet(d: int = TN_DIM, d_ref: int = TN_REF_DIM,
                    slices: int = 4, seed: int = 2) -> dict:
    """g. Sliced ring contraction tr(ABC) at bond dimension d equals its
    unsliced form; at d_ref both equal numpy (complex64)."""
    tn, _ = _ring_network(d, seed)
    sliced = _contract_scalar(tn, slices)
    check(tn.last_num_slices >= slices,
          f"asked for {slices} slices, ran {tn.last_num_slices}")
    whole = _contract_scalar(tn, 1)
    rel = abs(sliced - whole) / max(abs(whole), 1e-30)
    check(rel <= TN_RTOL, f"d={d} sliced {sliced} unsliced {whole}")
    tn_ref, mats = _ring_network(d_ref, seed)
    ref = complex(np.trace(mats[0].astype(np.complex128) @ mats[1] @ mats[2]))
    ref_rel = abs(_contract_scalar(tn_ref, slices) - ref) / abs(ref)
    check(ref_rel <= TN_RTOL, f"d={d_ref} against numpy: rel {ref_rel}")
    return {"sliced_rel": rel, "ref_rel": ref_rel}


def sharded_ops(n: int, mesh, thetas: np.ndarray, offset: int):
    """The scheduled op list one flush of the sharded ansatz compiles."""
    from rocquantum_tpu.compiler.interpreter import parametrize
    from rocquantum_tpu.compiler.sharded_schedule import schedule_for_sharding
    from rocquantum_tpu.parallel import num_global_qubits
    rec = rocq.api._Recorder(n)
    ansatz(rec, thetas, offset)
    ops, values = parametrize(rec.ops)
    ops, _ = schedule_for_sharding(ops, n, num_global_qubits(mesh))
    return ops, len(values)


def phase_sharded(n: int = SHARDED_N, n_cmp: int = SHARDED_CMP_N,
                  cards: int = SHARDED_CARDS, layers: int = 2,
                  seed: int = 23) -> dict:
    """Four cards: an n-qubit state sharded over make_mesh(cards), whose
    ansatz runs on qubits 2..n-1 and so on the device-selecting (global)
    qubits, against the same n_cmp-qubit ansatz sharded and on card 0
    alone; the compiled flush holds all-to-all relabels and no
    all-gather (complex64)."""
    from rocquantum_tpu.compiler.interpreter import compile_ir
    from rocquantum_tpu.parallel import (count_collectives, make_mesh,
                                         state_sharding)
    check(n - n_cmp == 2, "the big state carries two extra qubits")
    mesh = make_mesh(cards)
    thetas = np.random.default_rng(seed).uniform(0, 2 * math.pi,
                                                 size=(layers, n_cmp))

    # |psi_n> = |psi_cmp> (x) |1> (x) |+>: amplitude 4j + 2 + b is
    # psi_cmp[j] / sqrt(2), every other amplitude is zero
    big = rocq.Circuit(n, rocq.Simulator(seed=seed), mesh=mesh)
    big.h(0)
    big.x(1)
    ansatz(big, thetas, offset=2)
    big.flush()
    small = rocq.Circuit(n_cmp, rocq.Simulator(seed=seed), mesh=mesh)
    ansatz(small, thetas)

    @jax.jit
    def embed_error(big_state, small_state):
        v = big_state.reshape(-1, 4)
        s = small_state * (1.0 / math.sqrt(2.0))
        return jnp.sqrt(_norm(v[:, 0]) + _norm(v[:, 1])
                        + _norm(v[:, 2] - s) + _norm(v[:, 3] - s))

    big_state = logical_state(big)
    check(len(big_state.sharding.device_set) == cards,
          "the big state is not sharded over every card")
    norm = float(_norm(big_state))
    check(abs(norm - 1.0) <= C64_NORM_TOL, f"n={n} sharded norm {norm}")
    small_state = logical_state(small)
    big_err = float(embed_error(big_state, small_state))
    check(big_err <= C64_STATE_TOL,
          f"n={n} sharded against n={n_cmp} sharded: {big_err}")
    del big, big_state

    alone = rocq.Circuit(n_cmp, rocq.Simulator(seed=seed))
    ansatz(alone, thetas)
    alone.flush()
    on_card0 = jax.device_put(small_state, alone.state.sharding)
    diff = on_card0 - alone.state
    card_err = float(jnp.sqrt(_norm(diff)))
    check(card_err <= C64_STATE_TOL,
          f"n={n_cmp} sharded against card 0 alone: {card_err}")
    del small, small_state, alone, on_card0, diff

    ops, n_params = sharded_ops(n, mesh, thetas, offset=2)
    sharding = state_sharding(mesh)
    fn = compile_ir(CircuitIR(n, ops), sharding=sharding, donate=False)
    hlo = jax.jit(fn).lower(
        jax.ShapeDtypeStruct((1 << n,), jnp.complex64, sharding=sharding),
        jax.ShapeDtypeStruct((n_params,), jnp.float32)).compile().as_text()
    counts = count_collectives(hlo)
    check(counts["all-to-all"] > 0, f"no all-to-all relabel: {counts}")
    check(counts["all-gather"] == 0, f"all-gather in the flush: {counts}")
    return {"norm_drift": abs(norm - 1.0), "embed_err": big_err,
            "card0_err": card_err, "collectives": counts}


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

class _CompileClock:
    """Sums JAX's tracing, lowering and backend-compile durations."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def _peak_bytes() -> list:
    return [d.memory_stats().get("peak_bytes_in_use", 0)
            for d in jax.local_devices()]


def run_phase(name: str, fn, clock: _CompileClock) -> dict:
    compile_before = clock.seconds
    t0 = time.perf_counter()
    result = fn()
    wall = time.perf_counter() - t0
    line = {"phase": name, "wall_s": wall,
            "compile_s": clock.seconds - compile_before,
            "peak_bytes_in_use": _peak_bytes(), "result": result}
    print(json.dumps(line, default=str), flush=True)
    return line


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the state sharded over four cards "
                             "and what it is compared with")
    args = parser.parse_args(argv)
    cards = SHARDED_CARDS if args.four_cards else 1
    device = phase_device(cards)
    print(json.dumps({"phase": "device", "result": device}), flush=True)
    print(json.dumps({"compile_cache": enable_compilation_cache()}),
          flush=True)
    clock = _CompileClock()
    if args.four_cards:
        phases = [("sharded", phase_sharded)]
    else:
        # double precision last: it turns on jax_enable_x64 for the process
        phases = [("ansatz", phase_ansatz), ("qft", phase_qft),
                  ("adjoint_grad", phase_adjoint_grad),
                  ("density", phase_density), ("tensornet", phase_tensornet),
                  ("double", phase_double)]
    for name, fn in phases:
        run_phase(name, fn, clock)
    print(card_line(), flush=True)
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
