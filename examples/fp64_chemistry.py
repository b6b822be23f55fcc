"""Chemistry-accuracy (double-precision) end-to-end walkthrough.

The reference selects fp64 at build time (ROCQ_PRECISION_DOUBLE,
hipStateVec.h:7-15); here one runtime call flips the whole framework —
and the state runs as (re, im) f64 float pairs (docs/FP64_GUIDE.md). This
example drives the full fp64 surface:

1. VQE-H2 with adjoint gradients at 1e-9 agreement vs parameter-shift
   (BASELINE north star: 1e-6)
2. the Circuit API — flush / expectation / measurement / sampling /
   readback — on the pair engine
3. the density engine with a Kraus channel at fp64
4. checkpoint/resume of the fp64 state
"""

import os
import tempfile

import numpy as np

import rocquantum_tpu as rocq
from rocquantum_tpu import config

rocq.set_precision("double")
assert rocq.get_precision() == "double"

# --- 1. VQE-H2 with adjoint gradients ---------------------------------------
H2 = {"I": -0.4804, "Z0": 0.3435, "Z1": -0.4347,
      "Z0 Z1": 0.5716, "X0 X1": 0.0910, "Y0 Y1": 0.0910}


@rocq.kernel
def ansatz(q, t0, t1, t2, t3):
    q.ry(t0, 0)
    q.ry(t1, 1)
    q.cx(0, 1)
    q.ry(t2, 0)
    q.ry(t3, 1)


h = rocq.PauliOperator(H2)
sim = rocq.Simulator(seed=0)
params = [0.41, -0.18, 0.77, 0.09]
g_shift = rocq.grad(ansatz, 2, sim, params, h)       # parameter-shift
g_adj = rocq.adjoint_grad(ansatz, 2, sim, params, h)  # one fwd+bwd sweep
err = float(np.max(np.abs(np.asarray(g_shift) - np.asarray(g_adj))))
print(f"adjoint vs parameter-shift gradient agreement: {err:.2e}")
assert err < 1e-9, err  # 1000x under the 1e-6 north star

# --- 2. the Circuit surface on the pair engine ------------------------------
c = rocq.Circuit(2, sim)
c.ry(0.5, 0)
c.cx(0, 1)
energy = c.expval(h)
psi = c.get_statevector()
assert psi.dtype == np.complex128
assert isinstance(c._state, tuple), "fp64 must run the float-pair engine"
assert abs(np.linalg.norm(psi) - 1.0) < 1e-12
probs = c.get_probabilities()
assert abs(float(np.sum(probs)) - 1.0) < 1e-12
outcome, prob = c.measure(0)
shots = c.sample([0, 1], 50)
# after collapsing qubit 0 of RY(0.5)+CNOT, both qubits agree
assert set(np.asarray(shots).tolist()) == {0 if outcome == 0 else 3}
print(f"fp64 circuit energy: {energy:.12f}; measured q0={outcome} "
      f"(p={prob:.6f})")

# --- 3. density engine with a Kraus channel at fp64 -------------------------
from rocquantum_tpu.density_circuit import DensityCircuit

dc = DensityCircuit(2, rocq.Simulator(seed=1))
dc.ry(0.5, 0)
dc.cx(0, 1)
dc.apply_channel("depolarizing", 0.02, [0])
noisy = dc.expval(h)
assert isinstance(dc._rho, tuple)
tr = float(np.trace(dc.get_density_matrix()).real)
assert abs(tr - 1.0) < 1e-12
print(f"fp64 noisy energy (2% depolarizing): {noisy:.12f}  (trace {tr:.12f})")

# --- 4. checkpoint / resume of the fp64 state -------------------------------
from rocquantum_tpu.utils.checkpoint import (restore_circuit_checkpoint,
                                             save_circuit_checkpoint)

with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "fp64_state.npz")
    save_circuit_checkpoint(path, c)
    c2 = rocq.Circuit(2, rocq.Simulator(seed=2))
    restore_circuit_checkpoint(path, c2)
    np.testing.assert_allclose(c2.get_statevector(), c.get_statevector(),
                               atol=0)
print("fp64 checkpoint round-trip: exact")

config.set_precision("single")
print("OK")
