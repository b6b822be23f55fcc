"""QAOA for MaxCut on a 6-ring: one jitted energy program, gradient descent
on (gamma, beta) via the adjoint path, sampled cuts beat random guessing.

The reference shipped QAOA nowhere; this exercises the models zoo
(qaoa_maxcut_ir), the fused interpreter, jax.grad through the circuit, and
shot sampling in one acceptance flow."""

import numpy as np
import jax
import jax.numpy as jnp

from rocquantum_tpu import config
from rocquantum_tpu.compiler.interpreter import execute
from rocquantum_tpu.models import qaoa_maxcut_ir
from rocquantum_tpu.ops import statevec as sv

N, P = 6, 2
EDGES = [(q, (q + 1) % N) for q in range(N)]


def main():
    ir = qaoa_maxcut_ir(N, P, EDGES)

    def cut_expectation(params):
        state = sv.init_state(N)
        state = execute(state, ir.ops, params)
        # MaxCut objective: sum over edges (1 - <Z_a Z_b>) / 2
        total = jnp.zeros((), config.real_dtype())
        for (a, b) in EDGES:
            total = total + 0.5 * (1.0 - sv.expval_pauli_product_z(
                state, [a, b]))
        return total

    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: -cut_expectation(p)))  # maximize the cut

    params = jnp.asarray([0.4, 0.7] * P, jnp.float32)
    for step in range(60):
        loss, g = value_and_grad(params)
        params = params - 0.08 * g
    best_cut = -float(loss)
    print(f"QAOA p={P} expected cut: {best_cut:.3f} / {len(EDGES)} edges")
    # random assignment cuts half the edges on average; the 6-ring optimum
    # is 6 — QAOA at p=2 must land clearly above random
    assert best_cut > 0.75 * len(EDGES), best_cut

    # sample bitstrings and check the best sampled cut reaches the optimum
    state = jax.jit(lambda p: sv.state_to_parts(
        execute(sv.init_state(N), ir.ops, p)))(params)
    psi = np.asarray(state[0]) + 1j * np.asarray(state[1])
    probs = np.abs(psi) ** 2
    samples = np.random.default_rng(0).choice(1 << N, size=400,
                                              p=probs / probs.sum())

    def cut_of(bits):
        return sum(1 for (a, b) in EDGES
                   if ((bits >> a) & 1) != ((bits >> b) & 1))

    best = max(cut_of(int(s)) for s in samples)
    print(f"best sampled cut: {best}")
    assert best == len(EDGES)  # the ring's optimal cut appears in samples
    print("QAOA MaxCut: OK")


if __name__ == "__main__":
    main()
