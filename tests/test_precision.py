"""Double-precision path (the ROCQ_PRECISION_DOUBLE analog,
hipStateVec.h:7-15): complex128 simulation with adjoint gradients matching
parameter-shift to 1e-6 (BASELINE.json north-star tolerance).

jax_enable_x64 is process-global, so these run in a subprocess.
"""

import os
import subprocess
import sys
import textwrap

import pytest

_SCRIPT = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import rocquantum_tpu as rocq
    rocq.set_precision("double")
    assert rocq.get_precision() == "double"

    from rocquantum_tpu import config
    import jax.numpy as jnp
    assert config.complex_dtype() == jnp.complex128

    sim = rocq.Simulator(seed=0)
    c = rocq.Circuit(2, sim)
    c.h(0); c.cx(0, 1)
    psi = c.get_statevector()
    assert psi.dtype == np.complex128
    assert abs(abs(psi[0]) - 2**-0.5) < 1e-12

    # adjoint vs parameter-shift at 1e-6 or better (fp64)
    H2 = {"I": 0.2333, "Z0": 0.3435, "Z1": -0.4347,
          "Z0 Z1": 0.5716, "X0 X1": 0.0910, "Y0 Y1": 0.0910}

    @rocq.kernel
    def ansatz(q, t0, t1, t2, t3):
        q.ry(t0, 0); q.ry(t1, 1); q.cx(0, 1); q.ry(t2, 0); q.ry(t3, 1)

    h = rocq.PauliOperator(H2)
    params = [0.37, -0.21, 0.9, 0.05]
    gs = rocq.grad(ansatz, 2, sim, params, h)
    ga = rocq.adjoint_grad(ansatz, 2, sim, params, h)
    err = np.max(np.abs(gs - ga))
    assert err < 1e-6, f"adjoint/parameter-shift mismatch at fp64: {err}"
    print("OK", err)
""")


def test_double_precision_subprocess():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    result = subprocess.run([sys.executable, "-c", _SCRIPT],
                            capture_output=True, text=True, timeout=300,
                            env=env)
    assert result.returncode == 0, (
        f"STDOUT:\n{result.stdout}\nSTDERR:\n{result.stderr[-2000:]}")
    assert "OK" in result.stdout


def test_double_precision_never_routes_through_pallas():
    """fp64 states keep complex128 through the full plan (fusion and
    consolidation) and match the analytic amplitude to 1e-12."""
    import jax.numpy as jnp
    from rocquantum_tpu import config as cfg
    from rocquantum_tpu.compiler.interpreter import execute
    from rocquantum_tpu.compiler.ir import CircuitIR, ParamRef
    from rocquantum_tpu.ops import statevec as svo

    cfg.set_precision("double")
    try:
        n = 15
        ir = CircuitIR(n)
        for q in range(n):
            ir.add("RY", [q], params=[ParamRef(q)])
        params = jnp.linspace(0.1, 1.4, n).astype(jnp.float64)
        out = execute(svo.init_state(n), ir.ops, params)
        assert out.dtype == jnp.complex128
        # fp64 accuracy: amplitude of |0...0> = prod(cos(theta/2)) to 1e-12
        import numpy as np
        expected = np.prod(np.cos(np.asarray(params) / 2))
        assert abs(complex(out[0]).real - expected) < 1e-12
    finally:
        cfg.set_precision("single")
