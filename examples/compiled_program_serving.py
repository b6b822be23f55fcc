"""Serving-path walkthrough: rocq.compile_program + df64 precision.

A fixed-structure circuit executed repeatedly (the serving/benchmark hot
path) should pay host-side work ONCE: ``compile_program`` captures the
init program, the structure-cached flush plan, the final qubit layout and
the observable program, and ``run()`` replays the chain — optional
parameter-value overrides sweep angles with zero recompiles.

Second act: the same program structure at df64 precision (the double-
float engine, docs/FP64_GUIDE.md) — the readback contract is unchanged,
the result matches to ~1e-13.
"""

import numpy as np

import rocquantum_tpu as rocq
from rocquantum_tpu.compiler.ir import CircuitIR


def build_ir(n):
    ir = CircuitIR(n, name="serving_demo")
    for q in range(n):
        ir.add("RY", [q], params=[0.3 + 0.1 * q])
    for q in range(n - 1):
        ir.add("CNOT", [q + 1], controls=[q])
    ir.add("RZ", [n - 1], params=[0.25])
    return ir


def main():
    n = 6
    ir = build_ir(n)
    obs = rocq.PauliOperator({"Z0": 1.0, "Z5": 0.5})

    prog = rocq.compile_program(ir, rocq.Simulator(seed=1), observable=obs)
    v0 = prog.run()
    v1 = prog.run()          # replay: no re-enqueue, no re-hash
    assert abs(v0 - v1) < 1e-7

    # parameter sweep over the first RY angle: same compiled chain
    base = [0.3 + 0.1 * q for q in range(n)] + [0.25]
    sweep = []
    for theta in (0.1, 0.7, 1.3):
        vals = list(base)
        vals[0] = theta
        sweep.append(prog.run(vals))
    assert len({round(v, 9) for v in sweep}) == 3  # angles actually moved
    print("sweep <Z0 + 0.5 Z5>:", [round(v, 6) for v in sweep])

    # df64: double-float precision, identical program structure
    rocq.set_precision("df64")
    try:
        prog64 = rocq.compile_program(ir, rocq.Simulator(seed=1),
                                      observable=obs)
        v64 = prog64.run()
        assert abs(v64 - v0) < 1e-5, (v64, v0)  # f32 vs df64 agreement
        print(f"f32 {v0:.7f} vs df64 {v64:.7f}")
    finally:
        rocq.set_precision("single")
    print("SUCCESS")


if __name__ == "__main__":
    main()
