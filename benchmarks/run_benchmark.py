"""QFT benchmark harness.

API-parity rebuild of the reference benchmark
(reference: benchmarks/run_benchmark.py — QFT at 10-20 qubits step 2, 5
trials, mean wall-clock, device vs CPU comparison, optional log-scale plot
:36-37, :72-172). Runners: the rocq engine (fused and unfused) and a
numpy CPU reference (the default.qubit/Aer analog). Per-phase timers
(compile vs execute) replace the reference's single wall-clock, and results
are written as JSON next to the plots.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def qft_numpy(n: int, state: np.ndarray) -> np.ndarray:
    """CPU reference: QFT is the DFT matrix on the index space."""
    # The circuit-convention QFT includes the bit reversal; with swaps it is
    # exactly the unitary DFT.
    return np.fft.fft(state, norm="ortho")


def run_rocq(n: int, trials: int, fuse: bool):
    import jax
    import jax.numpy as jnp
    from rocquantum_tpu.compiler.interpreter import compile_ir
    from rocquantum_tpu.models import qft_ir
    from rocquantum_tpu.ops import statevec as sv

    ir = qft_ir(n)
    t0 = time.perf_counter()
    fn = compile_ir(ir, fuse=fuse, donate=False)
    params = jnp.zeros((0,), jnp.float32)
    state = jax.jit(lambda: sv.init_state(n))()
    out = fn(state, params)
    out.block_until_ready()
    compile_and_first = time.perf_counter() - t0

    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = fn(state, params)
        out.block_until_ready()
        times.append(time.perf_counter() - t0)
    return {
        "compile_s": compile_and_first,
        "mean_exec_s": float(np.mean(times)),
        "min_exec_s": float(np.min(times)),
        "gates": len(ir.ops),
    }


def run_numpy(n: int, trials: int):
    state = np.zeros(1 << n, np.complex64)
    state[0] = 1.0
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        qft_numpy(n, state)
        times.append(time.perf_counter() - t0)
    return {"mean_exec_s": float(np.mean(times))}


def verify(n: int):
    """QFT correctness: engine result == DFT of the input state."""
    import jax
    import jax.numpy as jnp
    from rocquantum_tpu.compiler.interpreter import compile_ir
    from rocquantum_tpu.models import qft_ir
    from rocquantum_tpu.ops import statevec as sv

    rng = np.random.default_rng(0)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v = (v / np.linalg.norm(v)).astype(np.complex64)
    re = jnp.asarray(v.real)
    im = jnp.asarray(v.imag)

    fn = compile_ir(qft_ir(n), donate=False)

    @jax.jit
    def run(re, im):
        state = (re + 1j * im).astype(jnp.complex64)
        out = fn(state, jnp.zeros((0,), jnp.float32))
        return jnp.real(out), jnp.imag(out)

    orr, oi = run(re, im)
    got = np.asarray(orr) + 1j * np.asarray(oi)
    # circuit QFT convention: F[j,k] = w^{jk}/sqrt(N) = inverse numpy DFT
    expected = np.fft.ifft(v, norm="ortho")
    assert np.allclose(got, expected, atol=1e-4), \
        f"QFT mismatch at n={n}: max err {np.abs(got - expected).max()}"


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--min-qubits", type=int, default=10)
    parser.add_argument("--max-qubits", type=int, default=20)
    parser.add_argument("--step", type=int, default=2)
    parser.add_argument("--trials", type=int, default=5)
    parser.add_argument("--verify-qubits", type=int, default=8)
    parser.add_argument("--output", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results.json"))
    parser.add_argument("--plot", action="store_true")
    args = parser.parse_args()

    verify(args.verify_qubits)
    print(f"QFT verification at {args.verify_qubits} qubits: OK")

    results = []
    for n in range(args.min_qubits, args.max_qubits + 1, args.step):
        row = {"n": n}
        row["rocq_fused"] = run_rocq(n, args.trials, fuse=True)
        row["rocq_unfused"] = run_rocq(n, args.trials, fuse=False)
        row["numpy_cpu"] = run_numpy(n, args.trials)
        speedup = row["numpy_cpu"]["mean_exec_s"] / \
            row["rocq_fused"]["mean_exec_s"]
        print(f"n={n:2d}: rocq {row['rocq_fused']['mean_exec_s']*1e3:8.2f} ms"
              f"  (unfused {row['rocq_unfused']['mean_exec_s']*1e3:8.2f} ms)"
              f"  numpy-FFT {row['numpy_cpu']['mean_exec_s']*1e3:8.2f} ms"
              f"  speedup vs CPU-FFT {speedup:6.2f}x")
        results.append(row)

    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.output}")

    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            ns = [r["n"] for r in results]
            plt.figure()
            for key in ("rocq_fused", "rocq_unfused", "numpy_cpu"):
                plt.semilogy(ns, [r[key]["mean_exec_s"] for r in results],
                             marker="o", label=key)
            plt.xlabel("qubits")
            plt.ylabel("mean wall-clock (s)")
            plt.legend()
            plt.title("QFT benchmark")
            path = os.path.join(os.path.dirname(args.output),
                                "qft_benchmark.png")
            plt.savefig(path, dpi=120)
            print(f"wrote {path}")
        except ImportError:
            print("(matplotlib unavailable; skipping plot)")


if __name__ == "__main__":
    main()
