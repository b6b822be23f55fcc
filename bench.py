"""Benchmark probes for the simulator on one GPU.

    python bench.py                 # every probe, one final JSON line
    python bench.py --size 30       # one probe (also --ansatz, --qft,
                                    # --density, --tensornet, --fp64, --df64)

Each probe runs in a subprocess of its own, one after another, so that one
JAX process at a time holds the card; the parent never imports JAX. Every
probe prints one JSON line that names the device (platform, ``device_kind``,
device count, power limit); the parent prints each as it lands (with
``"bench_partial": true``) and ends with ONE merged record line, also when
its deadline (``ROCQ_BENCH_DEADLINE_S``) or a SIGTERM cuts the run.

Timing: host clock around work that ends in ``block_until_ready``, after a
warm-up call whose time is reported as ``compile_s``; each probe reports the
median and quartiles of its timed runs. Gate-layer probes also time a
device-to-device copy of the same state in the same process: ``vs_copy`` is
the copy time of one pass per gate over the measured layer time (above 1,
gates share passes).

The metrics, cells and their limits are not fixed here yet (ROADMAP, Speed
item 1); sizes can be cut through the ``ROCQ_BENCH_*`` size variables for a
smoke run on the CPU.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

BENCH_DEADLINE_S = float(os.environ.get("ROCQ_BENCH_DEADLINE_S", "2700"))
REPEATS = 5
_T0 = time.monotonic()


def _env_sizes(name, default):
    v = os.environ.get(name)
    if not v:
        return default
    return tuple(int(x) for x in v.replace(",", " ").split())


SIZES = _env_sizes("ROCQ_BENCH_SIZES", (30, 28, 26, 24))
PROBE_TIMEOUT_S = 900
QFT_N = int(os.environ.get("ROCQ_BENCH_QFT_N", "20"))
QFT_BIG_N = int(os.environ.get("ROCQ_BENCH_QFT_BIG_N", "26"))
DENSITY_N = int(os.environ.get("ROCQ_BENCH_DENSITY_N", "13"))
DENSITY_N2 = int(os.environ.get("ROCQ_BENCH_DENSITY_N2", "14"))
DENSITY_LAYERS = 2
FP64_N = int(os.environ.get("ROCQ_BENCH_FP64_N", "26"))
FP64_LAYERS = 2
TN_DIM = int(os.environ.get("ROCQ_BENCH_TN_DIM", "8192"))
TN_SLICES = 4


def _remaining() -> float:
    return BENCH_DEADLINE_S - (time.monotonic() - _T0)


# ---------------------------------------------------------------------------
# In-probe helpers (these run inside the probe subprocess, which owns JAX)
# ---------------------------------------------------------------------------

def _setup():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rocquantum_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()


def _device_record() -> dict:
    """Platform, device kind and count as JAX reports them, and the power
    limit from nvidia-smi where there is one."""
    import jax
    devs = jax.devices()
    power = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if out.returncode == 0:
            power = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "power_limit": power}


def _timed(fn, repeats: int = REPEATS):
    """(compile_s, run times) of ``fn``: the first call compiles and warms
    up; every call ends in block_until_ready."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return compile_s, times


def _stats(prefix: str, compile_s: float, times) -> dict:
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return {f"{prefix}_compile_s": compile_s, f"{prefix}_median_s": med,
            f"{prefix}_q1_s": q1, f"{prefix}_q3_s": q3}


def _peak_bytes() -> int:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _emit(rec: dict) -> int:
    rec["device"] = _device_record()
    rec["peak_bytes_in_use"] = _peak_bytes()
    print(json.dumps(rec), flush=True)
    return 0


def _copy_time(state_box) -> float:
    """Median time of one donated elementwise read+write pass over the
    state in ``state_box[0]`` — the copy the layer probes divide by."""
    import jax
    import jax.numpy as jnp
    scale = jax.jit(lambda x, s: x * s, donate_argnums=(0,))
    one = jnp.asarray(1.0, state_box[0].real.dtype)

    def call():
        state_box[0] = scale(state_box[0], one)
        return state_box[0]
    _, times = _timed(call)
    return float(np.median(times))


def _layer_probe(n: int, ir, gates_per_layer: int, prefix: str) -> int:
    """Time one compiled layer (the program Circuit.flush runs) applied in
    place to an n-qubit state, against a copy of that state."""
    import jax.numpy as jnp
    from rocquantum_tpu.compiler.interpreter import compile_ir
    from rocquantum_tpu.ops import statevec as sv
    import jax
    fn = compile_ir(ir)
    params = jnp.asarray(np.linspace(0.1, 1.0, n), jnp.float32)
    box = [jax.jit(lambda: sv.init_state(n))()]

    def call():
        box[0] = fn(box[0], params)
        return box[0]
    compile_s, times = _timed(call)
    norm = float(jnp.sum(jnp.abs(box[0]) ** 2))
    assert abs(norm - 1.0) < 1e-3, f"norm drifted: {norm}"
    copy_s = _copy_time(box)
    med = float(np.median(times))
    rec = {"n": n, f"{prefix}_gates_per_sec": gates_per_layer / med,
           "copy_s": copy_s,
           "vs_copy": gates_per_layer * copy_s / med, "norm": norm}
    rec.update(_stats(prefix, compile_s, times))
    return _emit(rec)


def run_single(n: int) -> int:
    """RY column (n gates) per layer."""
    _setup()
    from rocquantum_tpu.compiler.ir import CircuitIR, ParamRef
    ir = CircuitIR(n, name="bench_layer")
    for q in range(n):
        ir.add("RY", [q], params=[ParamRef(q)])
    return _layer_probe(n, ir, n, "layer")


def run_ansatz(n: int) -> int:
    """RY column + CNOT ring (2n gates) per layer — the VQE hot path."""
    _setup()
    from rocquantum_tpu.compiler.ir import CircuitIR, ParamRef
    ir = CircuitIR(n, name="bench_ansatz")
    for q in range(n):
        ir.add("RY", [q], params=[ParamRef(q)])
    for q in range(n):
        ir.add("CNOT", [(q + 1) % n], controls=[q])
    return _layer_probe(n, ir, 2 * n, "ansatz")


def run_qft(n: int) -> int:
    """QFT latency through rocq.compile_program: each run replays the
    compiled chain and reads <Z0> back to the host."""
    _setup()
    import rocquantum_tpu as rocq
    from rocquantum_tpu.models import qft_ir
    ir = qft_ir(n)
    prog = rocq.compile_program(ir, rocq.Simulator(),
                                observable=rocq.PauliOperator({"Z0": 1.0}))
    compile_s, times = _timed(prog.run)
    rec = {"qft_n": n, "qft_ops": len(ir.ops),
           "qft_ms": float(np.median(times)) * 1e3}
    rec.update(_stats("qft", compile_s, times))
    return _emit(rec)


def run_density(n: int) -> int:
    """RY + depolarizing layers on an n-qubit density matrix (flush and an
    expval read), as channel+gate ops per second."""
    _setup()
    import rocquantum_tpu as rocq
    from rocquantum_tpu.density_circuit import DensityCircuit
    sim = rocq.Simulator(seed=0)

    def run_once():
        dc = DensityCircuit(n, sim)
        for _ in range(DENSITY_LAYERS):
            for q in range(n):
                dc.ry(0.3 + 0.01 * q, q)
            for q in range(n):
                dc.apply_channel("depolarizing", 0.02, [q])
        dc.flush()
        return float(dc.expval(rocq.PauliOperator({"Z0": 1.0})))
    compile_s, times = _timed(run_once, repeats=3)
    n_ops = DENSITY_LAYERS * 2 * n
    rec = {"density_n": n,
           "density_ops_per_sec": n_ops / float(np.median(times))}
    rec.update(_stats("density", compile_s, times))
    return _emit(rec)


def run_tensornet() -> int:
    """Sliced ring contraction A(a,b) B(b,c) C(c,a) at bond TN_DIM, as
    complex-GEMM GFLOP/s (8 real flops per complex MAC)."""
    _setup()
    import jax
    from rocquantum_tpu.tensornet import Tensor, TensorNetwork
    from rocquantum_tpu.tensornet.contraction import OptimizerConfig
    rng = np.random.default_rng(0)
    d = TN_DIM
    tn = TensorNetwork()
    for labels in ("ab", "bc", "ca"):
        a = (rng.normal(size=(d, d)) / d).astype(np.complex64)
        tn.add_tensor(Tensor.from_numpy(a, list(labels)))
    cfg = OptimizerConfig.from_dict({"num_slices": TN_SLICES})
    jit_body, datas, _, _ = tn._build_runner(cfg)
    fn = jax.jit(jit_body)
    compile_s, times = _timed(lambda: fn(*datas), repeats=3)
    flops = 8.0 * d * d * d + 8.0 * d * d
    rec = {"tn_dim": d, "tn_slices": tn.last_num_slices,
           "tn_gflops": flops / float(np.median(times)) / 1e9}
    rec.update(_stats("tn", compile_s, times))
    return _emit(rec)


def run_fp64(n: int) -> int:
    """Double precision on the float-pair engine (what set_precision
    ("double") runs): RY layers, with the norm drift."""
    _setup()
    import jax
    jax.config.update("jax_enable_x64", True)
    from rocquantum_tpu import config
    config.set_precision("double")
    from rocquantum_tpu.ops import pairsim

    @jax.jit
    def prog(params):
        re, im = pairsim.init_pair(n)
        for _ in range(FP64_LAYERS):
            for q in range(n):
                rows, _ = pairsim.gate_rows("RY", (params[q],))
                re, im = pairsim.apply_matrix_pair(re, im, rows, None, [q])
        return pairsim.norm2_pair(re, im)

    params = jax.numpy.asarray(np.linspace(0.1, 1.0, n))
    compile_s, times = _timed(lambda: prog(params), repeats=3)
    drift = abs(float(prog(params)) - 1.0)
    assert drift < 1e-10, drift
    rec = {"fp64_n": n, "fp64_gates_per_sec":
           FP64_LAYERS * n / float(np.median(times)), "fp64_norm_drift": drift}
    rec.update(_stats("fp64", compile_s, times))
    return _emit(rec)


def run_df64(n: int) -> int:
    """Double precision on the double-float engine (set_precision("df64")):
    one RY layer per op on hi/lo f32 planes, with the norm drift."""
    _setup()
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from rocquantum_tpu import config
    config.set_precision("df64")
    from rocquantum_tpu.compiler.interpreter import execute_df64
    from rocquantum_tpu.compiler.ir import CircuitIR, ParamRef
    from rocquantum_tpu.ops import df64 as dfm
    ir = CircuitIR(n, name="bench_df64_layer")
    for q in range(n):
        ir.add("RY", [q], params=[ParamRef(q)])
    ops = list(ir.ops)

    @jax.jit
    def program(params):
        planes = execute_df64(dfm.init_df64(n), ops, params)
        re = dfm.promote_f64(planes[0], planes[1])
        im = dfm.promote_f64(planes[2], planes[3])
        return jnp.sum(re * re) + jnp.sum(im * im)

    params = jnp.asarray(np.linspace(0.1, 1.0, n), jnp.float64)
    compile_s, times = _timed(lambda: program(params), repeats=3)
    drift = abs(float(program(params)) - 1.0)
    assert drift < 1e-10, f"df64 norm drifted: {drift}"
    rec = {"df64_n": n, "df64_gates_per_sec": n / float(np.median(times)),
           "df64_norm_drift": drift}
    rec.update(_stats("df64", compile_s, times))
    return _emit(rec)


# ---------------------------------------------------------------------------
# Orchestration (parent process: never imports JAX)
# ---------------------------------------------------------------------------

_RECORD = {}
_RECORD_LOCK = threading.Lock()
_FINAL_EMITTED = False
_ACTIVE_PROC = None


def _bank(**fields):
    with _RECORD_LOCK:
        _RECORD.update(fields)
    line = dict(fields)
    line["bench_partial"] = True
    print(json.dumps(line), flush=True)


def _emit_final() -> None:
    global _FINAL_EMITTED
    with _RECORD_LOCK:
        if _FINAL_EMITTED:
            return
        _FINAL_EMITTED = True
        rec = dict(_RECORD)
    rec["bench_elapsed_s"] = time.monotonic() - _T0
    print(json.dumps(rec), flush=True)


def _stop(reason: str) -> None:
    proc = _ACTIVE_PROC
    if proc is not None:
        try:
            proc.kill()
        except OSError:
            pass
    _bank(bench_stopped=reason)
    _emit_final()
    os._exit(0)


def _install_guards():
    signal.signal(signal.SIGTERM,
                  lambda signum, _: _stop(signal.Signals(signum).name))
    signal.signal(signal.SIGINT,
                  lambda signum, _: _stop(signal.Signals(signum).name))
    t = threading.Timer(max(_remaining(), 1.0), _stop, args=("deadline",))
    t.daemon = True
    t.start()


def _probe_subprocess(args, key, timeout=PROBE_TIMEOUT_S):
    """Run this script with ``args`` in a subprocess and return its JSON
    line holding ``key``, or ``{"_error": reason}``."""
    global _ACTIVE_PROC
    timeout = max(20.0, min(float(timeout), _remaining() - 30.0))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                            + list(args), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    _ACTIVE_PROC = proc
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return {"_error": f"timeout after {round(timeout)}s"}
    finally:
        _ACTIVE_PROC = None
    if proc.returncode != 0:
        tail = (stderr or stdout or "").strip().splitlines()
        detail = tail[-1][-300:] if tail else "no output"
        return {"_error": f"exit code {proc.returncode}: {detail}"}
    for line in stdout.splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if key in rec:
            return rec
    return {"_error": "no JSON metric line in probe output"}


def main_orchestrate() -> int:
    _install_guards()
    probes = [(f"layer_n{n}", ["--size", str(n)], "layer_gates_per_sec")
              for n in SIZES]
    probes += [
        (f"ansatz_n{SIZES[0]}", ["--ansatz", str(SIZES[0])],
         "ansatz_gates_per_sec"),
        (f"qft_n{QFT_N}", ["--qft", str(QFT_N)], "qft_ms"),
        (f"qft_n{QFT_BIG_N}", ["--qft", str(QFT_BIG_N)], "qft_ms"),
        (f"density_n{DENSITY_N}", ["--density", str(DENSITY_N)],
         "density_ops_per_sec"),
        (f"density_n{DENSITY_N2}", ["--density", str(DENSITY_N2)],
         "density_ops_per_sec"),
        ("tn", ["--tensornet"], "tn_gflops"),
        (f"fp64_n{FP64_N}", ["--fp64", str(FP64_N)], "fp64_gates_per_sec"),
        (f"df64_n{FP64_N}", ["--df64", str(FP64_N)], "df64_gates_per_sec"),
    ]
    for label, args, key in probes:
        if _remaining() < 60:
            _bank(**{f"{label}_skipped": "deadline"})
            continue
        rec = _probe_subprocess(args, key)
        if "_error" in rec:
            _bank(**{f"{label}_error": rec["_error"]})
            continue
        if "device" not in _RECORD:
            _bank(device=rec["device"])
        _bank(**{f"{label}_{k}": v for k, v in rec.items()
                 if k != "device"})
    _emit_final()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--ansatz", type=int, default=None)
    parser.add_argument("--qft", type=int, default=None)
    parser.add_argument("--density", type=int, default=None)
    parser.add_argument("--tensornet", action="store_true")
    parser.add_argument("--fp64", type=int, default=None)
    parser.add_argument("--df64", type=int, default=None)
    args = parser.parse_args()
    if args.size is not None:
        return run_single(args.size)
    if args.ansatz is not None:
        return run_ansatz(args.ansatz)
    if args.qft is not None:
        return run_qft(args.qft)
    if args.density is not None:
        return run_density(args.density)
    if args.tensornet:
        return run_tensornet()
    if args.fp64 is not None:
        return run_fp64(args.fp64)
    if args.df64 is not None:
        return run_df64(args.df64)
    return main_orchestrate()


if __name__ == "__main__":
    sys.exit(main())
