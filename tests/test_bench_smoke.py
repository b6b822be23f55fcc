"""bench.py probe smoke tests (CPU, tiny sizes): every probe body must
execute, name its device and return a positive number, and the
orchestration must bank each probe and end with one merged record."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra=None, timeout=280):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")] + args,
        capture_output=True, text=True, timeout=timeout, env=env)
    assert out.returncode == 0, (
        f"bench {args} failed\nSTDOUT:{out.stdout}\nSTDERR:"
        f"{out.stderr[-2000:]}")
    return out.stdout


@pytest.mark.parametrize("args,key", [
    (["--size", "10"], "layer_gates_per_sec"),
    (["--ansatz", "10"], "ansatz_gates_per_sec"),
    (["--density", "4"], "density_ops_per_sec"),
    (["--fp64", "8"], "fp64_gates_per_sec"),
    (["--df64", "6"], "df64_gates_per_sec"),
])
def test_probe_runs(args, key):
    for line in _run(args).splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if key in rec:
            assert rec[key] > 0
            # every record names the device it ran on
            assert rec["device"]["platform"] == "cpu"
            assert rec["device"]["device_count"] >= 1
            assert "device_kind" in rec["device"]
            assert "power_limit" in rec["device"]
            return
    raise AssertionError(f"no {key} line in bench output")


def test_layer_probe_reports_spread_and_copy():
    rec = json.loads(_run(["--size", "10"]).strip().splitlines()[-1])
    assert rec["layer_q1_s"] <= rec["layer_median_s"] <= rec["layer_q3_s"]
    assert rec["copy_s"] > 0 and rec["vs_copy"] > 0
    assert rec["layer_compile_s"] > 0


def test_orchestration_emits_incrementally():
    """The full no-args orchestration at tiny CPU sizes: every probe's
    metric appears as its own flushed partial line AND in the final merged
    record."""
    out = _run([], env_extra={
        "ROCQ_BENCH_SIZES": "8",
        "ROCQ_BENCH_QFT_N": "6",
        "ROCQ_BENCH_QFT_BIG_N": "7",
        "ROCQ_BENCH_DENSITY_N": "3",
        "ROCQ_BENCH_DENSITY_N2": "4",
        "ROCQ_BENCH_FP64_N": "6",
        "ROCQ_BENCH_TN_DIM": "64",
        "ROCQ_BENCH_DEADLINE_S": "600",
    }, timeout=600)
    lines = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith("{")]
    partials = [ln for ln in lines if ln.get("bench_partial")]
    finals = [ln for ln in lines if "bench_elapsed_s" in ln]
    assert len(finals) == 1, out
    final = finals[0]
    assert final["device"]["platform"] == "cpu", final
    banked = {k for p in partials for k in p}
    for k in ("layer_n8_layer_gates_per_sec", "ansatz_n8_ansatz_gates_per_sec",
              "qft_n6_qft_ms", "qft_n7_qft_ms",
              "density_n3_density_ops_per_sec",
              "density_n4_density_ops_per_sec", "tn_tn_gflops",
              "fp64_n6_fp64_gates_per_sec", "df64_n6_df64_gates_per_sec"):
        assert k in banked and k in final, (k, sorted(banked), final)
    assert not any(k.endswith("_error") for k in final), final
