"""chip_smoke.py: each phase at a small size on the CPU, the refusal of any
backend but the GPU, and (marked ``chip``) the whole script on the card."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("phase,kwargs", [
    ("ansatz", dict(n=11, n_ref=9, shots=400)),
    ("qft", dict(n=9)),
    ("adjoint_grad", dict(n=7)),
    ("density", dict(n=5, n_ref=4)),
    ("tensornet", dict(d=128, d_ref=32)),
    ("sharded", dict(n=14, n_cmp=12, cards=4)),
    ("double", dict(n=9, n_ref=7)),
])
def test_phase_at_small_size(phase, kwargs):
    result = getattr(cs, f"phase_{phase}")(**kwargs)
    assert isinstance(result, dict) and result


def test_qft_phase_detects_a_wrong_state():
    """The analytic QFT comparison is exact in its phase arithmetic: a
    different basis state fails it."""
    import jax.numpy as jnp
    import rocquantum_tpu as rocq
    from rocquantum_tpu.compiler.ir import CircuitIR
    from rocquantum_tpu.models import qft_ir
    n, k = 8, 37
    ir = CircuitIR(n)
    for b in range(n):
        if (k >> b) & 1:
            ir.add("X", [b])
    ir.ops.extend(qft_ir(n).ops)
    c = rocq.compile_program(ir, rocq.Simulator()).run()
    state = cs.logical_state(c)
    assert float(cs._qft_error(state, jnp.uint32(k))) < 1e-5
    assert float(cs._qft_error(state, jnp.uint32(k + 1))) > 0.1


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_a_non_gpu_backend(argv, capsys):
    with pytest.raises(cs.SmokeFailure, match="not 'gpu'"):
        cs.main(argv)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.chip
def test_smoke_script_on_the_card(gpu_backend, capsys):
    """The whole one-card run, in this process: a second process could not
    get the card's memory."""
    assert cs.main([]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
