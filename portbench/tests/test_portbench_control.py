"""The control of every cell, the reference put in the program's place and
computed in TF32, comes out as not correct; the program at the same tiny
size comes out correct.  On the CPU, TF32 is the inputs rounded to its
10-bit mantissa (``reference.kl.round_tf32``); on the card the products
also run in TF32."""

import pytest
import torch

from portbench import harness
from portbench import traffic as T
from tiny import TINY, run_tiny

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _control(cell, seed, device):
    w = harness.find(BENCH["workloads"], cell, "workload")
    cfg = harness.merged(harness.load_config(BENCH, w["config"]), TINY["config"])
    lim = harness.merged(harness.load_limits(cell), TINY["limits"])
    return T.entry(T.load(w["traffic"])).control(cfg, lim, seed, device)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    checks = _control(cell, seed, "cpu")
    assert not all(ok for _, _, ok in checks.values())
    gap = checks.get("dist_gap") or checks.get("order_gap")
    assert not gap[2]


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    assert run_tiny(cell)["correct"] is True


def test_round_tf32_keeps_ten_mantissa_bits():
    from portbench.reference import round_tf32

    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 3.0, 1e-6])
    got = round_tf32(x)
    assert got[0] == x[0] and got[1] == 1.0 + 2**-10 and got[2] == 3.0
    assert torch.equal(round_tf32(got), got)
    assert float((got[3] - x[3]).abs() / x[3]) <= 2**-11


@pytest.mark.gpu
def test_control_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS:
        checks = _control(cell, 11, "cuda")
        assert not all(ok for _, _, ok in checks.values())
