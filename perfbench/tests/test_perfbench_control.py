"""The control: the plain reference in the program's place, with every
product's operands in float8 (the precision below the configuration's
bfloat16), must come out not correct.

On the CPU at width 64 against the float32 program's tight limits; on the
card (``gpu``) at each cell's own size against the cell's own limits, one
seed (``perfbench/calibrate.py`` reads the dozen and more that the limits
were set from)."""
import pytest

from perfbench.tests import _tiny
from perfbench import calibrate
from perfbench.lib import registry


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_the_control_fails_the_limits_at_width_64(family):
    cell = _tiny.cell(family)
    rep = calibrate.readings(cell, [2 ** 31 + 1], [2 ** 31 + 1], "cpu")
    program = rep["program"][2 ** 31 + 1]
    assert all(v <= 1e-4 for v in program.values()), program
    for kind in ("control", "half_batch", "grad_doubled"):
        got = rep[kind][2 ** 31 + 1]
        assert any(v > 1e-4 for v in got.values()), (kind, got)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["danube-12L.train4k.churn16",
                                      "mamba2.train512.churn16"])
def test_the_control_fails_the_cells_limits_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = registry.cell(workload)
    seed = 2 ** 31 + 77
    rep = calibrate.readings(cell, [seed], [seed], torch.device("cuda"))
    limits = cell.limits["limits"]
    program = rep["program"][seed]
    assert all(program[k] <= limits[k] for k in limits), program
    for kind in ("control", "half_batch", "grad_doubled"):
        got = rep[kind][seed]
        assert any(got[k] > limits[k] for k in limits), (kind, got)


@pytest.mark.gpu
def test_a_replayed_window_batch_fails_the_cells_limits_on_the_card(
        monkeypatch):
    """mamba2's checked steps open with a CUDA-graph window of 8: feeding
    each of its steps the window's first batch must fail the limits."""
    import json

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench.lib import bench as B
    from perfbench.lib import check as CK
    from perfbench.tests.test_perfbench_faults import _first_batch_replayed

    cell = registry.cell("mamba2.train512.churn16")
    seed = 2 ** 31 + 78
    device = torch.device("cuda")
    with monkeypatch.context() as m:
        _first_batch_replayed(m)
        first, checked, sched, batches, stages = calibrate.program_side(
            cell, seed, device)
    ref = B.follow_reference(cell, seed, device, batches, sched.by_wall,
                             stages)
    got = CK.numbers(first, checked, ref)
    print(json.dumps({"replayed_first_batch": got}))
    limits = cell.limits["limits"]
    assert any(got[k] > limits[k] for k in limits), got
