"""Each family's plain reference against the port at width 64 on the CPU:
the loss and every leaf's gradient, in the stage order and in CheckFree+'s
swapped one.  The test imports both; the reference files import nothing of
the port (``test_perfbench_imports.py``)."""
import pytest
import torch

from perfbench.tests import _tiny
from perfbench.lib import reftrain as R
from perfbench.lib import registry
from perfbench.lib import traffic as TF

from repro_torch.core.swap import swap_permutation
from repro_torch.models.model import build_model


def _port_loss_and_grads(cell, params, batch, order):
    from perfbench.lib import program as P
    cfg = P.port_config(cell.conf, cell.fam)
    model = build_model(cfg, device="cpu", weights=False)
    leaves = R.tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, _ = model.loss(leaves, batch, order=order)
    loss.backward()
    return float(loss.detach()), R.tree_map(lambda t: t.grad, leaves)


@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("swapped", [False, True])
def test_loss_and_gradients_match_the_port(family, swapped):
    cell = _tiny.cell(family)
    conf, fam = cell.conf, cell.fam
    params = R.make_params(fam, conf, 2 ** 33 + 5, "cpu")
    stream = TF.TokenStream(conf["vocab_size"], 2, 32, 11)
    batch = {k: torch.from_numpy(v) for k, v in stream.batch_at(0).items()}
    layers, stages = fam.num_layers(conf), conf["program"]["stages"]
    order = R.swap_order(layers, stages) if swapped else list(range(layers))
    assert order == (swap_permutation(layers, stages).tolist() if swapped
                     else list(range(layers)))
    grads = R.tree_map(torch.zeros_like, params)
    loss = R.loss_and_grads(fam, conf, params, batch["tokens"],
                            batch["labels"], order, 1.0, grads, R.FP32)
    port_loss, port_grads = _port_loss_and_grads(
        cell, params, batch, order if swapped else None)
    assert loss == pytest.approx(port_loss, rel=1e-6)
    for path, g in R.leaves_with_path(grads):
        want = R.get_path(port_grads, path)
        scale = float(want.abs().max()) + 1e-30
        assert float((g - want).abs().max()) <= 1e-5 * scale, R.name(path)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_weights_follow_the_seed_leaf_by_leaf(family):
    cell = _tiny.cell(family)
    a = R.make_params(cell.fam, cell.conf, 2 ** 35 + 1, "cpu")
    b = R.make_params(cell.fam, cell.conf, 2 ** 35 + 1, "cpu")
    c = R.make_params(cell.fam, cell.conf, 2 ** 35 + 2, "cpu")
    for (path, x), (_, y), (_, z) in zip(R.leaves_with_path(a),
                                         R.leaves_with_path(b),
                                         R.leaves_with_path(c)):
        assert torch.equal(x, y)
        assert torch.equal(x, R.make_leaf(cell.fam, cell.conf, path,
                                          2 ** 35 + 1, "cpu"))
        if x.std() > 0 and path[-1] not in ("a_log",):
            assert not torch.equal(x, z), R.name(path)


def test_the_port_runs_the_files_configuration():
    from perfbench.lib import program as P
    for name in ("h2o-danube-3-4b-12L", "mamba2-1.3b"):
        conf = registry.load_json(
            registry.ROOT / "perfbench" / "configs" / f"{name}.json")
        fam = registry.reference_module(registry.ROOT, conf["family"])
        cfg = P.port_config(conf, fam)
        assert cfg.num_layers == fam.num_layers(conf)
    bad = _tiny.conf("dense")
    bad["hidden_size"] = 96
    with pytest.raises(ValueError, match="d_model"):
        P.port_config(bad, registry.reference_module(registry.ROOT, "dense"))


def test_the_ssm_vocabulary_is_padded_as_the_checkpoint_is():
    from perfbench.lib import registry
    fam = registry.reference_module(registry.ROOT, "ssm")
    conf = registry.load_json(registry.ROOT / "perfbench" / "configs"
                              / "mamba2-1.3b.json")
    assert fam.dims(conf)[-1] == 50288
    assert fam.program_fields(conf)["vocab_size"] == 50288
    assert fam.dims(_tiny.conf("ssm"))[-1] == 256
