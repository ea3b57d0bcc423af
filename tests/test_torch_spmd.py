"""The pipeline backend's pieces that need no stage group, in one process:
the GPipe hop lists against ``repro.pipeline.spmd._tick_perm``, the swap
route against ``stage_permutations``, the stage group's shortfall error, the
backend's refusals (each naming its limit), the snapshot strategies bound
to the group, the rank's shard of the seeded init and the shard partition
view the strategies see."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.swap import stage_permutations as jax_stage_permutations
from repro.pipeline.spmd import _swap_block_perm, _tick_perm
from repro_torch import tree as TR
from repro_torch.config import ModelConfig, RecoveryConfig, TrainConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core.stages import StagePartition
from repro_torch.core.swap import stage_permutations
from repro_torch.core.trainer import Trainer
from repro_torch.launch.mesh import make_stage_group
from repro_torch.models.model import Model
from repro_torch.pipeline import spmd

SMALL = dict(name="pp-llama", arch_type="dense", num_layers=8, d_model=32,
             num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
             max_seq_len=32, dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("num_stages", range(2, 7))
def test_tick_lists_equal_jax(num_stages):
    for m in range(1, 6):
        for t in range(m + num_stages - 1):
            assert spmd.route_tick_sends(t, list(range(num_stages)), m) \
                == _tick_perm(t, num_stages, m), (t, num_stages, m)


@pytest.mark.parametrize("num_stages", range(2, 7))
def test_swap_route_is_the_swapped_stage_order(num_stages):
    route = spmd.swap_route(num_stages)
    assert route == stage_permutations(num_stages)[1] == \
        jax_stage_permutations(num_stages)[1]
    # JAX hops the weights of stage route[d] to device d; the route sends
    # the activations through the stages in that order instead
    assert {(src, dst) for dst, src in enumerate(route) if src != dst} == \
        set(_swap_block_perm(num_stages))
    for m in range(1, 4):
        # every microbatch takes every hop of the route once
        hops = [h for t in range(m + num_stages - 1)
                for h in spmd.route_tick_sends(t, route, m)]
        assert sorted(hops) == sorted((route[i], route[i + 1])
                                      for _ in range(m)
                                      for i in range(num_stages - 1))


def test_stage_group_shortfall_names_one_device_per_stage(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="one device per stage"):
        make_stage_group(4)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        assert make_stage_group(1).rank == 0
        with pytest.raises(RuntimeError, match="one device per stage: "
                           "num_stages=2 but only 1 rank"):
            make_stage_group(2)
    finally:
        dist.destroy_process_group()


def tcfg(strategy="checkfree", stages=4):
    return TrainConfig(global_batch=8, microbatch=4, seq_len=16, steps=2,
                       recovery=RecoveryConfig(strategy=strategy,
                                               num_stages=stages))


@pytest.mark.parametrize("case,limit", [
    ("ssm", "dense/moe towers, not ssm"),
    ("sliding_window", "full attention only"),
    ("non_divisor", "num_layers 8 is not a multiple of num_stages 3"),
    ("hybrid", "dense/moe towers, not hybrid"),
    ("encdec", "dense/moe towers, not encdec"),
])
def test_spmd_refuses_by_name(case, limit):
    cfg, train = ModelConfig(**SMALL), tcfg()
    if case in ("ssm", "hybrid", "encdec"):
        arch = {"ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b",
                "encdec": "whisper-large-v3"}[case]
        cfg = reduced(get_config(arch))
    elif case == "sliding_window":
        cfg = cfg.replace(sliding_window=4)
    elif case == "non_divisor":
        train = tcfg(stages=3)
    with pytest.raises(ValueError, match=limit):
        Trainer(Model(cfg, device="cpu", weights=False), train,
                backend="spmd")
    with pytest.raises(ValueError, match="unknown backend"):
        Trainer(Model(cfg, device="cpu", weights=False), train,
                backend="mesh")


@pytest.mark.parametrize("strategy", ["checkpoint", "tiered_ckpt",
                                      "neighbor", "adaptive"])
def test_spmd_binds_the_snapshot_strategies_to_the_group(strategy, tmp_path):
    """The strategies that snapshot or restore state build on the backend
    (a group of one rank here) and get the group's all-reduce; ``adaptive``
    passes it and the in-mesh recovery on to its children."""
    assert spmd.refusal(ModelConfig(**SMALL), 4) is None
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        trainer = Trainer(Model(ModelConfig(**SMALL), device="cpu",
                                weights=False),
                          tcfg(strategy=strategy, stages=1), backend="spmd")
        got = trainer.strategy
        assert isinstance(got.group_reduce, spmd.GroupReduce)
        assert got.group_reduce([2.0, -1.0], "min") == [2.0, -1.0]
        assert got.group_reduce.share([3.5], 0, 1) == [3.5]
        if strategy == "adaptive":
            assert got.recover_in_mesh      # its checkfree child's
            for child in (got.low, got.high):
                assert child.group_reduce is got.group_reduce
            assert got.low._in_mesh_recover is got._in_mesh_recover
            assert got.high._in_mesh_recover is None   # checkpoint
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["dense", "granite-moe-3b-a800m"])
def test_init_shard_is_the_slice_of_the_seeded_init(arch):
    """Each rank's shard draws the whole run's init and keeps its slice:
    the shards put together are ``Model.init`` from the same seed, bit for
    bit, and no shard holds another rank's layers."""
    cfg = (ModelConfig(**SMALL) if arch == "dense" else
           reduced(get_config(arch)).replace(num_layers=4, dtype="float32"))
    part = StagePartition(cfg, 4)
    whole = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(3))
    shards = [spmd.init_shard(cfg, torch.Generator().manual_seed(3), "cpu",
                              part, r) for r in range(4)]
    for r, shard in enumerate(shards):
        lo, hi = part.stage_bounds(r)
        for (path, a), (_, b) in zip(TR.leaves_with_path(shard),
                                     TR.leaves_with_path(whole)):
            want = b[lo:hi] if path[0] == "blocks" else b
            assert a.shape == want.shape, path
            assert torch.equal(a, want), path


def test_shard_partition_sees_only_the_ranks_stage():
    cfg = ModelConfig(**SMALL)
    part = StagePartition(cfg, 4)
    whole = Model(cfg, device="cpu", weights=False).init(
        torch.Generator().manual_seed(0))
    shard = spmd.shard_params(whole, part, 1)
    view = spmd.ShardPartition(cfg, 4, 1)
    own = view.get_stage(shard, 1)
    assert all(a.data_ptr() == b.data_ptr() for a, b in
               zip(TR.leaves(own), TR.leaves(shard["blocks"])))
    assert all(a.shape[0] == 0 for a in TR.leaves(view.get_stage(shard, 2)))
    zeros = TR.map(torch.zeros_like, own)
    view.set_stage(shard, 2, zeros)           # another rank's: untouched
    assert not all(np.all(a.numpy() == 0) for a in TR.leaves(own))
    view.set_stage(shard, 1, zeros)
    assert all(np.all(a.numpy() == 0) for a in TR.leaves(shard["blocks"]))


@pytest.mark.parametrize("failed,reinit,srcs", [
    (2, "grad_norm", [1, 3]), (0, "grad_norm", [1]), (5, "uniform", [4]),
    (2, "twin_copy", [1]), (0, "copy_prev", [1]), (3, "copy_prev", [2])])
def test_recovery_sources_follow_recover_stage(failed, reinit, srcs):
    assert spmd.recovery_sources(failed, 6, reinit) == srcs
