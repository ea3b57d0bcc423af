"""The port's state store and checkpoints (``repro_torch.statestore``,
``repro_torch.ckpt``): the cases of tests/test_statestore.py and of the
checkpoint tests in tests/test_optim_ckpt_configs.py on the port, snapshots
read across packages in both directions (bit-exact), and the in-place
state: a snapshot must not alias the tensors that the next Adam step
updates.
"""
import contextlib
import io
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.ckpt.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.optim.adam import OptState as JOptState
from repro.statestore import codec as jcodec
from repro_torch import tree as TR
from repro_torch.ckpt.checkpoint import (CheckpointError, Checkpointer,
                                         clean_stale_tmp, latest_step,
                                         load_checkpoint, save_checkpoint)
from repro_torch.config import (ModelConfig, OptimizerConfig, RecoveryConfig,
                                TrainConfig)
from repro_torch.configs import ARCHS
from repro_torch.core.stages import StagePartition
from repro_torch.core.state import History, TrainState
from repro_torch.core.trainer import Trainer
from repro_torch.core.walltime import TierSpec, WallClockModel
from repro_torch.data.pipeline import WindowPrefetcher, make_batches
from repro_torch.models.model import Model
from repro_torch.optim.adam import OptState, init_adam
from repro_torch.recovery import FailureContext, make_strategy
from repro_torch.statestore import (AsyncSnapshotter, CodecError, DiskTier,
                                    MemoryTier, RetentionPolicy,
                                    SnapshotWriteError, StateStore,
                                    StoreError, TierError, copy_into, decode,
                                    encode, host_snapshot, snapshot_to_tree)
from repro_torch.statestore.faults import FaultInjectingDiskTier

SPECS = WallClockModel().tier_specs()

CFG = ModelConfig(
    name="ss-llama", arch_type="dense", num_layers=4, d_model=32,
    num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=128, max_seq_len=32,
    dtype="float32", param_dtype="float32")
STAGES = 4


class ForcedSchedule:
    def __init__(self, events):
        self._events = dict(events)

    def at(self, step):
        return self._events.get(step, [])


def make_trainer(rcfg, steps=8, events=None):
    tcfg = TrainConfig(global_batch=4, microbatch=4, seq_len=32, steps=steps,
                       eval_every=100,
                       optimizer=OptimizerConfig(lr=1e-3, total_steps=steps,
                                                 warmup_steps=2),
                       recovery=rcfg)
    sched = ForcedSchedule(events) if events else None
    return Trainer(Model(CFG, device="cpu", weights=False), tcfg,
                   schedule=sched)


def batches():
    return make_batches(CFG, batch=4, seq=32, seed=0)


def as_bytes(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8) \
        .numpy().tobytes()


def tensor_of(dtype_name, raw):
    """``raw`` (float64 numpy) as a tensor of ``dtype_name``."""
    raw = np.asarray(raw)
    if dtype_name == "bfloat16":
        return torch.from_numpy(raw.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(raw.astype(dtype_name))


# ---------------------------------------------------------------------------
# codec: dtype preservation (bf16 round-trips bit-exactly)
# ---------------------------------------------------------------------------

def _config_dtypes():
    """Every dtype any model config trains with, plus the extended set a
    future config could pick up (as tests/test_statestore.py)."""
    names = set()
    for cfg in ARCHS.values():
        names.update({cfg.dtype, cfg.param_dtype})
    names.update({"bfloat16", "float16", "float32", "int32", "int8",
                  "uint16", "bool"})
    return sorted(names)


@pytest.mark.parametrize("dtype_name", _config_dtypes())
def test_codec_roundtrip_preserves_dtype(dtype_name):
    rng = np.random.default_rng(sum(map(ord, dtype_name)))
    for shape in [(3,), (2, 5), (1, 2, 3), ()]:
        arr = tensor_of(dtype_name, np.abs(rng.standard_normal(shape)) * 3)
        tree = {"leaf": arr, "nested": {"x": torch.zeros_like(arr)}}
        snap = host_snapshot(tree, step=1, shard_id="full")
        back = snapshot_to_tree(decode(encode(snap)), tree)
        assert back["leaf"].dtype == arr.dtype, (dtype_name, shape)
        assert back["leaf"].shape == arr.shape, (dtype_name, shape)
        assert as_bytes(back["leaf"]) == as_bytes(arr), (dtype_name, shape)


def test_host_snapshot_copies_into_owned_buffers_bit_identical():
    """Mixed dtypes, shapes and the host-int Adam step: the snapshot lists
    the leaves in JAX's order, bit-identical, in memory of its own."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(7, 33, generator=gen)
    tree = ({"w": w, "b16": torch.randn(4, 130, generator=gen).bfloat16(),
             "idx": torch.arange(11, dtype=torch.int32),
             "nested": {"scalar": torch.tensor(3.25)}},
            OptState({"x": torch.ones(2)}, {"x": torch.ones(2)}, 9))
    snap = host_snapshot(tree, step=5, shard_id="full")
    leaves, _ = TR.flatten(tree)
    assert len(snap.leaves) == len(leaves) == 7
    for got, ref in zip(snap.leaves[:-1], leaves[:-1]):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert as_bytes(got) == as_bytes(ref)
        assert got.data_ptr() != ref.data_ptr()
    assert snap.leaves[-1].dtype == torch.int32 and snap.leaves[-1].shape == ()
    assert int(snap.leaves[-1]) == 9
    before = as_bytes(snap.leaves[3])
    w.add_(1.0)                         # the next Adam step, in place
    assert as_bytes(snap.leaves[3]) == before
    assert snapshot_to_tree(snap)[1].step == 9


def test_codec_template_mismatch_raises():
    tree = {"a": torch.ones(2, 3)}
    snap = decode(encode(host_snapshot(tree, step=0, shard_id="full")))
    with pytest.raises(CodecError, match="shape"):
        snapshot_to_tree(snap, {"a": torch.ones(3, 2)})
    with pytest.raises(CodecError, match="dtype"):
        snapshot_to_tree(snap, {"a": torch.ones(2, 3, dtype=torch.int32)})
    with pytest.raises(CodecError, match="leaves"):
        snapshot_to_tree(snap, {"a": torch.ones(2, 3), "b": torch.ones(())})


def test_codec_rejects_garbage_and_truncation():
    with pytest.raises(CodecError):
        decode(b"this is not an npz file")
    blob = encode(host_snapshot({"a": torch.arange(4.0)}, step=0,
                                shard_id="full"))
    with pytest.raises(CodecError):
        decode(blob[: len(blob) // 2])


# ---------------------------------------------------------------------------
# the format, across packages
# ---------------------------------------------------------------------------

def _jax_tree_and_port_tree(dtype):
    """The same (params, Adam state) in both packages: random params of a
    small dense model in ``dtype``, moments, and the step as JAX's 0-d
    int32 / the port's host int."""
    rng = np.random.default_rng(3)
    shapes = {"blocks": {"attn": {"wq": (4, 32, 32)}, "ln": (4, 32)},
              "embed": {"table": (128, 32)}}
    jp, tp, jm, tm = {}, {}, {}, {}

    def fill(spec, jd, td, jmd, tmd):
        for k, v in spec.items():
            if isinstance(v, dict):
                jd[k], td[k], jmd[k], tmd[k] = {}, {}, {}, {}
                fill(v, jd[k], td[k], jmd[k], tmd[k])
                continue
            x = rng.standard_normal(v).astype(np.float32)
            m = rng.standard_normal(v).astype(np.float32)
            jd[k] = jnp.asarray(x).astype(dtype)
            td[k] = torch.from_numpy(x).to(
                torch.bfloat16 if dtype == "bfloat16" else torch.float32)
            jmd[k], tmd[k] = jnp.asarray(m), torch.from_numpy(m)

    fill(shapes, jp, tp, jm, tm)
    jtree = (jp, JOptState(jm, jax.tree.map(lambda a: a * 2, jm),
                           jnp.asarray(7, jnp.int32)))
    ttree = (tp, OptState(tm, TR.map(lambda a: a * 2, tm), 7))
    return jtree, ttree


def _assert_same_leaves(jtree, ttree):
    jleaves = jax.tree_util.tree_leaves(jtree)
    tleaves, _ = TR.flatten(ttree)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        j = np.asarray(j)
        if isinstance(t, int):
            assert j.dtype == np.int32 and j.shape == () and int(j) == t
            continue
        assert tuple(j.shape) == tuple(t.shape)
        assert j.dtype.name == {torch.float32: "float32",
                                torch.bfloat16: "bfloat16"}[t.dtype]
        assert j.tobytes() == as_bytes(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_snapshot_is_the_jax_format(dtype):
    """The port's file holds the same members in the same order as JAX's:
    byte-identical manifest and raw leaves, and JAX's decode +
    snapshot_to_tree reads it against a JAX template."""
    jtree, ttree = _jax_tree_and_port_tree(dtype)
    blob = encode(host_snapshot(ttree, step=7, shard_id="full"))
    jblob = jcodec.encode(jcodec.host_snapshot(jtree, step=7,
                                               shard_id="full"))
    ours, theirs = np.load(io.BytesIO(blob)), np.load(io.BytesIO(jblob))
    assert list(ours.keys()) == list(theirs.keys())
    for key in theirs.keys():
        assert ours[key].dtype == theirs[key].dtype == np.uint8
        assert ours[key].tobytes() == theirs[key].tobytes(), key
    back = jcodec.snapshot_to_tree(jcodec.decode(blob), jtree)
    _assert_same_leaves(back, ttree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_read_across_packages(dtype, tmp_path):
    """A JAX ``Checkpointer`` file loads into the port's template, and the
    port's ``Checkpointer`` file into JAX's, bit for bit (params, moments,
    the step)."""
    jtree, ttree = _jax_tree_and_port_tree(dtype)
    JCheckpointer(str(tmp_path / "jax"), every=7).maybe_save(7, jtree)
    step, loaded = load_checkpoint(str(tmp_path / "jax"), ttree)
    assert step == 7
    _assert_same_leaves(jtree, loaded)
    _assert_same_leaves(jtree, ttree)
    Checkpointer(str(tmp_path / "torch"), every=7).maybe_save(7, ttree)
    step, jloaded = jax_load_checkpoint(str(tmp_path / "torch"), jtree)
    assert step == 7
    _assert_same_leaves(jloaded, ttree)


def test_legacy_jax_checkpoint_loads_into_the_port(tmp_path):
    """The older format (typed ``leaf_<i>`` arrays written by np.savez from
    JAX arrays, bf16 as ``|V2`` records) loads into the port's template."""
    jtree, ttree = _jax_tree_and_port_tree("bfloat16")
    np.savez(str(tmp_path / "ckpt_00000003.npz"),
             **{f"leaf_{i}": np.asarray(x)
                for i, x in enumerate(jax.tree_util.tree_leaves(jtree))})
    step, loaded = load_checkpoint(str(tmp_path), ttree)
    assert step == 3
    _assert_same_leaves(jtree, loaded)


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------

def _snap(shard_id, step, n=4, fill=1.0):
    return host_snapshot({"w": torch.full((n,), fill)}, step=step,
                         shard_id=shard_id)


def test_memory_tier_placement_and_drop_host():
    tier = MemoryTier(SPECS["mem"])
    tier.put(_snap("stage00", 1), host=1)
    tier.put(_snap("stage01", 1), host=2)
    assert tier.steps("stage00") == [1]
    assert tier.drop_host(1) == 1
    assert tier.steps("stage00") == []
    assert tier.steps("stage01") == [1]        # other hosts untouched
    with pytest.raises(TierError):
        tier.get("stage00", 1)


def test_memory_tier_capacity_eviction():
    small = TierSpec("mem", "memory", capacity_bytes=40, latency_s=0,
                     bandwidth_Bps=float("inf"))
    tier = MemoryTier(small)
    tier.put(_snap("s", 1))                     # 16 bytes each
    tier.put(_snap("s", 2))
    tier.put(_snap("s", 3))                     # evicts step 1
    assert tier.steps("s") == [2, 3]
    with pytest.raises(TierError, match="capacity"):
        tier.put(_snap("s", 4, n=100))


def test_disk_tier_roundtrip_and_listing(tmp_path):
    tier = DiskTier(SPECS["disk"], str(tmp_path))
    tier.put(_snap("stage00", 5, fill=5.0))
    tier.put(_snap("stage00", 7, fill=7.0))
    tier.put(_snap("stage01", 7))
    assert tier.steps("stage00") == [5, 7]
    got = tier.get("stage00", 5)
    torch.testing.assert_close(got.leaves[0], torch.full((4,), 5.0))
    tier.delete("stage00", 5)
    assert tier.steps("stage00") == [7]
    assert tier.used_bytes() > 0


def test_disk_tier_cleans_stale_tmp_on_startup(tmp_path):
    tier = DiskTier(SPECS["disk"], str(tmp_path))
    tier.put(_snap("stage00", 3))
    stale = tmp_path / "stage00-00000009.npz.tmp"
    stale.write_bytes(b"partial garbage")
    tier2 = DiskTier(SPECS["disk"], str(tmp_path))
    assert not stale.exists()
    assert tier2.steps("stage00") == [3]        # tmp never counted as a step


@pytest.mark.parametrize("op", ["put", "get"])
def test_disk_tier_retries_transient_faults(op, tmp_path):
    """Transient I/O faults under the retry seam are absorbed by the retry
    policy; past its attempts they surface as a TierError."""
    tier = FaultInjectingDiskTier(SPECS["disk"], str(tmp_path))
    tier._sleep = lambda s: None
    if op == "get":
        tier.put(_snap("s", 1, fill=3.0))
    tier.inject(op, times=2)
    if op == "put":
        tier.put(_snap("s", 1, fill=3.0))
    assert tier.get("s", 1).leaves[0].tolist() == [3.0] * 4
    assert tier.faults_remaining(op) == 0
    tier.inject(op, times=3)
    with pytest.raises(TierError, match="3 attempt"):
        tier.put(_snap("s", 2)) if op == "put" else tier.get("s", 1)


def _packages():
    """(package name, DiskTier with faults, RetryPolicy, StateStore,
    TierError, StoreError, snapshot of {"w": 4 x fill}) of JAX and the
    port."""
    from repro.statestore import faults as jfaults
    from repro.statestore import store as jstore
    from repro.statestore import tiers as jtiers
    from repro_torch.statestore.tiers import RetryPolicy

    def jsnap(shard_id, step, fill=1.0):
        return jcodec.host_snapshot({"w": jnp.full((4,), fill, jnp.float32)},
                                    step=step, shard_id=shard_id)

    return [("jax", jfaults.FaultInjectingDiskTier, jtiers.RetryPolicy,
             jstore.StateStore, jtiers.TierError, jstore.StoreError, jsnap),
            ("torch", FaultInjectingDiskTier, RetryPolicy, StateStore,
             TierError, StoreError,
             lambda shard_id, step, fill=1.0: _snap(shard_id, step,
                                                    fill=fill))]


@pytest.mark.parametrize("op", ["put", "get"])
@pytest.mark.parametrize("retry", ["none", "2", "4", "default"])
def test_disk_tier_retry_option_matches_jax(retry, op, tmp_path):
    """``DiskTier(retry=...)``: None fails at the first transient fault, a
    policy retries up to its attempts with the same backoff draws in both
    packages (the default policy, three attempts, as before)."""
    outcomes = {}
    for name, Tier, Retry, _, TierErr, _, snap in _packages():
        kw = {} if retry == "default" else {
            "retry": None if retry == "none" else
            Retry(attempts=int(retry), base_delay_s=0.01)}
        tier = Tier(SPECS["disk"], str(tmp_path / name / op), **kw)
        slept = []
        tier._sleep = slept.append
        if op == "get":
            tier.put(snap("s", 1, fill=3.0))
        tier.inject(op, times=2)
        try:
            if op == "put":
                tier.put(snap("s", 1, fill=3.0))
            got = np.asarray(tier.get("s", 1).leaves[0]).tolist()
        except TierErr as e:
            got = str(e).split(": ")[0]
        outcomes[name] = (got, slept, tier.faults_remaining(op))
    assert outcomes["torch"] == outcomes["jax"]
    got, slept, _ = outcomes["torch"]
    if retry in ("none", "2"):
        assert isinstance(got, str) and f"after {1 if retry == 'none' else 2}"\
            f" attempt" in got
    else:
        assert got == [3.0] * 4 and len(slept) == 2


@pytest.mark.parametrize("max_step", [None, 7, 5, 4, 2, 0])
def test_store_restore_at_or_below_max_step_matches_jax(max_step, tmp_path):
    """``StateStore.restore(max_step=...)``: the freshest intact copy at or
    below the bound (the first copy read is corrupted, so the restore falls
    back to the next one), StoreError when none is left; both packages
    serve the same step."""
    served = {}
    for name, Tier, _, Store, _, StoreErr, snap in _packages():
        tier = Tier(SPECS["disk"], str(tmp_path / name))
        store = Store([tier], snapshot_depth=1)
        template = {"w": (jnp.zeros((4,), jnp.float32) if name == "jax"
                          else torch.zeros(4))}
        for step in (1, 3, 5, 7):
            tier.put(snap("s", step, fill=float(step)))
        tier.inject("get", times=1, exc=(jcodec.CodecError if name == "jax"
                                         else CodecError)("corrupt"))
        try:
            with pytest.warns(RuntimeWarning, match="skipping") if \
                    max_step != 0 else contextlib.nullcontext():
                res = store.restore("s", template, max_step=max_step)
            served[name] = (res.step, res.tier,
                            np.asarray(res.tree["w"]).tolist())
        except StoreErr:
            served[name] = None
        store.close()
    assert served["torch"] == served["jax"]
    want = {None: 5, 7: 5, 5: 3, 4: 1, 2: None, 0: None}[max_step]
    assert (served["torch"] or [None])[0] == want


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_store_snapshot_depth_bounds_the_writes_in_flight(depth, tmp_path):
    """``StateStore(snapshot_depth=...)``: the asynchronous writer queues at
    most ``depth`` writes, as JAX's does; every write still lands."""
    from repro.statestore.store import StateStore as JStateStore
    jstore = JStateStore([MemoryTier(SPECS["mem"])], snapshot_depth=depth)
    store = StateStore([DiskTier(SPECS["disk"], str(tmp_path))],
                       RetentionPolicy(keep={"disk": 100}),
                       snapshot_depth=depth)
    assert store.writer.depth == jstore.writer.depth == depth
    assert store.writer._q.maxsize == jstore.writer._q.maxsize == depth
    for step in range(1, 2 * depth + 2):
        store.put({"w": torch.full((4,), float(step))}, step=step,
                  shard_id="s", tier="disk")
    store.flush()
    assert store.tier("disk").steps("s") == list(range(1, 2 * depth + 2))
    store.close()
    jstore.close()


def test_retention_policy(tmp_path):
    tier = DiskTier(SPECS["disk"], str(tmp_path))
    policy = RetentionPolicy(keep={"disk": 2})
    for s in range(1, 6):
        tier.put(_snap("s", s))
        policy.apply(tier, "s")
    assert tier.steps("s") == [4, 5]


def test_tier_pricing_monotone():
    mem, disk, remote = SPECS["mem"], SPECS["disk"], SPECS["remote"]
    nbytes = 1e9
    assert mem.read_time_s(nbytes) < disk.read_time_s(nbytes) \
        < remote.read_time_s(nbytes)


# ---------------------------------------------------------------------------
# async snapshotter
# ---------------------------------------------------------------------------

def test_async_snapshotter_flush_and_order():
    snapper = AsyncSnapshotter()
    done = []
    for i in range(5):
        snapper.submit(lambda i=i: done.append(i))
    snapper.flush()
    assert done == [0, 1, 2, 3, 4]
    snapper.close()


def test_async_snapshotter_propagates_errors():
    snapper = AsyncSnapshotter()

    def boom():
        raise IOError("disk full")

    snapper.submit(boom)
    with pytest.raises(SnapshotWriteError, match="disk full"):
        snapper.flush()
    snapper.close()


# ---------------------------------------------------------------------------
# store: freshest-step-wins, corruption fallback
# ---------------------------------------------------------------------------

def test_store_serves_freshest_from_fastest(tmp_path):
    store = StateStore([MemoryTier(SPECS["mem"]),
                        DiskTier(SPECS["disk"], str(tmp_path))])
    tpl = {"w": torch.zeros(4)}
    store.put({"w": torch.full((4,), 3.0)}, step=3, shard_id="s",
              tier="disk")
    store.put({"w": torch.full((4,), 5.0)}, step=5, shard_id="s", tier="mem",
              host=0)
    res = store.restore("s", tpl)
    assert (res.step, res.tier) == (5, "mem")
    assert res.tree["w"].tolist() == [5.0] * 4
    # freshness beats tier speed: newer disk copy wins over older mem copy
    store.put({"w": torch.full((4,), 9.0)}, step=9, shard_id="s",
              tier="disk")
    res = store.restore("s", tpl)
    assert (res.step, res.tier) == (9, "disk")
    assert res.read_time_s > 0
    store.close()


def test_store_skips_corrupted_snapshot(tmp_path):
    store = StateStore([DiskTier(SPECS["disk"], str(tmp_path))])
    tpl = {"w": torch.zeros(4)}
    store.put({"w": torch.full((4,), 1.0)}, step=1, shard_id="s",
              tier="disk", sync=True)
    store.put({"w": torch.full((4,), 2.0)}, step=2, shard_id="s",
              tier="disk", sync=True)
    (tmp_path / "s-00000002.npz").write_bytes(b"garbage" * 10)
    with pytest.warns(RuntimeWarning, match="skipping"):
        res = store.restore("s", tpl)
    assert res.step == 1
    store.close()


def test_store_raises_when_empty(tmp_path):
    store = StateStore([DiskTier(SPECS["disk"], str(tmp_path))])
    with pytest.raises(StoreError):
        store.restore("nothing", {"w": torch.zeros(())})
    store.close()


# ---------------------------------------------------------------------------
# strategies: tiered_ckpt hot restore is bit-identical
# ---------------------------------------------------------------------------

def _bound_strategy(name, tmp_path, **rcfg_kw):
    rcfg = RecoveryConfig(strategy=name, num_stages=STAGES,
                          store_dir=str(tmp_path / "store"),
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          protect_edge_stages=False, **rcfg_kw)
    s = make_strategy(rcfg)
    part = StagePartition(CFG, STAGES)
    model = Model(CFG, device="cpu", weights=False)

    def init_fn():
        params = TR.map(lambda t: t.requires_grad_(),
                        model.init(torch.Generator().manual_seed(0)))
        return params, init_adam(params)

    s.bind(part, init_fn=init_fn)
    return s, part, init_fn


def test_tiered_hot_restore_bit_identical_unit(tmp_path):
    """after_step snapshots, then the state trains on in place and a stage
    fails: the restored stage is byte-for-byte the snapshotted params, in
    the same (live) tensors."""
    s, part, init_fn = _bound_strategy("tiered_ckpt", tmp_path)
    params, opt = init_fn()
    want = as_bytes(part.get_stage(params, 2)["attn"]["wq"])
    keep1 = TR.clone(part.get_stage(params, 1))
    state = TrainState(params, opt, effective_step=5)
    s.after_step(state, History())
    with torch.no_grad():                       # training moves on
        for p in TR.leaves(params):
            p.add_(0.25)
    drifted1 = TR.clone(part.get_stage(params, 1))
    hist = History()
    event = FailureContext(stage=2, wall_step=6,
                           generator=torch.Generator(), hist=hist)
    wq = params["blocks"]["attn"]["wq"]
    restored = s.on_failure(TrainState(params, opt, effective_step=6),
                            event)
    assert restored.params["blocks"]["attn"]["wq"] is wq
    assert wq.requires_grad
    got = as_bytes(part.get_stage(restored.params, 2)["attn"]["wq"])
    assert got == want                          # bit-identical, hot tier
    assert s.restore_log[-1][3] == "mem"
    assert hist.recovery_errors[-1][1] > 0      # the drift it undid
    # untouched stages keep the drifted values
    for a, b, c in zip(TR.leaves(part.get_stage(restored.params, 1)),
                       TR.leaves(drifted1), TR.leaves(keep1)):
        torch.testing.assert_close(a, b)
        assert not torch.equal(a, c)
    s.on_run_end()


def test_tiered_e2e_stage_failure_restores_from_hot_tier(tmp_path):
    rcfg = RecoveryConfig(strategy="tiered_ckpt", num_stages=STAGES,
                          checkpoint_every=4,
                          store_dir=str(tmp_path / "store"),
                          protect_edge_stages=False)
    tr = make_trainer(rcfg, steps=8, events={3: [1], 6: [2]})
    state, hist = tr.run(batches())
    assert [(w, s) for w, s in hist.failures] == [(3, 1), (6, 2)]
    assert [t for _, _, _, t in tr.strategy.restore_log] == ["mem", "mem"]
    # hot-tier restore of the current step: exactly zero recovery error
    assert all(err == 0.0 for _, err in hist.recovery_errors)
    assert not hist.truncated and state.effective_step == 8


def test_neighbor_survives_replica_holder_failure(tmp_path):
    rcfg = RecoveryConfig(strategy="neighbor", num_stages=STAGES,
                          checkpoint_every=2,
                          store_dir=str(tmp_path / "store"),
                          protect_edge_stages=False)
    tr = make_trainer(rcfg, steps=8, events={5: [1, 2]})
    state, hist = tr.run(batches())
    served = {stage: tier for _, stage, _, tier in tr.strategy.restore_log}
    # stage 1's replica lived on dead stage 2 -> disk; stage 2's replica
    # lived on surviving stage 3 -> memory
    assert served == {1: "disk", 2: "mem"}
    assert not hist.truncated and state.effective_step == 8


def test_neighbor_without_cold_tier_reinits_on_double_failure(tmp_path):
    rcfg = RecoveryConfig(strategy="neighbor", num_stages=STAGES,
                          neighbor_cold=False,
                          store_dir=str(tmp_path / "store"),
                          protect_edge_stages=False)
    tr = make_trainer(rcfg, steps=8, events={5: [1, 2]})
    state, hist = tr.run(batches())
    served = {stage: tier for _, stage, _, tier in tr.strategy.restore_log}
    assert served == {1: "init", 2: "mem"}
    assert not hist.truncated


def test_statestore_strategy_costs_priced_by_tiers():
    wall = WallClockModel()
    tiered = make_strategy(RecoveryConfig(strategy="tiered_ckpt"), wall=wall)
    neigh = make_strategy(RecoveryConfig(strategy="neighbor"), wall=wall)
    ckpt = make_strategy(RecoveryConfig(strategy="checkpoint"), wall=wall)
    assert tiered.iteration_cost() > wall.iter_time_s
    assert neigh.iteration_cost() > wall.iter_time_s
    assert tiered.failure_cost() < ckpt.failure_cost()
    mem = wall.tier_specs()["mem"]
    expected = mem.read_time_s(wall.stage_bytes(4))
    assert tiered.failure_cost() == pytest.approx(expected)


# ---------------------------------------------------------------------------
# checkpoints (the baseline the paper compares against)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_checkpoint_roundtrip(dtype, tmp_path):
    tree = {"a": torch.linspace(-3, 3, 6).reshape(2, 3).to(dtype),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    step, loaded = load_checkpoint(str(tmp_path), tree)
    assert step == 7
    for x, y in zip(TR.leaves(tree), TR.leaves(loaded)):
        assert y.dtype == x.dtype and as_bytes(y) == as_bytes(x)


def test_checkpointer_rollback_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), every=2, keep=2)
    tree = {"w": torch.zeros(3)}
    for step in range(1, 9):
        ck.maybe_save(step, TR.map(lambda x: x + step, tree))
    assert latest_step(str(tmp_path)) == 8
    step, loaded, lost = ck.rollback(11, tree)
    assert step == 8 and lost == 3
    assert loaded["w"].tolist() == [8.0] * 3


def test_checkpointer_no_checkpoint_raises(tmp_path):
    ck = Checkpointer(str(tmp_path), every=5)
    with pytest.raises(CheckpointError):
        ck.rollback(3, {"w": torch.zeros(())})


def test_load_checkpoint_real_exceptions(tmp_path):
    tpl = {"w": torch.zeros(3)}
    with pytest.raises(CheckpointError, match="no checkpoints"):
        load_checkpoint(str(tmp_path), tpl)
    save_checkpoint(str(tmp_path), 2, tpl)
    with pytest.raises(CheckpointError, match="step 5"):
        load_checkpoint(str(tmp_path), tpl, step=5)
    (tmp_path / "ckpt_00000002.npz").write_bytes(b"not an npz")
    with pytest.raises(CheckpointError):
        load_checkpoint(str(tmp_path), tpl, step=2)
    save_checkpoint(str(tmp_path), 3, {"w": torch.zeros(4)})
    with pytest.raises(CheckpointError):
        load_checkpoint(str(tmp_path), tpl, step=3)


def test_rollback_recovers_from_corrupted_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), every=1, keep=3)
    tpl = {"w": torch.zeros(3)}
    ck.maybe_save(1, {"w": torch.full((3,), 1.0)})
    ck.maybe_save(2, {"w": torch.full((3,), 2.0)})
    (tmp_path / "ckpt_00000002.npz").write_bytes(b"truncated garbage")
    with pytest.warns(RuntimeWarning, match="skipping"):
        step, tree, lost = ck.rollback(4, tpl)
    assert step == 1 and lost == 3
    assert tree["w"].tolist() == [1.0] * 3


def test_interrupted_save_never_corrupts_latest_step(tmp_path):
    tpl = {"w": torch.zeros(2)}
    save_checkpoint(str(tmp_path), 4, tpl)
    (tmp_path / "ckpt_00000009.npz.tmp").write_bytes(b"half a snapshot")
    (tmp_path / "ckpt_00000012.npz.tmp.npz").write_bytes(b"legacy tmp")
    assert latest_step(str(tmp_path)) == 4
    removed = clean_stale_tmp(str(tmp_path))
    assert sorted(removed) == ["ckpt_00000009.npz.tmp",
                               "ckpt_00000012.npz.tmp.npz"]
    assert latest_step(str(tmp_path)) == 4
    step, loaded = load_checkpoint(str(tmp_path), tpl)
    assert step == 4


def test_legacy_checkpoint_format_still_loads(tmp_path):
    tpl = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
           "b": torch.linspace(0, 1, 8).bfloat16()}
    np.savez(str(tmp_path / "ckpt_00000003.npz"),
             leaf_0=tpl["a"].numpy(),
             leaf_1=tpl["b"].view(torch.int16).numpy().view("V2"))
    step, loaded = load_checkpoint(str(tmp_path), tpl)
    assert step == 3
    for x, y in zip(TR.leaves(tpl), TR.leaves(loaded)):
        assert y.dtype == x.dtype and as_bytes(y) == as_bytes(x)


# ---------------------------------------------------------------------------
# the in-place state: snapshots own their memory, restores copy into it
# ---------------------------------------------------------------------------

def test_checkpoint_rollback_undoes_an_in_place_adam_step(tmp_path):
    """Save, one Adam step (which writes into p, m and v), roll back: the
    parameters, moments and Adam step equal the pre-step ones, in the same
    tensors, still trainable."""
    rcfg = RecoveryConfig(strategy="checkpoint", num_stages=STAGES,
                          checkpoint_every=1,
                          checkpoint_dir=str(tmp_path / "ckpt"))
    tr = make_trainer(rcfg)
    state = tr.init_state()
    batch = tr.device_batch(next(batches()))
    state, _, _ = tr.step(state, batch)
    tr.strategy.after_step(state, History())          # saves step 1
    saved = TR.clone(state.params), TR.clone(state.opt_state.m)
    live = TR.leaves(state.params)
    state, _, _ = tr.step(state, batch)
    assert not torch.equal(TR.leaves(state.params)[0], TR.leaves(saved[0])[0])
    hist = History()
    state = tr.strategy.handle_failure(state, FailureContext(
        stage=1, wall_step=2, generator=torch.Generator(), hist=hist))
    assert state.effective_step == 1 and state.opt_state.step == 1
    for a, b in zip(TR.leaves(state.params), TR.leaves(saved[0])):
        assert torch.equal(a, b)
    for a, b in zip(TR.leaves(state.opt_state.m), TR.leaves(saved[1])):
        assert torch.equal(a, b)
    assert all(a is b and a.requires_grad
               for a, b in zip(TR.leaves(state.params), live))
    assert np.isnan(hist.recovery_errors[0][1])


def test_restart_before_the_first_save_restores_the_run_start(tmp_path):
    """The trainer's init_fn gives the run's starting parameters again (a
    host copy taken at the start, since training updates the caller's
    tensors in place) with zero moments; the checkpoint strategy restarts
    from them at step 0."""
    rcfg = RecoveryConfig(strategy="checkpoint", num_stages=STAGES,
                          checkpoint_every=100,
                          checkpoint_dir=str(tmp_path / "ckpt"))
    tr = make_trainer(rcfg, steps=3, events={2: [1]})
    params = tr.init_params()
    start = TR.clone(params)
    state, hist = tr.run(batches(), params=params)
    assert hist.steps == [1, 2, 1, 2, 3]
    assert hist.loss[2] == hist.loss[0] and hist.loss[3] == hist.loss[1]
    fresh, opt = tr.fresh_init()
    for a, b in zip(TR.leaves(fresh), TR.leaves(start)):
        assert torch.equal(a, b)
    assert opt.step == 0 and all(not m.any() for m in TR.leaves(opt.m))


def test_replay_cache_serves_by_index_and_evicts():
    cache = WindowPrefetcher(iter(range(100)))
    assert [cache.get(i) for i in (0, 1, 2, 1, 5)] == [0, 1, 2, 1, 5]
    cache.evict_below(3)
    assert cache.cached == 3 and cache.get(4) == 4
    with pytest.raises(KeyError, match="replay_horizon"):
        cache.get(2)


def test_copy_into_keeps_identity_and_takes_the_step():
    live = ({"w": torch.zeros(3, requires_grad=True)},
            OptState({"w": torch.ones(3)}, {"w": torch.ones(3)}, 4))
    w = live[0]["w"]
    out = copy_into(live, ({"w": torch.full((3,), 2.0)},
                           OptState({"w": torch.zeros(3)},
                                    {"w": torch.zeros(3)}, 9)))
    assert out[0]["w"] is w and w.requires_grad
    assert w.tolist() == [2.0] * 3 and out[1].step == 9
    assert out[1].m["w"] is live[1].m["w"]


def test_checkpoint_files_are_zip_archives_of_raw_members(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    with zipfile.ZipFile(path) as z:
        assert z.namelist() == ["raw_0.npy", "__manifest__.npy"]
    assert os.path.basename(path) == "ckpt_00000001.npz"
