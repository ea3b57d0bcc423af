"""The port's telemetry (``repro_torch.telemetry``) and its sites in the
trainer, the recovery strategies, the simulator and the state store.

The unit cases of tests/test_telemetry.py, run against the port: recorder
primitives, the event schema, the payload sanitizer, the disabled helpers,
spans and the Chrome trace, derived metrics, the report CLI, the log sink,
the async snapshot track, and the instrumented trainer and store.  Then the
port's own cases:

* the schema (``EVENT_FIELDS``) and ``active_param_count`` equal JAX's;
* a torch value in a payload raises ``TypeError`` (reading a tensor would
  synchronize the card);
* a run with a recorder installed is bit-identical to one without, with
  equal dispatches and the same host reads of tensors, at windows 1 and 8;
* **parity of event streams**: the JAX ``Trainer`` and the port's run the
  same small configurations and schedules, each under its own recorder.
  Events: the same kinds in the same order with the same fields; integer,
  string, list, bool and None fields equal (and of the same type); ``loss``
  within 1e-4 relative (the trainer parity tolerance of
  tests/test_torch_trainer.py, which states why); every other float field
  (``clock_s``, ``cost_s``, ``read_time_s``, ``overhead_s``, ``stretch``,
  ``nbytes`` of a re-layout, ...) within 1e-9 relative (the wall-clock
  model's arithmetic is the same in both packages); ``t_s`` and
  ``duration_s`` (host time) left out.  Spans: the same names and arguments
  in the same order, durations left out.  Events and spans of the
  snapshotter's thread are compared as multisets (their interleaving with
  the main thread is timing), without the span's ``pending`` (the queue
  depth it saw);
* each package's report reads the other's run directory;
* the launcher with ``--telemetry-dir --trace`` writes ``events.jsonl`` and
  ``trace.json`` and leaves no recorder installed, also when the run raises.
"""
import collections
import contextlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import telemetry as jtel
from repro.config import (OptimizerConfig as JOpt, RecoveryConfig as JRec,
                          TrainConfig as JTrain)
from repro.configs import ARCHS as JARCHS
from repro.configs import PAPER_MODELS as JPAPER
from repro.configs import get_config as jax_get_config
from repro.core.trainer import Trainer as JTrainer
from repro.core.walltime import WallClockModel as JWall
from repro.data.pipeline import make_batches as jax_make_batches
from repro.models.model import build_model as jax_build_model
from repro.sim import get_scenario as jax_get_scenario
from repro.sim import simulate as jax_simulate
from repro.telemetry import events as jax_events
from repro_torch import telemetry
from repro_torch.config import OptimizerConfig, RecoveryConfig, TrainConfig
from repro_torch.configs import ARCHS, PAPER_MODELS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.state import History
from repro_torch.core.trainer import Trainer
from repro_torch.core.walltime import WallClockModel
from repro_torch.data.pipeline import make_batches
from repro_torch.launch import train
from repro_torch.models.model import Model
from repro_torch.sim import get_scenario, simulate
from repro_torch.statestore import DiskTier, MemoryTier, StateStore
from repro_torch.telemetry import (Recorder, chrome_trace, load_chrome_trace,
                                   validate_events, validate_record)
from repro_torch.telemetry import events as port_events
from repro_torch.telemetry.log import log, set_verbosity
from repro_torch.telemetry.metrics import (compute_metrics, render_text,
                                           strict_problems)
from repro_torch.telemetry.report import main as report_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, FLOAT_RTOL = 1e-4, 1e-9
SPECS = WallClockModel().tier_specs()

# the port-only trainer cases: 4 layers, 4 stages, batch 4 x 32
CFG = dict(name="tel-llama", num_layers=4, d_model=32, num_heads=2,
           num_kv_heads=2, d_ff=64, vocab_size=128, max_seq_len=32,
           dtype="float32")
STAGES = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel do not oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def rec():
    """A scoped in-memory recorder installed process-wide."""
    r = Recorder(stream=False)
    prev = telemetry.set_recorder(r)
    try:
        yield r
    finally:
        telemetry.set_recorder(prev)


class ForcedSchedule:
    def __init__(self, events):
        self._events = dict(events)

    def at(self, step):
        return self._events.get(step, [])


def make_trainer(*, strategy="none", window=4, steps=12, events=None,
                 checkpoint_dir=None):
    cfg = get_config("paper-llama-124m").replace(**CFG)
    rcfg = RecoveryConfig(strategy=strategy, num_stages=STAGES,
                          checkpoint_every=1000,
                          checkpoint_dir=checkpoint_dir or "/tmp/tel_ckpt")
    tcfg = TrainConfig(
        global_batch=4, microbatch=4, seq_len=32, steps=steps,
        eval_every=100, fuse_window=window,
        optimizer=OptimizerConfig(lr=1e-3, total_steps=steps,
                                  warmup_steps=2),
        recovery=rcfg)
    return Trainer(Model(cfg, device="cpu", weights=False), tcfg,
                   schedule=ForcedSchedule(events) if events else None)


def _batches(seed=0):
    return make_batches(get_config("paper-llama-124m").replace(**CFG),
                        batch=4, seq=32, seed=seed)


# ---------------------------------------------------------------------------
# recorder primitives
# ---------------------------------------------------------------------------

def test_counters_gauges_histograms(rec):
    telemetry.inc("dispatches")
    telemetry.inc("dispatches", 2)
    telemetry.gauge("window", 8)
    for v in (1.0, 3.0, 2.0):
        telemetry.observe("drain_s", v)
    snap = rec.snapshot()
    assert snap["counters"]["dispatches"] == 3
    assert snap["gauges"]["window"] == 8.0
    h = snap["histograms"]["drain_s"]
    assert h["count"] == 3 and h["min"] == 1.0 and h["max"] == 3.0
    assert h["mean"] == pytest.approx(2.0)


def test_event_stream_writes_jsonl(tmp_path):
    r = Recorder(str(tmp_path))
    prev = telemetry.set_recorder(r)
    try:
        telemetry.emit("log", message="hello", level=1)
        telemetry.emit("sim_node", what="fail", step=3, stage=1, node_id=7)
    finally:
        telemetry.set_recorder(prev)
        r.close()
    lines = (tmp_path / "events.jsonl").read_text().splitlines()
    events = [json.loads(ln) for ln in lines]
    assert [e["kind"] for e in events] == ["log", "sim_node"]
    assert validate_events(events) == []
    assert all(e["v"] == telemetry.SCHEMA_VERSION and e["t_s"] >= 0.0
               for e in events)
    assert r.counters["events.log"] == 1


def test_event_payloads_are_sanitized(rec):
    telemetry.emit("log", message="x", level=np.int64(2),
                   extra=np.float32(1.5), seq=(np.int32(1), 2))
    e = rec.events[0]
    assert e["level"] == 2 and type(e["level"]) is int
    assert e["extra"] == 1.5 and type(e["extra"]) is float
    assert e["seq"] == [1, 2]
    assert validate_record(e) == []


@pytest.mark.parametrize("value", [torch.tensor(1.5), torch.tensor([1, 2]),
                                   torch.float32, torch.device("cpu"),
                                   torch.Size([2])])
def test_torch_values_in_payloads_raise(rec, value):
    """A tensor in an event would synchronize the card when it is written:
    the sanitizer refuses every value whose type comes from torch, in
    events, in span arguments and nested in lists."""
    with pytest.raises(TypeError, match="torch"):
        telemetry.emit("log", message="x", level=1, extra=value)
    with pytest.raises(TypeError, match="torch"):
        telemetry.emit("recovery", wall_step=1, stage=2, strategy="s",
                       duration_s=0.0, stages=[value])
    with pytest.raises(TypeError, match="torch"):
        with telemetry.span("window_drain", k=value):
            pass
    assert rec.events == [] and rec.spans == []


def test_validate_record_rejects_malformed():
    ok = {"v": 1, "kind": "failure", "t_s": 0.1, "wall_step": 3,
          "stage": 1, "cost_s": 2.0, "overhead_s": 0.0}
    assert validate_record(ok) == []
    assert validate_record("nope")
    assert validate_record({"kind": "failure", "t_s": 0.0})
    assert any("newer" in p for p in validate_record(dict(ok, v=99)))
    assert any("unknown" in p
               for p in validate_record(dict(ok, kind="wat")))
    missing = dict(ok)
    del missing["stage"]
    assert any("missing required field 'stage'" in p
               for p in validate_record(missing))
    bad = {"v": 1, "kind": "snapshot_save", "t_s": 0.0, "step": 1,
           "shard_id": "s0", "tier": "mem", "nbytes": True,
           "synchronous": 1}
    probs = validate_record(bad)
    assert any("'nbytes'" in p for p in probs)
    assert any("'synchronous'" in p for p in probs)
    assert validate_record(dict(ok, novel_field=123)) == []


def test_disabled_helpers_are_noops():
    assert telemetry.get_recorder() is None
    assert not telemetry.enabled()
    telemetry.emit("log", message="dropped", level=1)
    telemetry.inc("x")
    telemetry.gauge("x", 1.0)
    telemetry.observe("x", 1.0)
    telemetry.complete("span", 0.0)
    assert telemetry.clock() == 0.0
    # the disabled span is ONE shared null context: no per-call allocation
    assert telemetry.span("a") is telemetry.span("b")
    # and nothing is checked on the disabled path: no sink, no work
    telemetry.emit("log", message="dropped", level=torch.tensor(1))


def test_schema_and_active_params_equal_jax():
    """The port's copy of the schema is JAX's: the same kinds, fields and
    type names; and every config's active parameter count (the FLOPs of
    ``run_start``) equals JAX's, MoE included."""
    def names(fields):
        return {kind: {f: tuple(t.__name__ for t in types)
                       for f, types in spec.items()}
                for kind, spec in fields.items()}
    assert names(port_events.EVENT_FIELDS) == names(jax_events.EVENT_FIELDS)
    assert port_events.EVENT_KINDS == jax_events.EVENT_KINDS
    assert port_events.SCHEMA_VERSION == jax_events.SCHEMA_VERSION
    assert set(ARCHS) | set(PAPER_MODELS) == set(JARCHS) | set(JPAPER)
    moe = 0
    for name in sorted(set(ARCHS) | set(PAPER_MODELS)):
        cfg, jcfg = get_config(name), jax_get_config(name)
        assert cfg.active_param_count() == jcfg.active_param_count(), name
        moe += cfg.arch_type == "moe"
        if cfg.arch_type == "moe":
            assert cfg.active_param_count() < cfg.param_count()
    assert moe >= 2


# ---------------------------------------------------------------------------
# spans and the Chrome trace
# ---------------------------------------------------------------------------

def test_spans_export_as_chrome_trace(tmp_path, rec):
    with telemetry.span("outer", cat="test", k=8):
        telemetry.emit("log", message="mark", level=1)
    t0 = telemetry.clock()
    telemetry.complete("manual", t0, cat="test")
    path = rec.write_chrome_trace(str(tmp_path / "trace.json"))
    trace = load_chrome_trace(path)
    evs = trace["traceEvents"]
    spans = {e["name"] for e in evs if e.get("ph") == "X"}
    assert spans == {"outer", "manual"}
    outer = next(e for e in evs if e.get("ph") == "X"
                 and e["name"] == "outer")
    assert outer["args"]["k"] == 8 and outer["dur"] >= 0
    instants = [e for e in evs if e.get("ph") == "i"]
    assert any(e["name"] == "log" for e in instants)
    meta = [e for e in evs if e.get("ph") == "M"]
    assert {"name": "repro_torch"} in [e["args"] for e in meta]
    assert chrome_trace(rec.spans, rec.events) == rec.chrome_trace()


def test_traced_decorator(rec):
    @telemetry.traced("work", cat="test")
    def work(x):
        return x + 1

    assert work(1) == 2
    assert [s["name"] for s in rec.spans] == ["work"]


def test_traced_is_passthrough_when_disabled():
    @telemetry.traced("work")
    def work(x):
        return x * 2

    assert work(3) == 6


def test_load_chrome_trace_rejects_malformed(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "ts": 0}]}))
    with pytest.raises(ValueError):
        load_chrome_trace(str(bad))
    notdict = tmp_path / "nd.json"
    notdict.write_text("[1, 2]")
    with pytest.raises(ValueError):
        load_chrome_trace(str(notdict))


def test_async_snapshot_spans_get_their_own_track(tmp_path, rec):
    """The AsyncSnapshotter worker emits from its own thread: its spans
    carry another thread id, so the Chrome trace gives them their own row."""
    store = StateStore([MemoryTier(SPECS["mem"]),
                        DiskTier(SPECS["disk"], str(tmp_path))])
    tree = {"w": torch.ones(4, 4)}
    with telemetry.span("main"):
        store.put(tree, step=1, shard_id="s0", tier="disk")   # async write
        store.flush()
    store.close()
    main = {s["tid"] for s in rec.spans if s["name"] == "main"}
    worker = {s["tid"] for s in rec.spans
              if s["name"] in ("tier_write", "snapshot_write")}
    assert len(main) == 1 and len(worker) == 1 and main != worker
    rows = {e["name"]: e["tid"] for e in rec.chrome_trace()["traceEvents"]
            if e.get("ph") == "X"}
    assert rows["main"] != rows["tier_write"] == rows["snapshot_write"]


# ---------------------------------------------------------------------------
# derived metrics + strict contract
# ---------------------------------------------------------------------------

def _synthetic_events():
    mk = lambda kind, t, **kw: dict({"v": 1, "kind": kind, "t_s": t}, **kw)  # noqa: E731
    return [
        mk("run_start", 0.0, arch="tel-llama", strategy="checkfree",
           backend="host", steps=8, num_stages=4,
           flops_per_step=1e9, tokens_per_step=128),
        mk("step_window", 1.0, wall_step=0, k=4, effective_step=4,
           loss=3.0, clock_s=100.0, stretch=1.0),
        mk("failure", 1.5, wall_step=4, stage=2, cost_s=90.0,
           overhead_s=10.0),
        mk("recovery", 1.6, wall_step=4, stage=2, strategy="checkfree",
           duration_s=0.25, stages=[2]),
        mk("step_window", 2.0, wall_step=5, k=4, effective_step=8,
           loss=2.5, clock_s=200.0, stretch=1.5),
        mk("snapshot_save", 2.1, step=8, shard_id="s0", tier="mem",
           nbytes=1000, synchronous=True),
        mk("snapshot_save", 2.2, step=8, shard_id="s0", tier="disk",
           nbytes=1000, synchronous=False),
        mk("snapshot_restore", 2.3, step=8, shard_id="s0", tier="mem",
           nbytes=1000, read_time_s=0.5),
        mk("run_end", 4.0, effective_steps=8, wall_iters=9, dispatches=3,
           failures=1, truncated=False, clock_s=300.0),
    ]


def test_metrics_from_synthetic_stream():
    events = _synthetic_events()
    assert validate_events(events) == []
    m = compute_metrics(events, peak_flops=1e10)
    assert m["goodput"] == pytest.approx(8 / 9)
    assert m["wall_iters"] == 9 and m["dispatches"] == 3
    r = m["recovery"]
    assert r["events"] == 1 and r["failures"] == 1
    assert r["by_strategy"]["checkfree"]["count"] == 1
    assert r["by_strategy"]["checkfree"]["measured_s"] == pytest.approx(.25)
    assert r["modelled_cost_s"] == pytest.approx(100.0)
    tiers = m["snapshots"]["by_tier"]
    assert tiers["mem"]["saves"] == 1 and tiers["mem"]["restores"] == 1
    assert tiers["disk"]["saved_bytes"] == 1000
    assert tiers["mem"]["read_time_s"] == pytest.approx(0.5)
    assert m["straggler"]["mean_stretch"] == pytest.approx(1.25)
    assert m["straggler"]["max_stretch"] == pytest.approx(1.5)
    assert m["mfu"]["achieved_flops_per_s"] == pytest.approx(2e9)
    assert m["mfu"]["mfu"] == pytest.approx(0.2)
    assert strict_problems(m) == []
    text = render_text(m)
    assert "goodput" in text and "recovery[checkfree]" in text
    assert "tier[mem]" in text
    # the same metrics as the JAX package computes from the same stream
    assert m == jtel.compute_metrics(events, peak_flops=1e10)


def test_strict_contract_names_missing_metrics():
    events = [e for e in _synthetic_events() if e["kind"] != "recovery"]
    probs = strict_problems(compute_metrics(events))
    assert any("recovery" in p for p in probs)
    assert strict_problems({}) != []


def test_goodput_falls_back_to_step_windows():
    events = [e for e in _synthetic_events() if e["kind"] != "run_end"]
    assert compute_metrics(events)["goodput"] == pytest.approx(8 / 9)


# ---------------------------------------------------------------------------
# report CLI
# ---------------------------------------------------------------------------

def _write_stream(tmp_path, events):
    p = tmp_path / "events.jsonl"
    p.write_text("".join(json.dumps(e) + "\n" for e in events))
    return str(tmp_path)


def test_report_cli_ok(tmp_path, capsys):
    run = _write_stream(tmp_path, _synthetic_events())
    assert report_main([run, "--strict"]) == 0
    out = capsys.readouterr().out
    assert "recovery[checkfree]" in out and "MFU" not in out


def test_report_cli_json(tmp_path, capsys):
    run = _write_stream(tmp_path, _synthetic_events())
    assert report_main([run, "--json", "--peak-flops", "1e10"]) == 0
    m = json.loads(capsys.readouterr().out)
    assert m["mfu"]["mfu"] == pytest.approx(0.2)


def test_report_cli_strict_fails_without_recovery(tmp_path):
    events = [e for e in _synthetic_events() if e["kind"] != "recovery"]
    run = _write_stream(tmp_path, events)
    assert report_main([run]) == 0
    assert report_main([run, "--strict"]) == 1


def test_report_cli_rejects_schema_violations(tmp_path):
    events = _synthetic_events()
    events[0] = {"v": 1, "kind": "wat", "t_s": 0.0}
    run = _write_stream(tmp_path, events)
    assert report_main([run, "--strict"]) == 2


def test_report_cli_rejects_missing_or_corrupt_stream(tmp_path):
    assert report_main([str(tmp_path / "nope")]) == 2
    (tmp_path / "events.jsonl").write_text("{not json\n")
    assert report_main([str(tmp_path)]) == 2


def test_report_peak_flops_names_no_tpu_figure(capsys):
    """``--peak-flops`` has no default; its example is the H100's."""
    with pytest.raises(SystemExit):
        report_main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "989e12" in out and "H100" in out and "197e12" not in out


# ---------------------------------------------------------------------------
# the logging sink + verbosity knob
# ---------------------------------------------------------------------------

def test_log_respects_verbosity_and_mirrors_events(rec, capsys):
    prev = set_verbosity(1)
    try:
        log("progress line", level=1)
        log("detail line", level=2)
        log("result line", level=0)
    finally:
        set_verbosity(prev)
    out = capsys.readouterr().out
    assert "progress line" in out and "result line" in out
    assert "detail line" not in out
    msgs = [e["message"] for e in rec.events if e["kind"] == "log"]
    assert msgs == ["progress line", "detail line", "result line"]
    assert validate_events(rec.events) == []


def test_history_json_roundtrip():
    hist = History(steps=[1, 2], wall_time=[10.0, 20.0], loss=[3.0, 2.5],
                   eval_loss=[(2, 20.0, 2.4)], failures=[(1, 2)],
                   recovery_errors=[(1, 0.5)], wall_iters=3, dispatches=2,
                   truncated=True)
    assert History.from_json(hist.to_json()) == hist
    assert History.from_json(History().to_json()) == History()


# ---------------------------------------------------------------------------
# instrumented trainer: overhead contract + event stream
# ---------------------------------------------------------------------------

READS = ("item", "tolist", "cpu", "numpy", "__float__", "__int__",
         "__bool__", "__index__")


@contextlib.contextmanager
def counted_reads():
    """Counts the calls of every method that reads a tensor back to the
    host (on the card each would synchronize)."""
    counts = collections.Counter()
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def counting(name, fn):
        def read(self, *args, **kw):
            counts[name] += 1
            return fn(self, *args, **kw)
        return read

    for name, fn in saved.items():
        setattr(torch.Tensor, name, counting(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


@pytest.mark.parametrize("window", [1, 8])
def test_disabled_telemetry_is_bit_identical_to_enabled(window):
    """Instrumentation must not perturb the run: loss traces bit-identical,
    dispatches equal, and the same reads of tensors to the host."""
    with counted_reads() as dark_reads:
        _, off = make_trainer(strategy="checkfree", window=window,
                              events={5: [1]}).run(_batches())
    assert telemetry.get_recorder() is None
    r = Recorder(stream=False)
    prev = telemetry.set_recorder(r)
    try:
        with counted_reads() as lit_reads:
            _, on = make_trainer(strategy="checkfree", window=window,
                                 events={5: [1]}).run(_batches())
    finally:
        telemetry.set_recorder(prev)
    assert on.loss == off.loss and on.steps == off.steps
    assert on.dispatches == off.dispatches and on.wall_iters == off.wall_iters
    assert lit_reads == dark_reads and sum(dark_reads.values()) > 0
    assert off.dispatches == (12 if window == 1 else 5)  # 4, 1, 4, 2, 1
    assert sum(e["kind"] == "step_window" for e in r.events) == on.dispatches
    assert validate_events(r.events) == []


def test_trainer_emits_schema_valid_stream(rec):
    trainer = make_trainer(strategy="checkfree", events={5: [1]})
    trainer.run(_batches())
    assert validate_events(rec.events) == []
    kinds = {e["kind"] for e in rec.events}
    assert {"run_start", "run_end", "step_window",
            "failure", "recovery"} <= kinds
    start = next(e for e in rec.events if e["kind"] == "run_start")
    assert start["strategy"] == "checkfree" and start["backend"] == "host"
    cfg = get_config("paper-llama-124m").replace(**CFG)
    assert start["flops_per_step"] == 6 * cfg.active_param_count() * 4 * 32
    end = next(e for e in rec.events if e["kind"] == "run_end")
    assert end["effective_steps"] == 12 and not end["truncated"]
    recov = next(e for e in rec.events if e["kind"] == "recovery")
    assert recov["strategy"] == "checkfree" and recov["stages"] == [1]
    ks = [e["k"] for e in rec.events if e["kind"] == "step_window"]
    assert sum(ks) == end["wall_iters"]
    names = [s["name"] for s in rec.spans]
    assert names.count("window_dispatch") == end["dispatches"]
    assert names.count("window_drain") == end["dispatches"]
    assert names.count("recovery") == 1
    trace = rec.chrome_trace()
    assert any(e["name"] == "window_dispatch"
               for e in trace["traceEvents"] if e.get("ph") == "X")


def test_truncation_emits_structured_event(rec, tmp_path):
    sched = {s: [2] for s in range(200)}     # fail every step, never save
    trainer = make_trainer(strategy="checkpoint", steps=3, window=1,
                           events=sched,
                           checkpoint_dir=str(tmp_path / "ckpt"))
    with pytest.warns(RuntimeWarning, match="truncated at max_wall"):
        _, hist = trainer.run(_batches())
    assert hist.truncated
    trunc = [e for e in rec.events if e["kind"] == "truncation"]
    assert len(trunc) == 1
    assert trunc[0]["target_steps"] == 3
    assert trunc[0]["wall_iters"] == hist.wall_iters
    end = next(e for e in rec.events if e["kind"] == "run_end")
    assert end["truncated"] is True
    assert validate_events(rec.events) == []


def test_statestore_emits_save_and_restore_events(rec, tmp_path):
    store = StateStore([MemoryTier(SPECS["mem"]),
                        DiskTier(SPECS["disk"], str(tmp_path))])
    tree = {"w": torch.ones(8, 8)}
    store.put(tree, step=1, shard_id="s0", tier="mem")    # sync (memory)
    store.put(tree, step=2, shard_id="s0", tier="disk")   # async
    store.flush()
    res = store.restore("s0", template=tree)
    store.close()
    assert res.step == 2
    assert validate_events(rec.events) == []
    saves = [e for e in rec.events if e["kind"] == "snapshot_save"]
    assert {(e["tier"], e["synchronous"]) for e in saves} == {
        ("mem", True), ("disk", False)}
    assert all(e["nbytes"] == 8 * 8 * 4 for e in saves)
    restores = [e for e in rec.events if e["kind"] == "snapshot_restore"]
    assert len(restores) == 1 and restores[0]["tier"] == "disk"
    assert restores[0]["nbytes"] == res.nbytes
    assert [s["name"] for s in rec.spans].count("restore") == 1
    tiers = compute_metrics(rec.events)["snapshots"]["by_tier"]
    assert tiers["mem"]["saves"] == 1
    assert tiers["disk"]["saves"] == 1 and tiers["disk"]["restores"] == 1


def test_tier_retry_emits_events(rec, tmp_path):
    """A transient write error is retried, each retry a ``tier_retry``."""
    class Flaky(DiskTier):
        fails = 2

        def _write(self, path, snap):
            if Flaky.fails:
                Flaky.fails -= 1
                raise OSError("transient")
            super()._write(path, snap)

    tier = Flaky(SPECS["disk"], str(tmp_path))
    tier._sleep = lambda s: None
    store = StateStore([tier])
    store.put({"w": torch.ones(2)}, step=3, shard_id="s1", tier="disk",
              sync=True)
    retries = [e for e in rec.events if e["kind"] == "tier_retry"]
    assert [(e["attempt"], e["op"], e["shard_id"]) for e in retries] == [
        (1, "put", "s1"), (2, "put", "s1")]
    assert validate_events(rec.events) == []
    assert compute_metrics(rec.events)["tier_retries"] == {"disk/put": 2}


# ---------------------------------------------------------------------------
# parity of event streams with the JAX trainer
# ---------------------------------------------------------------------------

MINI = dict(name="tel-mini", num_layers=6, d_model=32, num_heads=2,
            num_kv_heads=2, d_ff=64, vocab_size=128, max_seq_len=16,
            dtype="float32")
STEPS, BATCH, SEQ = 12, 4, 16
# test_torch_elastic.py's spot_shrink story: slot 2 fails at wall 2, slot 1
# departs at 5 (4 -> 3 stages) and regrows at 10
SHRINK = dict(rate_per_hour=2.0, regrow_h=0.5, rejoin="respawn",
              depart_prob=0.5, iteration_time_s=300.0)


class Forced:
    """Fixed events with the pricing hooks of a simulated cluster."""

    def __init__(self, events):
        self.events = events

    def at(self, step):
        return list(self.events.get(step, []))

    def iteration_factor(self, step):
        return 1.0 + 0.25 * (step % 3)

    def failure_overhead(self, step, stage, nbytes=None):
        return 7.0 + stage + (0.0 if nbytes is None else nbytes * 1e-9)

    def observed_rate(self, step):
        return 0.0


# case -> (strategy, window, schedule, steps, eval, more RecoveryConfig)
CASES = {
    "checkfree-w1": ("checkfree", 1, {3: [2], 7: [1, 2]}, STEPS, True, {}),
    "checkfree-w8": ("checkfree", 8, {3: [2], 7: [1, 2]}, STEPS, True, {}),
    "checkfree_plus-w1": ("checkfree_plus", 1, {3: [3], 7: [1, 2]}, STEPS,
                          True, {}),
    "checkfree_plus-w8": ("checkfree_plus", 8, {3: [3], 7: [1, 2]}, STEPS,
                          True, {}),
    "elastic-w8": ("elastic", 8, "spot_shrink", STEPS, False, {}),
    "neighbor": ("neighbor", 1, {0: [3], 5: [1, 2]}, STEPS, False,
                 dict(checkpoint_every=2)),
    "tiered_ckpt": ("tiered_ckpt", 1, {0: [1], 5: [2], 9: [1, 2]}, STEPS,
                    False, dict(checkpoint_every=4)),
    "checkpoint-truncated": ("checkpoint", 1,
                             {s: [2] for s in range(40)}, 3, False,
                             dict(checkpoint_every=1000)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """case -> its runs (:func:`run_case`), each run once for the tests
    that read it."""
    done = {}

    def get(case):
        if case not in done:
            done[case] = run_case(case, tmp_path_factory)
        return done[case]
    return get


def run_case(case, tmp_factory):
    """{"jax": (events, spans, hist), "torch": ...} of one case, each
    package under its own recorder, streaming into a run directory of its
    own (``dirs``)."""
    strategy, window, events, steps, evals, more = CASES[case]
    base = tmp_factory.mktemp(case)
    jcfg = jax_get_config("paper-llama-124m").replace(**MINI)
    cfg = get_config("paper-llama-124m").replace(**MINI)
    jmodel = jax_build_model(jcfg)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        device="cpu")
    out = {"dirs": {}}
    for pkg in ("jax", "torch"):
        J = pkg == "jax"
        tel = jtel if J else telemetry
        O, R, T = (JOpt, JRec, JTrain) if J else (OptimizerConfig,
                                                  RecoveryConfig, TrainConfig)
        run_dir = str(base / f"{pkg}_run")
        tcfg = T(global_batch=BATCH, microbatch=BATCH, seq_len=SEQ,
                 steps=steps, eval_every=4 if evals else 100,
                 fuse_window=window,
                 optimizer=O(lr=1e-3, total_steps=steps, warmup_steps=2),
                 recovery=R(strategy=strategy, num_stages=4,
                            protect_edge_stages=strategy in (
                                "checkfree", "elastic"),
                            checkpoint_dir=str(base / f"{pkg}_ckpt"),
                            store_dir=str(base / f"{pkg}_store"), **more))
        recorder = tel.Recorder(run_dir)
        prev = tel.set_recorder(recorder)
        try:
            if events == "spot_shrink":
                # the simulator's events are part of the stream
                schedule = (jax_simulate if J else simulate)(
                    (jax_get_scenario if J else get_scenario)(
                        "spot_shrink", **SHRINK),
                    steps=STEPS * 10, seed=38, num_stages=4,
                    protect_edges=True)
            else:
                schedule = Forced(events)
            data = (jax_make_batches if J else make_batches)(
                jcfg if J else cfg, batch=BATCH, seq=SEQ, seed=0)
            eval_batches = ([next((jax_make_batches if J else make_batches)(
                jcfg if J else cfg, batch=BATCH, seq=SEQ, seed=7))]
                if evals else None)
            wall = (JWall if J else WallClockModel)(
                model_bytes=8 * cfg.param_count())
            with (pytest.warns(RuntimeWarning, match="truncated")
                  if case == "checkpoint-truncated"
                  else contextlib.nullcontext()):
                if J:
                    trainer = JTrainer(jmodel, tcfg, wall=wall,
                                       schedule=schedule)
                    _, hist = trainer.run(data, eval_batches)
                else:
                    trainer = Trainer(Model(cfg, device="cpu",
                                            weights=False),
                                      tcfg, wall=wall, schedule=schedule)
                    _, hist = trainer.run(data, eval_batches, params=params)
        finally:
            tel.set_recorder(prev)
            recorder.close()
        out[pkg] = (list(recorder.events), list(recorder.spans), hist)
        out["dirs"][pkg] = run_dir
    return out


def split_thread(records, is_worker):
    main = [r for r in records if not is_worker(r)]
    worker = [r for r in records if is_worker(r)]
    return main, worker


def same_value(key, a, b, where):
    if key == "loss":
        assert b == pytest.approx(a, rel=LOSS_RTOL), where
    elif isinstance(a, float) and isinstance(b, float):
        assert b == pytest.approx(a, rel=FLOAT_RTOL, abs=0.0), where
    else:
        assert type(a) is type(b) and a == b, where


def same_records(jax_recs, port_recs, skip):
    assert len(port_recs) == len(jax_recs)
    for i, (a, b) in enumerate(zip(jax_recs, port_recs)):
        where = f"record {i}: JAX {a} port {b}"
        assert set(a) == set(b), where
        for key in a:
            if key not in skip:
                same_value(key, a[key], b[key], where)


def multiset(records, skip):
    return sorted(json.dumps({k: v for k, v in r.items() if k not in skip},
                             sort_keys=True) for r in records)


@pytest.mark.parametrize("case", sorted(CASES))
def test_event_streams_match_jax(case, runs):
    (jev, jsp, jhist), (ev, sp, hist) = runs(case)["jax"], runs(case)["torch"]
    assert hist.steps == jhist.steps and hist.failures == jhist.failures
    assert validate_events(ev) == [] and validate_events(jev) == []
    worker = lambda e: e["kind"] == "snapshot_save" and \
        e["synchronous"] is False  # noqa: E731
    jmain, jthread = split_thread(jev, worker)
    main, thread = split_thread(ev, worker)
    assert [e["kind"] for e in main] == [e["kind"] for e in jmain]
    same_records(jmain, main, skip={"t_s", "duration_s"})
    assert multiset(thread, {"t_s"}) == multiset(jthread, {"t_s"})
    # spans: names and arguments; the snapshotter's by thread id
    main_tid = {s["tid"] for s in sp if s["name"] == "window_dispatch"}
    jmain_tid = {s["tid"] for s in jsp if s["name"] == "window_dispatch"}
    assert len(main_tid) == len(jmain_tid) == 1
    spans = [dict(name=s["name"], cat=s["cat"], **s["args"]) for s in sp]
    jspans = [dict(name=s["name"], cat=s["cat"], **s["args"]) for s in jsp]
    sthread = [s["tid"] not in main_tid for s in sp]
    jthread_s = [s["tid"] not in jmain_tid for s in jsp]
    same_records([s for s, t in zip(jspans, jthread_s) if not t],
                 [s for s, t in zip(spans, sthread) if not t], skip=set())
    assert multiset([s for s, t in zip(spans, sthread) if t], {"pending"}) \
        == multiset([s for s, t in zip(jspans, jthread_s) if t],
                    {"pending"})
    kinds = collections.Counter(e["kind"] for e in ev)
    strategy = CASES[case][0]
    if strategy in ("checkfree", "checkfree_plus"):
        assert kinds["failure"] == 3 and kinds["eval"] == 3
        assert kinds["recovery"] == 2         # [1, 2] recovered together
    elif strategy == "elastic":
        assert kinds["sim_run"] == 1 and kinds["sim_node"] > 0
        assert kinds["repartition"] == 2
    elif strategy in ("neighbor", "tiered_ckpt"):
        assert kinds["snapshot_save"] > 0 and kinds["snapshot_restore"] > 0
        assert any(e["kind"] == "failure" and e["nbytes"] is not None
                   for e in ev)
        assert thread                    # the disk tier's async writes
    else:
        assert kinds["truncation"] == 1


def test_reports_read_each_others_run_directory(runs):
    """JAX's report CLI reads the port's run directory (``--strict``: exit
    0), the port's reads JAX's, and both derive the same metrics from the
    two streams but for host time."""
    runs = runs("checkfree-w8")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "repro.telemetry.report", "--strict",
         "--json", runs["dirs"]["torch"]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    from_jax_cli = json.loads(res.stdout)
    assert report_main([runs["dirs"]["jax"], "--strict"]) == 0
    port_m = compute_metrics(runs["torch"][0])
    jax_m = compute_metrics(runs["jax"][0])
    for m in (port_m, jax_m, from_jax_cli):
        m.pop("mfu")
        for b in m["recovery"]["by_strategy"].values():
            b.pop("measured_s")
    port_m.pop("counts")
    jax_m.pop("counts")
    from_jax_cli.pop("counts")
    assert port_m == from_jax_cli
    assert port_m.pop("modelled_wall_s") == pytest.approx(
        jax_m.pop("modelled_wall_s"), rel=FLOAT_RTOL)
    assert port_m["recovery"].pop("modelled_cost_s") == pytest.approx(
        jax_m["recovery"].pop("modelled_cost_s"), rel=FLOAT_RTOL)
    assert port_m == jax_m


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_cli_records_events_and_trace(tmp_path, capsys):
    run = tmp_path / "run"
    hist = train.main(["--reduced", "--device", "cpu", "--strategy",
                       "checkfree", "--steps", "6", "--seq", "16",
                       "--batch", "2", "--quiet", "--telemetry-dir",
                       str(run), "--trace"])
    assert telemetry.get_recorder() is None
    events = [json.loads(ln) for ln in
              (run / "events.jsonl").read_text().splitlines()]
    assert validate_events(events) == []
    end = [e for e in events if e["kind"] == "run_end"]
    assert len(end) == 1 and end[0]["effective_steps"] == 6
    assert end[0]["dispatches"] == hist.dispatches
    assert any(e["kind"] == "log" for e in events)
    trace = load_chrome_trace(str(run / "trace.json"))
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert names.count("window_drain") == hist.dispatches
    assert "python -m repro_torch.telemetry.report" in capsys.readouterr().out
    assert report_main([str(run)]) == 0


def test_train_cli_uninstalls_the_recorder_when_the_run_raises(
        tmp_path, monkeypatch):
    def broken(self, *args, **kw):
        raise RuntimeError("broken run")

    monkeypatch.setattr(Trainer, "run", broken)
    with pytest.raises(RuntimeError, match="broken run"):
        train.main(["--reduced", "--device", "cpu", "--steps", "2",
                    "--telemetry-dir", str(tmp_path / "run")])
    assert telemetry.get_recorder() is None
    events = [json.loads(ln) for ln in
              (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events][0] == "log"


def test_train_cli_records_the_simulators_events(tmp_path):
    """The recorder is installed before the schedule is simulated."""
    run = tmp_path / "run"
    train.main(["--reduced", "--layers", "6", "--stages", "4", "--device",
                "cpu", "--strategy", "elastic", "--scenario", "spot_shrink",
                "--steps", "8", "--seq", "16", "--batch", "2", "--quiet",
                "--regrow-h", "0.5", "--telemetry-dir", str(run)])
    kinds = [json.loads(ln)["kind"] for ln in
             (run / "events.jsonl").read_text().splitlines()]
    assert "sim_run" in kinds and kinds.index("sim_run") < kinds.index(
        "run_start")
