"""Tests for the port's lint engine, ``repro_torch.analysis``.

The cases of tests/test_analysis.py on the port's seven rules: each rule
flags its known-bad snippet at exactly the expected lines, stays silent on
its known-good one, and a bad snippet is bad in one way only; then the
engine's plumbing (suppressions in JAX's syntax, the baseline, the CLI) and
the self-check that the port's sources are clean with no baseline file.

The snippets are strings written to ``tmp_path``, never files under
``tests/``: the JAX package's self-check walks ``tests`` with its own rules.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import baseline as bl
from repro_torch.analysis import engine

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")

RULES = ("host-sync-in-capture", "collective-group", "implicit-generator",
         "tensor-branch", "state-after-dispatch", "kernel-contract",
         "no-bare-print")


def src(text):
    return textwrap.dedent(text).lstrip("\n")


# ---------------------------------------------------------------------------
# per-rule snippets: (rule, bad, flagged lines, good, in library code)
# ---------------------------------------------------------------------------

BAD_HOST_SYNC = src('''
    import numpy as np
    import torch
    from repro_torch.core.window import FusedWindow

    def body(params, m, v, batch, step, lr_scale):
        loss = params["w"].sum()
        host = loss.item()
        arr = np.asarray(loss)
        return helper(loss) + float(step) + host + arr

    def helper(x):
        torch.cuda.synchronize()
        return x.cpu()

    def make(part):
        return FusedWindow(body, torch.device("cuda"), part)

    def capture(graph, fn, x):
        graph.capture_begin()
        y = fn(x).tolist()
        graph.capture_end()
        return y

    def in_graph(x):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            z = x.numpy()
        return z

    def graphed(step_fn, x):
        return torch.cuda.make_graphed_callables((step_fn,), (x,))

    def step_fn(x):
        return int(x)
''')
GOOD_HOST_SYNC = src('''
    import numpy as np
    import torch
    from repro_torch.core.window import FusedWindow

    def body(params, m, v, batch, step, lr_scale):
        loss = params["w"].sum()
        return torch.stack([loss, step.float(), lr_scale])

    def make(part):
        return FusedWindow(body, torch.device("cuda"), part)

    def drain(ring):
        torch.cuda.synchronize()
        return np.asarray(ring.cpu().numpy()), float(ring[0]), ring.item()
''')

BAD_COLLECTIVE = src('''
    import torch.distributed as dist
    from torch.distributed import all_gather

    def sync(t, outs):
        dist.all_reduce(t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        all_gather(outs, t)
        dist.broadcast(t, 0)
        dist.barrier()
        return [dist.P2POp(dist.isend, t, 1)]
''')
GOOD_COLLECTIVE = src('''
    import torch.distributed as dist
    from torch.distributed import all_gather

    def sync(t, outs, group):
        dist.all_reduce(t, group=group)
        dist.all_reduce(t, dist.ReduceOp.SUM, group)
        all_gather(outs, t, group=group)
        dist.broadcast(t, 0, group)
        dist.barrier(group=group)
        fn = dist.isend if t.numel() else dist.irecv
        return [dist.P2POp(fn, t, 1, group)], dist.get_rank(group)
''')

BAD_GENERATOR = src('''
    import torch
    from torch.nn import init

    def draw(shape, t):
        a = torch.randn(shape)
        b = torch.rand(shape, device="cpu")
        t.normal_(0, 1)
        init.trunc_normal_(t, std=0.02)
        return a, b, torch.randperm(10)
''')
GOOD_GENERATOR = src('''
    import torch
    from torch.nn import init

    def draw(shape, t, gen):
        a = torch.randn(shape, generator=gen)
        b = torch.rand(shape, device="cpu", generator=gen)
        t.normal_(0, 1, generator=gen)
        init.trunc_normal_(t, std=0.02, generator=gen)
        return a, b, torch.randperm(10, generator=gen), torch.zeros(shape)
''')

BAD_BRANCH = src('''
    import torch
    from repro_torch.core.window import FusedWindow

    def body(params, m, v, batch, step, lr_scale):
        loss = torch.stack([x.sum() for x in m]).sum()
        if loss > 0:
            loss = loss * 2
        while torch.isnan(loss):
            loss = torch.zeros(())
        assert torch.isfinite(loss)
        scale = 1.0 if loss.abs() < 1 else 2.0
        return loss * scale

    def make(part):
        return FusedWindow(body, torch.device("cuda"), part)
''')
GOOD_BRANCH = src('''
    import torch
    from repro_torch.core.window import FusedWindow

    def body(params, m, v, batch, step, lr_scale):
        loss = params["w"].sum()
        if batch is None or len(m) > 2:
            return loss
        if loss.dim() == 0 and torch.is_floating_point(loss):
            loss = torch.where(loss > 0, loss, -loss)
        return loss

    def make(part):
        return FusedWindow(body, torch.device("cuda"), part)

    def host_side(x):
        if torch.isnan(x).any():
            return 0
        return 1
''')

BAD_DISPATCH = src('''
    def loop(window, state, stacked, part):
        pending = window.dispatch(state, stacked, part=part)
        n = state.effective_step + 1
        w = state.params["w"]
        state, ring = window.drain(pending)
        return state, ring, n, w

    def again(window, state, stacked, part):
        window.dispatch(state, stacked, part=part)
        return window.dispatch(state, stacked, part=part)
''')
GOOD_DISPATCH = src('''
    def loop(window, state, batches, part):
        for stacked in batches:
            after = state.effective_step + len(stacked)
            pending = window.dispatch(state, stacked, part=part)
            state, ring = window.drain(pending)
            assert state.effective_step == after
        return state

    def once(window, state, stacked, part):
        return window.drain(window.dispatch(state, stacked, part=part))
''')

BAD_KERNEL = src('''
    import ctypes
    from repro_torch.kernels import build

    _LIB = build.load("stage_merge")

    def launch(x):
        lib = build.load("stage_merge")
        fn = lib.stage_merge
        fn.argtypes = [ctypes.c_void_p]
        return fn(x)

    def launch_direct(x):
        lib = ctypes.CDLL("libentry.so")
        return lib.entry(x)

    import triton
''')
GOOD_KERNEL = src('''
    import ctypes
    from repro_torch.kernels import build

    def _entry():
        lib = build.load("stage_merge")
        fn = getattr(lib, "stage_merge")
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        return lib, fn

    def launch(x):
        import triton
        lib, fn = _entry()
        return fn(x), triton
''')

BAD_PRINT = src('''
    import torch

    def report(x, gen):
        print("loss", x)
        return torch.randn(3, generator=gen)
''')
GOOD_PRINT = src('''
    from repro_torch.telemetry import log

    def report(obj, x):
        obj.print("not the builtin")
        log(f"loss {x}")
        print("deliberate CLI output")  # repro: allow[no-bare-print]
''')

CASES = [
    ("host-sync-in-capture", BAD_HOST_SYNC, [7, 8, 9, 12, 13, 20, 26, 33],
     GOOD_HOST_SYNC, False),
    ("collective-group", BAD_COLLECTIVE, [5, 6, 7, 8, 9, 10],
     GOOD_COLLECTIVE, False),
    ("implicit-generator", BAD_GENERATOR, [5, 6, 7, 8, 9], GOOD_GENERATOR,
     False),
    ("tensor-branch", BAD_BRANCH, [6, 8, 10, 11], GOOD_BRANCH, False),
    ("state-after-dispatch", BAD_DISPATCH, [3, 4, 10], GOOD_DISPATCH, False),
    ("kernel-contract", BAD_KERNEL, [4, 10, 14, 16], GOOD_KERNEL, False),
    ("no-bare-print", BAD_PRINT, [4], GOOD_PRINT, True),
]


def write(tmp_path, body, *, library=False, name="mod.py"):
    """``body`` as a file, under a ``src/repro_torch`` pair for library
    code."""
    d = tmp_path / "src" / "repro_torch" if library else tmp_path
    d.mkdir(parents=True, exist_ok=True)
    p = d / name
    p.write_text(body)
    engine._SOURCE_CACHE.pop(str(p), None)
    return str(p)


def findings_for(path, rule=None):
    reports = engine.run_paths([path])
    out = [f for r in reports for f in r.findings]
    if rule is not None:
        out = [f for f in out if f.rule == rule]
    return out


def lines_of(findings):
    return sorted(f.line for f in findings)


def test_seven_rules_one_for_each_jax_rule():
    assert set(engine.all_rules()) == set(RULES)
    assert [c[0] for c in CASES] == list(RULES)


@pytest.mark.parametrize("rule,bad,lines,good,library", CASES,
                         ids=[c[0] for c in CASES])
def test_rule_flags_bad_snippet(rule, bad, lines, good, library, tmp_path):
    found = findings_for(write(tmp_path, bad, library=library), rule)
    assert lines_of(found) == lines
    # every finding carries a position and a message
    for f in found:
        assert f.col >= 1 and f.message


@pytest.mark.parametrize("rule,bad,lines,good,library", CASES,
                         ids=[c[0] for c in CASES])
def test_rule_silent_on_good_snippet(rule, bad, lines, good, library,
                                     tmp_path):
    assert findings_for(write(tmp_path, good, library=library)) == []


@pytest.mark.parametrize("rule,bad,lines,good,library", CASES,
                         ids=[c[0] for c in CASES])
def test_bad_snippet_triggers_only_its_rule(rule, bad, lines, good, library,
                                            tmp_path):
    """Each known-bad snippet is bad in exactly one way."""
    found = findings_for(write(tmp_path, bad, library=library))
    assert {f.rule for f in found} == {rule}


def test_manual_seed_only_in_library_code(tmp_path):
    body = "import torch\n\ndef seed():\n    torch.manual_seed(0)\n"
    assert lines_of(findings_for(write(tmp_path, body, library=True),
                                 "implicit-generator")) == [4]
    assert findings_for(write(tmp_path, body, name="script.py")) == []


def test_captured_set_of_the_port():
    """The trainer's step body and the window's captured step are what the
    engine holds captured; the loop around them is not."""
    names = {}
    for rel in ("core/trainer.py", "core/window.py"):
        index = engine.index_file(os.path.join(SRC, "repro_torch", rel))
        names[rel] = {getattr(n, "name", None) for n in index.captured}
    assert {"_body", "loss_fn", "twin_cast"} <= names["core/trainer.py"]
    assert "_loop_fused" not in names["core/trainer.py"]
    assert "_run_body" in names["core/window.py"]
    assert "drain" not in names["core/window.py"]


# ---------------------------------------------------------------------------
# suppressions: JAX's syntax, so one comment serves both engines
# ---------------------------------------------------------------------------

BAD_BODY = ("import torch\n"
            "from repro_torch.core.window import FusedWindow\n"
            "def body(params, m, v, batch, step, lr_scale):\n"
            "    {line}\n"
            "    return step\n"
            "def make(part):\n"
            "    return FusedWindow(body, torch.device('cuda'), part)\n")


def test_suppress_same_line(tmp_path):
    path = write(tmp_path, BAD_BODY.format(
        line="y = float(step)  # repro: allow[host-sync-in-capture]"))
    assert findings_for(path) == []


def test_suppress_line_above(tmp_path):
    path = write(tmp_path, BAD_BODY.format(
        line="# repro: allow[host-sync-in-capture]\n    y = float(step)"))
    assert findings_for(path) == []


def test_suppress_star_and_lists(tmp_path):
    path = write(tmp_path, BAD_BODY.format(
        line="y = float(step)  # repro: allow[*]"))
    assert findings_for(path) == []
    path = write(tmp_path, BAD_BODY.format(
        line="y = float(step)  # repro: allow[tensor-branch, "
             "host-sync-in-capture]"))
    assert findings_for(path) == []


def test_suppress_other_rule_does_not_apply(tmp_path):
    path = write(tmp_path, BAD_BODY.format(
        line="y = float(step)  # repro: allow[tensor-branch]"))
    assert lines_of(findings_for(path, "host-sync-in-capture")) == [4]


# ---------------------------------------------------------------------------
# baseline workflow
# ---------------------------------------------------------------------------

def test_baseline_grandfathers_then_shrinks(tmp_path):
    path = write(tmp_path, BAD_BODY.format(line="y = float(step)"))
    found = findings_for(path)
    assert len(found) == 1

    base = tmp_path / "baseline.json"
    bl.write_baseline(str(base), found)
    new, old = bl.split_by_baseline(findings_for(path),
                                    bl.load_baseline(str(base)))
    assert new == [] and len(old) == 1

    # editing the flagged line invalidates the fingerprint: finding is new
    edited = write(tmp_path, BAD_BODY.format(line="y = float(step + 1)"))
    new, old = bl.split_by_baseline(findings_for(edited),
                                    bl.load_baseline(str(base)))
    assert len(new) == 1 and old == []


def test_fingerprint_survives_line_drift(tmp_path):
    path = write(tmp_path, BAD_BODY.format(line="y = float(step)"))
    fp1 = findings_for(path)[0].fingerprint
    # prepend a comment block: same content, different line number
    drifted = write(tmp_path, "# header\n# header\n" +
                    BAD_BODY.format(line="y = float(step)"))
    fp2 = findings_for(drifted)[0].fingerprint
    assert fp1 == fp2


def test_baseline_file_is_the_ports_own():
    from repro.analysis import baseline as jax_bl
    assert bl.DEFAULT_BASELINE == ".repro-torch-analysis-baseline.json"
    assert bl.DEFAULT_BASELINE != jax_bl.DEFAULT_BASELINE


# ---------------------------------------------------------------------------
# CLI contract
# ---------------------------------------------------------------------------

def run_cli(*argv, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=120)


def test_cli_strict_fails_on_bad_snippet(tmp_path):
    bad = write(tmp_path, BAD_COLLECTIVE, name="bad_collective.py")
    proc = run_cli(bad, "--strict", "--no-baseline")
    assert proc.returncode == 1
    # file:line:col findings on stdout
    assert "bad_collective.py:5:" in proc.stdout
    assert "collective-group" in proc.stdout


def test_cli_clean_on_good_snippet(tmp_path):
    good = write(tmp_path, GOOD_HOST_SYNC, name="good_host_sync.py")
    proc = run_cli(good, "--strict", "--no-baseline")
    assert proc.returncode == 0
    assert "clean" in proc.stdout


def test_cli_json_format(tmp_path):
    bad = write(tmp_path, BAD_GENERATOR, name="bad_generator.py")
    proc = run_cli(bad, "--format", "json", "--no-baseline")
    assert proc.returncode == 0           # non-strict: report, don't fail
    data = json.loads(proc.stdout)
    assert {f["rule"] for f in data["findings"]} == {"implicit-generator"}
    for f in data["findings"]:
        assert f["path"].endswith("bad_generator.py")
        assert f["line"] > 0 and f["fingerprint"]


def test_cli_rule_selection_and_listing(tmp_path):
    bad = write(tmp_path, BAD_HOST_SYNC, name="bad_host_sync.py")
    proc = run_cli(bad, "--strict", "--no-baseline",
                   "--rules", "tensor-branch")
    assert proc.returncode == 0           # only the selected rule runs
    proc = run_cli("--list-rules")
    assert proc.returncode == 0
    listed = {line.split()[0] for line in proc.stdout.splitlines()}
    assert listed == set(RULES)
    proc = run_cli(bad, "--rules", "no-such-rule")
    assert proc.returncode == 2


# ---------------------------------------------------------------------------
# self-check: the port's sources are clean, with no baseline file
# ---------------------------------------------------------------------------

def test_port_sources_clean_under_strict_with_no_baseline():
    assert not os.path.exists(os.path.join(REPO, bl.DEFAULT_BASELINE))
    tests = sorted(os.path.join("tests", f) for f in os.listdir(HERE)
                   if f.startswith("test_torch_") and f.endswith(".py"))
    proc = run_cli("src/repro_torch", "examples", "chip_smoke.py", *tests,
                   "--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout or "clean" in proc.stdout


def test_lint_imports_no_torch():
    """The engine, rules and CLI are stdlib only, as JAX's are: they run
    where no accelerator stack is installed."""
    code = ("import sys\n"
            "from repro_torch.analysis import cli\n"
            "assert cli.main(['--list-rules']) == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_fixture_dir_excluded_from_directory_walks():
    files = engine.iter_python_files([HERE])
    assert files and not any("analysis_fixtures" in f for f in files)
    # but explicit file paths bypass the exclusion
    explicit = os.path.join(HERE, "analysis_fixtures", "bad_host_sync.py")
    assert engine.iter_python_files([explicit]) == [explicit]
