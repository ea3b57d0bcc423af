"""Core of the ``repro_torch.analysis`` lint engine.

The port's own copy of ``repro.analysis.engine``, pure stdlib (no torch
import): the analyzer must run anywhere, in lint jobs and containers without
an accelerator stack.  The engine parses each file once, builds a
:class:`ModuleIndex` (import aliases, function table, the *captured set*),
collects a project-wide :class:`ProjectContext`, and hands both to every
registered :class:`Rule`.

The captured set replaces JAX's traced set.  It holds the code that runs
inside a CUDA graph capture, where a host read or a Python branch on a
tensor is a sync or a branch baked into the graph:

* functions passed as the body to ``FusedWindow(...)`` (``core/window.py``;
  the trainer passes ``Trainer._body``);
* the bodies of ``with torch.cuda.graph(...)`` blocks, and the statements
  between ``<graph>.capture_begin()`` and ``<graph>.capture_end()``, with
  the functions they call;
* functions passed to ``torch.cuda.make_graphed_callables``;
* every module-local function these call (``self.<name>`` resolves to the
  module's function of that name), as JAX computes reachability.

Findings carry a *fingerprint*, a content hash of (rule, relative path,
normalized source line), so the baseline survives unrelated line drift.

Suppressions keep JAX's syntax, so that one comment serves both engines:
``# repro: allow[rule-id]`` (comma-separated ids, or ``*``) on the finding's
line or the line directly above it.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------

SUPPRESS_RE = re.compile(r"#\s*repro:\s*allow\[([\w\-*, ]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str           # as given on the command line (relative preferred)
    line: int
    col: int
    message: str

    @property
    def fingerprint(self) -> str:
        return finding_fingerprint(self.rule, self.path, self.line)

    def to_json(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "fingerprint": self.fingerprint}

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.message}")


_SOURCE_CACHE: Dict[str, List[str]] = {}


def _source_lines(path: str) -> List[str]:
    if path not in _SOURCE_CACHE:
        try:
            with open(path, encoding="utf-8") as f:
                _SOURCE_CACHE[path] = f.read().splitlines()
        except OSError:
            _SOURCE_CACHE[path] = []
    return _SOURCE_CACHE[path]


def finding_fingerprint(rule: str, path: str, line: int) -> str:
    """Content-addressed id: stable under line renumbering, invalidated when
    the flagged line itself changes."""
    lines = _source_lines(path)
    text = lines[line - 1].strip() if 0 < line <= len(lines) else ""
    rel = os.path.basename(path) if os.path.isabs(path) else path
    blob = f"{rule}:{rel}:{text}".encode()
    return hashlib.sha1(blob).hexdigest()[:16]


# ---------------------------------------------------------------------------
# import-alias resolution
# ---------------------------------------------------------------------------

class NameResolver:
    """Resolve an AST expression to its canonical dotted path.

    ``import torch.distributed as dist`` + ``dist.all_reduce`` ->
    ``torch.distributed.all_reduce``; ``from torch import randn as R`` +
    ``R`` -> ``torch.randn``.
    Unresolvable names resolve to themselves (first segment unaliased).
    """

    def __init__(self, tree: ast.Module):
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")

    def dotted(self, node: ast.AST) -> Optional[str]:
        """The raw dotted text of a Name/Attribute chain, else None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return None

    def canonical(self, node: ast.AST) -> Optional[str]:
        raw = self.dotted(node)
        if raw is None:
            return None
        head, _, rest = raw.partition(".")
        head = self.aliases.get(head, head)
        return f"{head}.{rest}" if rest else head


# canonical callees whose first argument (or ``body=``) runs in a capture
CAPTURING_CONSTRUCTORS = ("FusedWindow",)
GRAPH_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
GRAPHED_CALLABLES = {"torch.cuda.make_graphed_callables",
                     "torch.cuda.graphs.make_graphed_callables"}


def _is_capturing_ctor(canon: Optional[str]) -> bool:
    return canon is not None and canon.split(".")[-1] in CAPTURING_CONSTRUCTORS


class ModuleIndex:
    """Per-file facts shared by every rule: the AST, resolver, function
    table, and the set of functions and statements that run in a capture."""

    def __init__(self, path: str, tree: ast.Module, source: str):
        self.path = path
        self.tree = tree
        self.source = source
        self.resolver = NameResolver(tree)
        # function name -> def node (module-level, nested and methods;
        # nested names shadow outer ones only within this simple map — fine
        # for linting)
        self.functions: Dict[str, ast.AST] = {}
        self.parent: Dict[ast.AST, ast.AST] = {}
        # name -> Call it was last assigned from (partial-bound bodies) and
        # name -> Name/Attribute alias (`_mk = make_thing`)
        self.assigned_calls: Dict[str, ast.Call] = {}
        self.name_aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tname = node.targets[0].id
                if isinstance(node.value, ast.Call):
                    self.assigned_calls[tname] = node.value
                elif isinstance(node.value, (ast.Name, ast.Attribute)):
                    alias = self.resolver.canonical(node.value)
                    if alias is not None:
                        self.name_aliases[tname] = alias
        self.captured: Set[ast.AST] = self._compute_captured()

    def canonical_callee(self, node: ast.AST) -> Optional[str]:
        """Canonical name of a callee, following one hop of module-level
        `alias = real_name` assignments."""
        canon = self.resolver.canonical(node)
        if canon is not None and "." not in canon:
            return self.name_aliases.get(canon, canon)
        return canon

    # -- captured-code reachability -------------------------------------
    def _capture_regions(self) -> List[ast.AST]:
        """Statements that run inside a capture: ``with torch.cuda.graph``
        bodies and the statements from ``capture_begin()`` through the one
        holding ``capture_end()``."""
        regions: List[ast.AST] = []
        res = self.resolver
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call) and \
                            res.canonical(expr.func) in GRAPH_CONTEXTS:
                        regions.extend(node.body)
            for field in ("body", "orelse", "finalbody"):
                body = getattr(node, field, None)
                if not isinstance(body, list):
                    continue
                open_at = None
                for i, stmt in enumerate(body):
                    if not isinstance(stmt, ast.stmt):
                        break
                    # the call as a statement of this body, not nested
                    # in a compound statement of it
                    if open_at is None and not hasattr(stmt, "body") and \
                            _calls_method(stmt, "capture_begin"):
                        open_at = i
                        continue
                    if open_at is not None:
                        regions.append(stmt)
                        if _calls_method(stmt, "capture_end"):
                            open_at = None
        return regions

    def _entry_functions(self) -> Set[ast.AST]:
        entries: Set[ast.AST] = set()
        res = self.resolver
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = res.canonical(node.func)
            if _is_capturing_ctor(fn):
                cands = node.args[:1] + [kw.value for kw in node.keywords
                                         if kw.arg == "body"]
            elif fn in GRAPHED_CALLABLES:
                cands = node.args[:1] + [kw.value for kw in node.keywords
                                         if kw.arg == "callables"]
                cands = [el for c in cands for el in
                         (c.elts if isinstance(c, (ast.Tuple, ast.List))
                          else [c])]
            else:
                continue
            for arg in cands:
                target = self._resolve_local_callable(arg)
                if target is not None:
                    entries.add(target)
        return entries

    def _resolve_local_callable(self, node: ast.AST) -> Optional[ast.AST]:
        if isinstance(node, ast.Lambda):
            return node
        if isinstance(node, ast.Name):
            if node.id in self.functions:
                return self.functions[node.id]
            # body = functools.partial(_body, ...) then FusedWindow(body)
            bound = self.assigned_calls.get(node.id)
            if bound is not None:
                return self._resolve_local_callable(bound)
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in ("self", "cls"):
            # self._body -> the module's function of that name
            return self.functions.get(node.attr)
        if isinstance(node, ast.Call):
            # partial(body, ...) — take the first arg
            inner = self.resolver.canonical(node.func)
            if inner == "functools.partial" and node.args:
                return self._resolve_local_callable(node.args[0])
        return None

    def _compute_captured(self) -> Set[ast.AST]:
        captured: Set[ast.AST] = set()
        regions = self._capture_regions()
        captured.update(regions)
        work = list(self._entry_functions())
        for stmt in regions:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    tgt = self._resolve_local_callable(node.func)
                    if tgt is not None:
                        work.append(tgt)
        while work:
            fn = work.pop()
            if fn in captured:
                continue
            captured.add(fn)
            # every call to a locally-defined function from captured code
            # runs in the capture too (conservative, module-local call graph)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    tgt = self._resolve_local_callable(node.func)
                    if tgt is not None and tgt not in captured:
                        work.append(tgt)
        return captured

    def in_captured(self, node: ast.AST) -> bool:
        """Is ``node`` lexically inside captured code?"""
        cur = node
        while cur is not None:
            if cur in self.captured:
                return True
            cur = self.parent.get(cur)
        return False

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parent.get(cur)
        return None


def _calls_method(stmt: ast.AST, name: str) -> bool:
    """Does ``stmt`` contain a call ``<x>.name()``?"""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == name for n in ast.walk(stmt))


# ---------------------------------------------------------------------------
# project-wide context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProjectContext:
    """Facts that cross file boundaries, collected in a pre-pass over every
    analyzed file: the names of the port's process groups
    (``StageGroup``'s ``group`` and the names bound from
    ``dist.new_group``), for the messages of ``collective-group``."""
    group_names: Set[str] = dataclasses.field(default_factory=set)

    def collect(self, index: ModuleIndex) -> None:
        for node in ast.walk(index.tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    index.canonical_callee(node.value.func) in (
                        "torch.distributed.new_group",
                        "torch.distributed.distributed_c10d.new_group"):
                for t in node.targets:
                    name = index.resolver.dotted(t)
                    if name:
                        self.group_names.add(name.split(".")[-1])


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

class Rule:
    """A lint rule.  Subclasses set ``id``/``doc`` and implement ``check``
    yielding findings for one module."""

    id: str = ""
    doc: str = ""

    def check(self, index: ModuleIndex,
              project: ProjectContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, index: ModuleIndex, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, index.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1, message)


_REGISTRY: Dict[str, Rule] = {}


def register_rule(cls):
    """Class decorator adding a rule to the global registry."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {inst.id!r}")
    _REGISTRY[inst.id] = inst
    return cls


def all_rules() -> Dict[str, Rule]:
    # rules module registers on import; deferred to avoid a cycle
    from repro_torch.analysis import rules as _rules  # noqa: F401
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# suppression + file runner
# ---------------------------------------------------------------------------

def suppressed_rules(lines: Sequence[str], lineno: int) -> Set[str]:
    """Rule ids allowed at ``lineno`` (1-based): from a trailing comment on
    the line itself or a standalone comment on the line above."""
    out: Set[str] = set()
    for ln in (lineno, lineno - 1):
        if 0 < ln <= len(lines):
            m = SUPPRESS_RE.search(lines[ln - 1])
            if m:
                out.update(p.strip() for p in m.group(1).split(","))
    return out


@dataclasses.dataclass
class FileReport:
    path: str
    findings: List[Finding]
    suppressed: int = 0
    error: Optional[str] = None


def index_file(path: str) -> Optional[ModuleIndex]:
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError):
        return None
    _SOURCE_CACHE[path] = source.splitlines()
    return ModuleIndex(path, tree, source)


def analyze_indexed(index: ModuleIndex, project: ProjectContext,
                    rules: Optional[Dict[str, Rule]] = None) -> FileReport:
    rules = rules if rules is not None else all_rules()
    lines = index.source.splitlines()
    findings: List[Finding] = []
    nsupp = 0
    for rule in rules.values():
        seen: Set[Tuple[str, int]] = set()
        for f in rule.check(index, project):
            key = (f.rule, f.line)
            if key in seen:        # rules may re-walk loop bodies
                continue
            seen.add(key)
            allowed = suppressed_rules(lines, f.line)
            if f.rule in allowed or "*" in allowed:
                nsupp += 1
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return FileReport(index.path, findings, nsupp)


DEFAULT_EXCLUDES = ("analysis_fixtures",)


def iter_python_files(paths: Sequence[str],
                      excludes: Sequence[str] = DEFAULT_EXCLUDES,
                      ) -> List[str]:
    """Expand dirs to .py files; explicit file paths bypass excludes (so
    tests can point the engine at a known-bad file directly)."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in excludes
                                 and not d.startswith(".")
                                 and d != "__pycache__")
                if any(e in root.split(os.sep) for e in excludes):
                    continue
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        out.append(os.path.join(root, fn))
        elif p.endswith(".py"):
            out.append(p)
    return out


def run_paths(paths: Sequence[str],
              rules: Optional[Dict[str, Rule]] = None,
              excludes: Sequence[str] = DEFAULT_EXCLUDES,
              ) -> List[FileReport]:
    """Analyze every .py under ``paths``.  Two passes: the first collects
    project-wide context (process-group names), the second runs rules."""
    files = iter_python_files(paths, excludes)
    indexes = []
    reports: List[FileReport] = []
    for path in files:
        idx = index_file(path)
        if idx is None:
            reports.append(FileReport(path, [], error="parse error"))
        else:
            indexes.append(idx)
    project = ProjectContext()
    for idx in indexes:
        project.collect(idx)
    for idx in indexes:
        reports.append(analyze_indexed(idx, project, rules))
    return reports
