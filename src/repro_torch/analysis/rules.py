"""The port's lint rules: one for each rule of ``repro.analysis.rules``,
guarding the same invariant in the port's idiom.

* ``host-sync-in-capture`` (replaces ``host-sync-in-jit``) — a fused
  window is a CUDA graph replayed K times (``core/window.py``); it is only
  a win if nothing in the captured step reads back to the host.
* ``collective-group`` (replaces ``collective-axis-consistency``) — a
  ``torch.distributed`` collective or point-to-point call that names no
  ``group`` runs on the default group, not on the stage group the port's
  transport always names (``pipeline/transport.py``); the counterpart of a
  collective over a wrong mesh axis.
* ``implicit-generator`` (replaces ``prng-key-reuse``) — a ``torch``
  random draw without ``generator=``, or ``torch.manual_seed`` in library
  code.  A ``torch.Generator`` is stateful, so key reuse as such has no
  counterpart; what correlates draws here is the shared global stream.
* ``tensor-branch`` (replaces ``tracer-branch``) — ``if``/``while``/
  ``assert`` or a conditional expression on a tensor value inside captured
  code: on the card it syncs, and inside a graph it bakes in one branch.
* ``state-after-dispatch`` (replaces ``donation-after-dispatch``) — the
  window advances the bound leaves and the device step in place
  (``core/window.py``), so a ``TrainState`` passed to a window's
  ``dispatch`` must not be read again; use the state ``drain`` returns.
* ``kernel-contract`` (replaces ``pallas-contract``) — an entry point of a
  library from ``kernels/build.load()`` must have its ``argtypes`` and
  ``restype`` set before it is called (ctypes cuts pointers to 32 bits
  otherwise), and nothing builds or loads a kernel at module import
  (``build.load``, ``build.build``, ``ctypes.CDLL``, ``import triton``):
  kernels build at first use (``kernels/build.py``).
* ``no-bare-print`` (the same id) — ``print()`` in ``src/repro_torch``
  library code; route output through ``repro_torch.telemetry.log``.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.engine import (Finding, ModuleIndex, ProjectContext,
                                         Rule, register_rule)


def _target_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in target.elts:
            out.extend(_target_names(el))
        return out
    return []


def _in_library(path: str) -> bool:
    """Files under a ``src/repro_torch`` directory pair (relative or
    absolute paths both resolve)."""
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    return any(a == "src" and b == "repro_torch"
               for a, b in zip(parts, parts[1:]))


# ---------------------------------------------------------------------------
# host-sync-in-capture
# ---------------------------------------------------------------------------

HOST_SYNC_CALLS = {
    "torch.cuda.synchronize": "waits for the device",
    "numpy.asarray": "copies the tensor to the host",
    "numpy.array": "copies the tensor to the host",
}
HOST_SYNC_METHODS = {
    "item": "reads the value to the host",
    "tolist": "copies the tensor to the host",
    "numpy": "copies the tensor to the host",
    "cpu": "copies the tensor to the host",
}
CAST_BUILTINS = {"float", "int", "bool", "complex"}


@register_rule
class HostSyncInCapture(Rule):
    id = "host-sync-in-capture"
    doc = ("host read (.item()/.tolist()/.numpy()/.cpu()/float()/"
           "np.asarray/torch.cuda.synchronize) in code a CUDA graph captures")

    def check(self, index: ModuleIndex,
              project: ProjectContext) -> Iterable[Finding]:
        res = index.resolver
        for region in index.captured:
            for node in ast.walk(region):
                if not isinstance(node, ast.Call):
                    continue
                canon = res.canonical(node.func)
                if canon in HOST_SYNC_CALLS:
                    yield self.finding(
                        index, node,
                        f"`{canon}` inside captured code "
                        f"({HOST_SYNC_CALLS[canon]}); move it out of the "
                        f"window body or defer it to the window's drain")
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in HOST_SYNC_METHODS):
                    yield self.finding(
                        index, node,
                        f"`.{node.func.attr}()` inside captured code "
                        f"{HOST_SYNC_METHODS[node.func.attr]} (a sync); "
                        f"keep the value on the device")
                elif (isinstance(node.func, ast.Name)
                      and node.func.id in CAST_BUILTINS
                      and node.args
                      and not isinstance(node.args[0], ast.Constant)):
                    yield self.finding(
                        index, node,
                        f"`{node.func.id}(...)` on a non-constant inside "
                        f"captured code reads a tensor to the host (a "
                        f"sync); use a tensor op or move it to the host "
                        f"side")


# ---------------------------------------------------------------------------
# collective-group
# ---------------------------------------------------------------------------

# canonical collective -> index of its positional ``group`` argument
COLLECTIVES = {
    "all_reduce": 2, "all_gather": 2, "all_gather_into_tensor": 2,
    "all_gather_object": 2, "broadcast": 2, "broadcast_object_list": 2,
    "reduce": 3, "reduce_scatter": 3, "reduce_scatter_tensor": 3,
    "all_to_all": 2, "all_to_all_single": 4, "gather": 3, "scatter": 3,
    "send": 2, "recv": 2, "isend": 2, "irecv": 2, "P2POp": 3,
    "barrier": 0,
}
DIST_ROOTS = ("torch.distributed.distributed_c10d.", "torch.distributed.")


@register_rule
class CollectiveGroup(Rule):
    id = "collective-group"
    doc = ("a torch.distributed collective or point-to-point call that "
           "names no group (runs on the default group)")

    def check(self, index: ModuleIndex,
              project: ProjectContext) -> Iterable[Finding]:
        named = sorted(project.group_names)
        for node in ast.walk(index.tree):
            if not isinstance(node, ast.Call):
                continue
            canon = index.canonical_callee(node.func) or ""
            root = next((r for r in DIST_ROOTS if canon.startswith(r)), None)
            if root is None:
                continue
            name = canon[len(root):]
            if name not in COLLECTIVES:
                continue
            if any(kw.arg == "group" for kw in node.keywords) or \
                    len(node.args) > COLLECTIVES[name]:
                continue
            yield self.finding(
                index, node,
                f"`{name}` names no group and runs on the default process "
                f"group; pass the stage group (`group=...`) as the "
                f"transport does" + (f" (groups made here: {named})"
                                     if named else ""))


# ---------------------------------------------------------------------------
# implicit-generator
# ---------------------------------------------------------------------------

RANDOM_FUNCTIONS = {
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm", "torch.normal",
    "torch.bernoulli", "torch.multinomial", "torch.poisson",
}
RANDOM_METHODS = {"normal_", "uniform_", "random_", "bernoulli_",
                  "exponential_", "cauchy_", "log_normal_", "geometric_"}
INIT_ROOTS = ("torch.nn.init.",)
INIT_DRAWS = {"uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
              "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
              "orthogonal_", "sparse_"}
GLOBAL_SEEDS = {"torch.manual_seed", "torch.random.manual_seed",
                "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}


@register_rule
class ImplicitGenerator(Rule):
    id = "implicit-generator"
    doc = ("a torch random draw without generator= (the shared global "
           "stream), or torch.manual_seed in src/repro_torch library code")

    def check(self, index: ModuleIndex,
              project: ProjectContext) -> Iterable[Finding]:
        library = _in_library(index.path)
        for node in ast.walk(index.tree):
            if not isinstance(node, ast.Call):
                continue
            canon = index.canonical_callee(node.func) or ""
            if canon in GLOBAL_SEEDS:
                if library:
                    yield self.finding(
                        index, node,
                        f"`{canon}` in library code reseeds the global "
                        f"stream every caller shares; draw from a "
                        f"`torch.Generator` of the run's own")
                continue
            method = (node.func.attr if isinstance(node.func, ast.Attribute)
                      else "")
            draws = (canon in RANDOM_FUNCTIONS
                     or (canon.startswith(INIT_ROOTS)
                         and canon.split(".")[-1] in INIT_DRAWS)
                     or (method in RANDOM_METHODS
                         and not canon.startswith(INIT_ROOTS)))
            if draws and not any(kw.arg == "generator"
                                 for kw in node.keywords):
                what = canon if canon in RANDOM_FUNCTIONS or \
                    canon.startswith(INIT_ROOTS) else f".{method}"
                yield self.finding(
                    index, node,
                    f"`{what}` draws from the global stream (no "
                    f"`generator=`); draws that share it are correlated "
                    f"with every other user of it, so pass a seeded "
                    f"`torch.Generator`")


# ---------------------------------------------------------------------------
# tensor-branch
# ---------------------------------------------------------------------------

# torch callables that return no tensor (or a host Python value that is no
# read of a tensor's data)
HOST_VALUED = ("torch.is_", "torch.cuda.", "torch.backends.",
               "torch.distributed.", "torch.jit.", "torch.get_",
               "torch.are_", "torch.set_", "torch.autograd.", "torch.utils.",
               "torch.nn.", "torch.Generator", "torch.device", "torch.dtype",
               "torch.finfo", "torch.iinfo", "torch.Size", "torch.no_grad",
               "torch.enable_grad", "torch.inference_mode", "torch.numel",
               "torch.promote_types", "torch.result_type",
               "torch.can_cast")
# builtins that read a tensor's type or shape, not its data
HOST_BUILTINS = {"isinstance", "len", "hasattr", "getattr", "type", "id",
                 "callable"}
# tensor attributes and methods that read metadata, not data
METADATA = {"shape", "dtype", "device", "ndim", "is_cuda", "requires_grad",
            "layout", "is_leaf", "names", "size", "dim", "numel", "stride",
            "is_contiguous", "data_ptr", "element_size", "nelement",
            "is_floating_point", "is_complex", "get_device", "storage_offset",
            "untyped_storage"}


def _torch_tensor_call(canon: Optional[str]) -> bool:
    return canon is not None and canon.startswith("torch.") and \
        not canon.startswith(HOST_VALUED)


@register_rule
class TensorBranch(Rule):
    id = "tensor-branch"
    doc = ("Python `if`/`while`/`assert`/conditional expression on a tensor "
           "value inside captured code (a sync; one branch baked into the "
           "graph)")

    def check(self, index: ModuleIndex,
              project: ProjectContext) -> Iterable[Finding]:
        res = index.resolver
        for region in index.captured:
            tensorish: Set[str] = set()
            # forward pass in source order: collect tensor-valued locals
            for node in ast.walk(region):
                if isinstance(node, ast.Assign) and self._is_tensorish(
                        res, node.value, tensorish):
                    for t in node.targets:
                        tensorish.update(_target_names(t))
            for node in ast.walk(region):
                if isinstance(node, (ast.If, ast.While, ast.IfExp,
                                     ast.Assert)):
                    hit = self._test_hits(res, node.test, tensorish)
                    if hit:
                        kind = {ast.If: "if", ast.While: "while",
                                ast.IfExp: "conditional expression",
                                ast.Assert: "assert"}[type(node)]
                        yield self.finding(
                            index, node,
                            f"`{kind}` on tensor value `{hit}` inside "
                            f"captured code; use torch.where or a mask, or "
                            f"decide on the host before the window")

    def _is_tensorish(self, res, value: ast.AST, tensorish: Set[str]) -> bool:
        if isinstance(value, ast.Call):
            if _torch_tensor_call(res.canonical(value.func)):
                return True
            # a method of a tensor: x.sum(), x.float(), ... (not metadata)
            return (isinstance(value.func, ast.Attribute)
                    and value.func.attr not in METADATA
                    and self._is_tensorish(res, value.func.value, tensorish))
        if isinstance(value, ast.BinOp):
            return (self._is_tensorish(res, value.left, tensorish)
                    or self._is_tensorish(res, value.right, tensorish))
        if isinstance(value, ast.Subscript):
            return self._is_tensorish(res, value.value, tensorish)
        if isinstance(value, ast.UnaryOp):
            return self._is_tensorish(res, value.operand, tensorish)
        if isinstance(value, ast.Name):
            return value.id in tensorish
        if isinstance(value, ast.Compare):
            return self._is_tensorish(res, value.left, tensorish) or any(
                self._is_tensorish(res, c, tensorish)
                for c in value.comparators)
        return False

    @staticmethod
    def _host_valued(res, call: ast.Call) -> bool:
        """A call whose value reads no tensor data: ``torch.is_*`` and the
        like, ``len``/``isinstance`` and friends (shape and type)."""
        canon = res.canonical(call.func) or ""
        return canon.startswith(HOST_VALUED) or canon in HOST_BUILTINS

    def _test_hits(self, res, test: ast.AST,
                   tensorish: Set[str]) -> Optional[str]:
        skip: Set[ast.AST] = set()
        for node in ast.walk(test):
            if node in skip:
                continue
            # `x is None` / `x is not None` inspect identity, not the
            # tensor's value — the optional-argument idiom is fine; so is
            # reading metadata (`x.shape[0] > 1`, `x.dim() == 2`)
            if (isinstance(node, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)) \
                    or (isinstance(node, ast.Attribute)
                        and node.attr in METADATA) \
                    or (isinstance(node, ast.Call)
                        and self._host_valued(res, node)):
                skip.update(ast.walk(node))
                continue
            if isinstance(node, ast.Name) and node.id in tensorish:
                return node.id
            if isinstance(node, ast.Call):
                canon = res.canonical(node.func)
                if _torch_tensor_call(canon):
                    return canon
        return None


# ---------------------------------------------------------------------------
# state-after-dispatch
# ---------------------------------------------------------------------------

# a window's dispatch takes the state as its first argument
DISPATCH_METHODS = {"dispatch": 0}


@register_rule
class StateAfterDispatch(Rule):
    id = "state-after-dispatch"
    doc = ("a TrainState passed to a window's dispatch is read again before "
           "it is rebound (the window advances its leaves and step in "
           "place); use the state drain returns")

    def check(self, index: ModuleIndex,
              project: ProjectContext) -> Iterable[Finding]:
        for fn in index.functions.values():
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_fn(index, fn)

    def _check_fn(self, index: ModuleIndex, fn) -> Iterable[Finding]:
        res = index.resolver
        findings: List[Finding] = []
        # live: dispatched dotted-name -> lineno of the dispatch
        live: Dict[str, int] = {}

        def kill(target_name: Optional[str]) -> None:
            if not target_name:
                return
            for nm in list(live):
                if nm == target_name or nm.startswith(target_name + ".") \
                        or target_name.startswith(nm + "."):
                    del live[nm]

        def scan_reads(node: ast.AST) -> None:
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Name, ast.Attribute)) and \
                        isinstance(getattr(sub, "ctx", None), ast.Load):
                    nm = res.dotted(sub)
                    if nm is None:
                        continue
                    for sent, ln in live.items():
                        if nm == sent or nm.startswith(sent + "."):
                            findings.append(self.finding(
                                index, sub,
                                f"`{nm}` went to a window's dispatch at "
                                f"line {ln} and is read before its drain "
                                f"returns the state after the window; the "
                                f"window advances the leaves and the step "
                                f"in place — read the drained state"))
                            break

        def handle_stmt(stmt: ast.stmt) -> None:
            # reads anywhere in the statement (incl. its own call args —
            # dispatching an already-dispatched state is itself a read)
            scan_reads(stmt)
            for call in (n for n in ast.walk(stmt) if isinstance(n, ast.Call)):
                if not isinstance(call.func, ast.Attribute) or \
                        call.func.attr not in DISPATCH_METHODS:
                    continue
                i = DISPATCH_METHODS[call.func.attr]
                if i < len(call.args):
                    nm = res.dotted(call.args[i])
                    if nm:
                        live[nm] = call.lineno
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    if isinstance(t, (ast.Tuple, ast.List)):
                        for el in t.elts:
                            kill(res.dotted(el))
                    else:
                        kill(res.dotted(t))

        def walk(body: Sequence[ast.stmt]) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue  # visited via index.functions
                if isinstance(stmt, ast.If):
                    scan_reads(stmt.test)
                    saved = dict(live)
                    walk(stmt.body)
                    after_body = dict(live)
                    live.clear()
                    live.update(saved)
                    walk(stmt.orelse)
                    live.update(after_body)
                elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                    walk(stmt.body)
                    walk(stmt.body)   # second pass: catches next-iteration
                    walk(stmt.orelse)  # reads of a state dispatched in-loop
                elif isinstance(stmt, ast.Try):
                    walk(stmt.body)
                    for h in stmt.handlers:
                        walk(h.body)
                    walk(stmt.orelse)
                    walk(stmt.finalbody)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        scan_reads(item.context_expr)
                    walk(stmt.body)
                else:
                    handle_stmt(stmt)

        walk(fn.body)
        seen: Set[int] = set()
        for f in findings:
            if f.line not in seen:
                seen.add(f.line)
                yield f


# ---------------------------------------------------------------------------
# kernel-contract
# ---------------------------------------------------------------------------

LOADERS = {"build.load", "ctypes.CDLL", "ctypes.cdll.LoadLibrary"}
IMPORT_TIME_BUILDS = {"build.load", "build.build", "ctypes.CDLL",
                      "ctypes.cdll.LoadLibrary"}


def _leaf2(canon: Optional[str]) -> str:
    """The last two segments of a dotted name (``x.y.build.load`` ->
    ``build.load``)."""
    return ".".join((canon or "").split(".")[-2:])


@register_rule
class KernelContract(Rule):
    id = "kernel-contract"
    doc = ("a kernel library's entry point called before its argtypes and "
           "restype are set; a kernel built or loaded at module import")

    def check(self, index: ModuleIndex,
              project: ProjectContext) -> Iterable[Finding]:
        for fn in index.functions.values():
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_entries(index, fn)
        yield from self._check_import_time(index)

    def _is_loader(self, index: ModuleIndex, call: ast.AST) -> bool:
        if not isinstance(call, ast.Call):
            return False
        canon = index.canonical_callee(call.func)
        return _leaf2(canon) in LOADERS or canon in LOADERS

    def _check_entries(self, index: ModuleIndex,
                       fn) -> Iterable[Finding]:
        res = index.resolver
        libs: Set[str] = set()           # names bound to a loaded library
        entries: Set[str] = set()        # names bound to one of its entries
        bound: Dict[str, Set[str]] = {}  # entry -> {"argtypes", "restype"}
        nodes = sorted((n for n in ast.walk(fn) if hasattr(n, "lineno")),
                       key=lambda n: (n.lineno, n.col_offset))
        for node in nodes:
            if isinstance(node, ast.Assign):
                value = node.value
                names = [n for t in node.targets for n in _target_names(t)]
                if self._is_loader(index, value):
                    libs.update(names)
                elif (isinstance(value, ast.Attribute)
                      and isinstance(value.value, ast.Name)
                      and value.value.id in libs) or (
                        isinstance(value, ast.Call)
                        and isinstance(value.func, ast.Name)
                        and value.func.id == "getattr" and value.args
                        and isinstance(value.args[0], ast.Name)
                        and value.args[0].id in libs):
                    entries.update(names)
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            t.attr in ("argtypes", "restype"):
                        owner = res.dotted(t.value)
                        if owner:
                            bound.setdefault(owner, set()).add(t.attr)
            elif isinstance(node, ast.Call):
                callee = res.dotted(node.func)
                if callee is None:
                    continue
                head = callee.split(".")[0]
                is_entry = callee in entries or (
                    head in libs and callee.count(".") == 1)
                if is_entry and bound.get(callee, set()) != {"argtypes",
                                                              "restype"}:
                    missing = sorted({"argtypes", "restype"}
                                     - bound.get(callee, set()))
                    yield self.finding(
                        index, node,
                        f"kernel entry point `{callee}` called before its "
                        f"{' and '.join(missing)} are set; without argtypes "
                        f"ctypes passes each pointer as a 32-bit int")

    def _check_import_time(self, index: ModuleIndex) -> Iterable[Finding]:
        for stmt in index.tree.body:          # module scope only
            for node in self._import_time_nodes(stmt):
                if isinstance(node, ast.Call):
                    canon = index.canonical_callee(node.func)
                    if _leaf2(canon) in IMPORT_TIME_BUILDS or \
                            canon in IMPORT_TIME_BUILDS:
                        yield self.finding(
                            index, node,
                            f"`{canon}` at module import builds or loads a "
                            f"kernel; kernels build at first use, inside "
                            f"the function that launches them")
                elif isinstance(node, (ast.Import, ast.ImportFrom)):
                    mods = ([a.name for a in node.names]
                            if isinstance(node, ast.Import)
                            else [node.module or ""])
                    if any(m == "triton" or m.startswith("triton.")
                           for m in mods):
                        yield self.finding(
                            index, node,
                            "`import triton` at module import; import it "
                            "inside the function that launches the kernel "
                            "(machines without triton import every module)")

    @staticmethod
    def _import_time_nodes(stmt: ast.AST) -> Iterable[ast.AST]:
        """The nodes of a module-level statement that run at import:
        function bodies (and lambdas) are call-time; class bodies run."""
        stack = [stmt]
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # decorators and defaults run at import, the body does not
                stack.extend(getattr(node, "decorator_list", []))
                continue
            stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# no-bare-print
# ---------------------------------------------------------------------------

@register_rule
class NoBarePrint(Rule):
    id = "no-bare-print"
    doc = ("bare print() in src/repro_torch library code; route output "
           "through repro_torch.telemetry.log (CLI output lines may "
           "suppress)")

    def check(self, index: ModuleIndex,
              project: ProjectContext) -> Iterable[Finding]:
        # library code only: the rule applies to files under a
        # src/repro_torch directory pair, which leaves tests, examples,
        # scripts and snippets free to print
        if not _in_library(index.path):
            return
        for node in ast.walk(index.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                yield self.finding(
                    index, node,
                    "bare print() in library code; use "
                    "repro_torch.telemetry.log(...) (verbosity knob + "
                    "mirrored into the event stream), or mark deliberate "
                    "CLI output with `# repro: allow[no-bare-print]`")
