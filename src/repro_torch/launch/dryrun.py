"""Dry-run: memory, FLOPs and roofline terms of every (architecture x input
shape) pair on meta tensors, the counterpart of ``repro.launch.dryrun``.

For every pair this builds the step function JAX's dry-run compiles and runs
it on the meta device (shapes only, nothing allocated, no kernel launched):

  * train_4k      -> train_step (``Model.loss(remat=True)``, backward, the
                     global norm through ``ops.adam_sumsq`` and the Adam
                     update through ``ops.adam_update``)
  * prefill_32k   -> prefill (forward + KV/SSM cache emission)
  * decode_32k /
    long_500k     -> serve_step (ONE token against a seq_len cache)

Each record has JAX's keys: ``status``, ``variant``, ``cost_mode``,
``memory``, ``cost``, ``collectives_B_per_dev`` and ``roofline``.

* Mesh: JAX's (``data`` 16 x ``model`` 16; ``pod`` 2 x 16 x 16 with
  ``--multi-pod``), so each leaf's spec is JAX's (``launch.shardings``), or
  ``--mesh 1x1``: one card, nothing sharded, batch ``--batch`` x ``--seq``.
* Arguments: exact per-device bytes of the parameters (fp32 masters to
  train, the ``cfg.dtype`` serving weights the port holds to serve), Adam's
  m and v, and the batch or cache, under their specs.
* Temp: the peak of live bytes above the arguments while the step runs at
  the per-device batch (global batch / data size).  A dispatch mode adds
  each new storage's bytes as an op makes it and drops them when the
  storage dies.  So the whole-tree bf16 cast of ``Model.loss`` is counted,
  and with remat only the block inputs plus one block's recompute.  On a
  sharded mesh a buffer shaped like a parameter leaf (or one layer of it:
  the cast, the gradients) counts with that leaf's share on a device, and
  with ``REPRO_ACT_SHARD`` set every (B, S, d) activation with 1 / model
  size; on ``1x1`` every byte counts.  The port's Adam updates in place, so
  ``output_B`` is the step's outputs (the loss and gradients, to train),
  ``alias_B`` 0 and ``peak_est_B`` = arguments + the live peak.
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` for the products
  PyTorch runs, plus each hand-written kernel's own count
  (``kernels.cost``, credited by the kernels' meta branches); the recompute
  of remat is counted, as XLA counts it.  ``bytes_per_dev``: each op's
  inputs and outputs (views and empty allocations excepted) plus the
  kernels' own byte counts.  On a sharded mesh both divide by the model
  axis size: each product is taken to split evenly over it.
* Collectives, reckoned from the specs (the port emits no HLO, so JAX's
  ``collective_bytes`` has no counterpart), per device, train only:

    all-reduce  = sum over leaves of 2 (n - 1) / n x the leaf's fp32
                  gradient bytes on a device, n = data size (x pod);
    all-gather  (``REPRO_PARAM_SHARD=fsdp``) = sum over leaves sharded
                  over ``data`` of 2 (forward and backward) x (d - 1) x the
                  bf16 cast's bytes on a device, d = the data axis size.

  The model axis's collectives of the activations are not reckoned.
* Every layer runs (the towers are Python loops), so no depth is
  extrapolated: ``cost_mode`` is ``"full-depth"`` (JAX's ``scan_util`` and
  its extrapolation have no counterpart).

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
          --shape all [--multi-pod] [--out dryrun.json]
      PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 1x1 \\
          --arch qwen3-4b --shape train_4k --batch 1 --seq 512
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as TR
from repro_torch.config import (INPUT_SHAPES, InputShape, ModelConfig,
                                OptimizerConfig)
from repro_torch.configs import arch_ids, get_config
from repro_torch.data.pipeline import D_PATCH
from repro_torch.kernels import cost, ops
from repro_torch.launch import perf
from repro_torch.launch import shardings as SH
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.optim.adam import adam_step
from repro_torch.telemetry import log

# NVIDIA H100 SXM5 80GB datasheet, at its 700 W limit ("NVIDIA H100 80GB
# HBM3, 700.00 W" on the machine the port is measured on): dense BF16
# tensor-core peak and HBM3 bandwidth
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
# the per-GPU inter-node link: NDR InfiniBand, 400 Gb/s = 50 GB/s (one
# ConnectX-7 a GPU on a DGX H100); a model axis of 16 spans two 8-GPU
# NVLink nodes, so its collectives cross this link
LINK_BW = 50e9

SWA_SERVING_WINDOW = 8192   # ring-KV window for the long_500k dense variant

# (arch, shape) pairs that are skipped, with the documented reason
SKIPS = {
    ("whisper-large-v3", "long_500k"):
        "enc-dec decoder capped at 448 target positions; 524k-token decode "
        "is architecturally meaningless (DESIGN.md §6)",
}

MESHES = {"16x16": lambda: SH.production_mesh(False),
          "2x16x16": lambda: SH.production_mesh(True),
          "1x1": SH.one_card_mesh}


def decode_plan(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Decide cache capacity / attention window for a decode shape."""
    native_swa = cfg.sliding_window > 0
    if cfg.arch_type == "ssm":
        return {"capacity": 0, "window": 0, "variant": "native-ssm"}
    if shape.name == "long_500k":
        if cfg.arch_type == "hybrid":
            return {"capacity": SWA_SERVING_WINDOW,
                    "window": SWA_SERVING_WINDOW,
                    "variant": "native-ssm+swa-shared-attn"}
        if native_swa:
            return {"capacity": cfg.sliding_window,
                    "window": cfg.sliding_window, "variant": "native-swa"}
        return {"capacity": SWA_SERVING_WINDOW, "window": SWA_SERVING_WINDOW,
                "variant": "swa-serving"}
    # decode_32k
    if native_swa:
        return {"capacity": cfg.sliding_window, "window": cfg.sliding_window,
                "variant": "native-swa"}
    return {"capacity": shape.seq_len, "window": 0, "variant": "full-cache"}


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def param_tree(cfg: ModelConfig, device="meta", dtype=None) -> Dict[str, Any]:
    """The parameter tree's shapes as empty tensors on ``device`` (meta by
    default): the counterpart of ``jax.eval_shape(model.init)``.  On meta
    nothing is drawn."""
    model = Model(cfg, device=device, weights=False)
    return model.init(None, dtype=dtype)


def plan_for(cfg: ModelConfig, shape: InputShape, *,
             batch: Optional[int] = None,
             seq: Optional[int] = None) -> Dict[str, Any]:
    """The step's kind, global batch, sequence, tokens a step and, to
    decode, JAX's cache plan; ``batch`` and ``seq`` replace the shape's."""
    b = shape.global_batch if batch is None else batch
    s = shape.seq_len if seq is None else seq
    plan: Dict[str, Any] = {"kind": shape.kind, "batch": b, "seq": s}
    if shape.kind in ("train", "prefill"):
        plan["text"] = s - (cfg.num_patches if cfg.arch_type == "vlm" else 0)
        plan["tokens_per_step"] = s * b
        if shape.kind == "prefill":
            plan["capacity"] = s
        return plan
    dp = decode_plan(cfg, InputShape(shape.name, s, b, shape.kind))
    plan.update(dp)
    plan["tokens_per_step"] = b
    return plan


def batch_inputs(cfg: ModelConfig, plan: Dict[str, Any], b: int,
                 device="meta") -> Dict[str, torch.Tensor]:
    """The batch (train, prefill) or the next tokens (decode) at batch
    ``b``: int32 tokens as JAX's, frames and patches in ``cfg.dtype``."""
    dt = L.to_dtype(cfg.dtype)
    if plan["kind"] == "decode":
        return {"tokens": torch.empty((b,), dtype=torch.int32, device=device)}
    s = plan["text"]
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device=device)}
    if plan["kind"] == "train":
        out["labels"] = torch.empty((b, s), dtype=torch.int32, device=device)
    if cfg.arch_type == "vlm":
        out["patches"] = torch.empty((b, cfg.num_patches, D_PATCH), dtype=dt,
                                     device=device)
    if cfg.arch_type == "encdec":
        out["frames"] = torch.empty((b, cfg.encoder_seq_len, cfg.d_model),
                                    dtype=dt, device=device)
    return out


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    """Adam's fp32 moments, leaf by leaf in ``tree.leaves`` order, and the
    0-d int32 count of steps taken."""
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    step: torch.Tensor


def init_state(params: Dict[str, Any]) -> AdamState:
    leaves = TR.leaves(params)
    dev = leaves[0].device
    return AdamState([torch.zeros_like(p, dtype=torch.float32)
                      for p in leaves],
                     [torch.zeros_like(p, dtype=torch.float32)
                      for p in leaves],
                     torch.zeros((), dtype=torch.int32, device=dev))


def make_step_fn(model: Model, plan: Dict[str, Any],
                 ocfg: Optional[OptimizerConfig] = None, *,
                 remat: bool = True) -> Callable:
    """The step function of ``plan["kind"]``: ``train_step(params, state,
    batch) -> (loss, gradients)`` (Adam applied to ``params`` and ``state``
    in place; ``remat`` as JAX's dry-run, True), ``prefill_step(params,
    batch) -> (logits, cache)`` or ``serve_step(params, cache, tokens) ->
    (logits, cache)``."""
    cfg = model.cfg
    ocfg = ocfg or OptimizerConfig()
    if plan["kind"] == "train":
        def train_step(params, state: AdamState, batch):
            leaves = TR.leaves(params)
            loss, _ = model.loss(params, batch, remat=remat)
            grads = list(torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                _, total = ops.adam_sumsq(grads, [False] * len(grads), 1)
                adam_step(ocfg, leaves, grads, state.m, state.v, state.step,
                          torch.ones((), dtype=torch.float32,
                                     device=total.device), total.sqrt())
            return loss.detach(), grads
        return train_step
    fam = model.family
    if plan["kind"] == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                kw = {k: batch[k] for k in ("frames", "patches")
                      if k in batch}
                return fam.prefill(params, cfg, batch["tokens"],
                                   plan["capacity"], **kw)
        return prefill_step

    def serve_step(params, cache, tokens):
        with torch.no_grad():
            return fam.decode_step(params, cfg, cache, tokens,
                                   window=plan["window"])
    return serve_step


# ---------------------------------------------------------------------------
# the meta run's bytes
# ---------------------------------------------------------------------------

_NO_TRAFFIC = {"empty", "empty_like", "new_empty", "empty_strided",
               "new_empty_strided", "detach", "alias", "_unsafe_view",
               "lift_fresh"}


class LiveBytes(TorchDispatchMode):
    """Within: the live bytes of the storages that ops make (their peak),
    and the bytes ops read and write.  ``weight`` gives a new storage's
    weight from its first tensor (a sharded share; 1 by default)."""

    def __init__(self, known: List[torch.Tensor],
                 weight: Optional[Callable[[torch.Tensor], float]] = None):
        super().__init__()
        self.weight = weight or (lambda t: 1.0)
        self.live = 0.0
        self.peak = 0.0
        self.traffic = 0
        self._seen: Dict[int, float] = {}
        self._known = {id(t.untyped_storage()) for t in known}

    def _drop(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0.0)

    def held(self, tensors: List[torch.Tensor]) -> float:
        """The weighted bytes of the storages of ``tensors`` that ops made
        within (not the arguments')."""
        keys = {id(t.untyped_storage()) for t in tensors}
        return sum(self._seen.get(k, 0.0) for k in keys)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        if (not func.is_view and name not in _NO_TRAFFIC
                and func.namespace != "repro_torch"):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.traffic += sum(t.numel() * t.element_size()
                                for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen or key in self._known:
                continue
            w = st.nbytes() * self.weight(t)
            self._seen[key] = w
            self.live += w
            weakref.finalize(st, self._drop, key)
        self.peak = max(self.peak, self.live)
        return out


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _leaf_shares(params: Dict[str, Any], mesh: SH.MeshSpec
                 ) -> Dict[Tuple[int, ...], float]:
    """Each leaf's shape (and one layer of a stacked leaf's) -> the share
    of it one device holds."""
    shares: Dict[Tuple[int, ...], float] = {}
    for path, leaf in TR.leaves_with_path(params):
        shape = tuple(leaf.shape)
        spec = SH.param_spec(shape, mesh, path_str=SH.keystr(path))
        f = SH.share(shape, spec, mesh)
        shares.setdefault(shape, f)
        if len(shape) >= 3:
            shares.setdefault(shape[1:], f)
    return shares


def measure(step: Callable, args: Tuple, *, known: List[torch.Tensor],
            weight: Optional[Callable[[torch.Tensor], float]] = None,
            with_cost: bool = True) -> Dict[str, Any]:
    """Run ``step(*args)`` on meta tensors once: its live-byte peak above
    ``known`` (the arguments), its outputs' bytes, FLOPs, bytes accessed
    and the kernels it called."""
    flops = FlopCounterMode(display=False) if with_cost else None
    with cost.tally() as tally:
        with (flops if flops is not None else contextlib.nullcontext()):
            with LiveBytes(known, weight) as live:
                result = step(*args)
                out_bytes = live.held(_tensors(result))
    return {"peak": live.peak, "output": out_bytes,
            "flops": (flops.get_total_flops() + tally.total_flops
                      if flops is not None else 0),
            "kernel_flops": tally.total_flops,
            "bytes": live.traffic + tally.total_bytes,
            "kernels": dict(tally.calls), "result": result}


# ---------------------------------------------------------------------------
# single dry-run
# ---------------------------------------------------------------------------

def _bytes(shape, itemsize, spec, mesh) -> int:
    return SH.shard_bytes(tuple(shape), itemsize, spec, mesh)


def useful_flops(cfg: ModelConfig, plan: Dict[str, Any]) -> int:
    """JAX's ``model_flops``: 6 (train) or 2 x active parameters x tokens
    a step."""
    mult = 6 if plan["kind"] == "train" else 2
    return mult * cfg.active_param_count() * plan["tokens_per_step"]


def collectives(params: Dict[str, Any], mesh: SH.MeshSpec,
                cast_itemsize: int) -> Dict[str, float]:
    """The train step's per-device collective bytes (module docstring)."""
    n, d = SH.data_size(mesh), mesh.shape["data"]
    fsdp = os.environ.get("REPRO_PARAM_SHARD", "baseline") == "fsdp"
    reduce_b = gather_b = 0.0
    for path, leaf in TR.leaves_with_path(params):
        shape = tuple(leaf.shape)
        spec = SH.param_spec(shape, mesh, path_str=SH.keystr(path))
        grad = _bytes(shape, 4, spec, mesh)
        if n > 1:
            reduce_b += 2 * (n - 1) / n * grad
        on_data = any(e == "data" or (isinstance(e, tuple) and "data" in e)
                      for e in spec)
        if fsdp and on_data and d > 1:
            gather_b += 2 * (d - 1) * _bytes(shape, cast_itemsize, spec, mesh)
    out = {}
    if reduce_b:
        out["all-reduce"] = reduce_b
    if gather_b:
        out["all-gather"] = gather_b
    return out


def run_one(arch: str, shape_name: str, *, mesh: str = "16x16",
            with_cost: bool = True, verbose: bool = True,
            cfg: Optional[ModelConfig] = None, batch: Optional[int] = None,
            seq: Optional[int] = None) -> Dict[str, Any]:
    """The record of one (arch, shape) on ``mesh`` ("16x16", "2x16x16",
    "1x1"); ``cfg``, ``batch`` and ``seq`` replace the registered config
    and the shape's batch and sequence (a cut that fits one card)."""
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh}
    if (arch, shape_name) in SKIPS:
        rec["status"] = "skipped"
        rec["reason"] = SKIPS[(arch, shape_name)]
        return rec
    t0 = time.time()
    try:
        cfg = cfg or get_config(arch)
        m = MESHES[mesh]()
        plan = plan_for(cfg, INPUT_SHAPES[shape_name], batch=batch, seq=seq)
        rec.update(_estimate(cfg, plan, m, with_cost))
        rec["trace_s"] = round(time.time() - t0, 1)
        if verbose:
            r = rec["roofline"]
            log(f"[ok] {arch:22s} {shape_name:12s} {mesh:8s} "
                f"{rec['trace_s']:6.1f}s mem/dev "
                f"{rec['memory']['peak_est_B'] / 2**30:8.2f}GiB "
                f"c/m/coll {r['compute_s']:.2e}/{r['memory_s']:.2e}/"
                f"{r['collective_s']:.2e}s dom={r['dominant']} "
                f"useful={r['useful_ratio']:.2f}")
    except Exception as e:   # noqa: BLE001 — record failures in the report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            log(f"[ERR] {arch} {shape_name}: {rec['error'][:200]}")
    return rec


def _estimate(cfg: ModelConfig, plan: Dict[str, Any], mesh: SH.MeshSpec,
              with_cost: bool) -> Dict[str, Any]:
    kind = plan["kind"]
    model = Model(cfg, device="meta", weights=False)
    dtype = None if kind == "train" else cfg.dtype
    params = param_tree(cfg, dtype=dtype)
    shares = _leaf_shares(params, mesh)
    leaves = TR.leaves(params)
    arg_b = sum(_bytes(p.shape, p.element_size(),
                       SH.param_spec(tuple(p.shape), mesh,
                                     path_str=SH.keystr(path)), mesh)
                for path, p in TR.leaves_with_path(params))
    gb = plan["batch"]
    b_dev = SH.shard_shape((gb,), SH.batch_spec((gb,), mesh), mesh)[0]
    msize = SH.model_size(mesh)
    act = perf.activation_spec()
    act_share = 1.0 / msize if act is not None else 1.0

    def weight(t: torch.Tensor) -> float:
        shape = tuple(t.shape)
        if t.is_floating_point() and shape in shares:
            return shares[shape]
        if t.dim() == 3 and shape[0] == b_dev and shape[2] == cfg.d_model:
            return act_share
        return 1.0

    step = make_step_fn(model, plan)
    if kind == "train":
        for p in leaves:
            p.requires_grad_(True)
        state = init_state(params)
        arg_b *= 3                      # fp32 masters, m and v
        batch = batch_inputs(cfg, plan, b_dev)
        arg_b += sum(_bytes((gb, *t.shape[1:]), t.element_size(),
                            SH.batch_spec((gb, *t.shape[1:]), mesh), mesh)
                     for t in batch.values())
        args = (params, state, batch)
    elif kind == "prefill":
        batch = batch_inputs(cfg, plan, b_dev)
        arg_b += sum(_bytes((gb, *t.shape[1:]), t.element_size(),
                            SH.batch_spec((gb, *t.shape[1:]), mesh), mesh)
                     for t in batch.values())
        args = (params, batch)
    else:
        cap = max(plan["capacity"], 1)
        full = model.family.init_cache(cfg, gb, cap, "meta")
        for leaf in _tensors(full):
            arg_b += _bytes(leaf.shape, leaf.element_size(),
                            SH.cache_spec(tuple(leaf.shape), mesh), mesh)
        cache = model.family.init_cache(cfg, b_dev, cap, "meta")
        tokens = batch_inputs(cfg, plan, b_dev)["tokens"]
        arg_b += _bytes((gb,), 4, SH.batch_spec((gb,), mesh), mesh)
        args = (params, cache, tokens)
    got = measure(step, args, known=_tensors(args), weight=weight,
                  with_cost=with_cost)
    flops_dev = got["flops"] / msize
    bytes_dev = got["bytes"] / msize
    colls = (collectives(params, mesh, L.to_dtype(cfg.dtype).itemsize)
             if kind == "train" else {})
    coll_dev = float(sum(colls.values()))
    compute_s = flops_dev / PEAK_FLOPS_BF16
    memory_s = bytes_dev / HBM_BW
    coll_s = coll_dev / LINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    model_flops = useful_flops(cfg, plan)
    flops_global = flops_dev * mesh.devices
    temp = max(got["peak"] - got["output"], 0.0)
    return {
        "status": "ok",
        "variant": plan.get("variant", ""),
        "cost_mode": "full-depth" if with_cost else "skipped",
        "batch_per_dev": b_dev,
        "memory": {"argument_B": int(arg_b), "output_B": int(got["output"]),
                   "temp_B": int(temp), "alias_B": 0,
                   "peak_est_B": int(arg_b + got["output"] + temp)},
        "cost": {"flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
                 "kernel_flops_per_dev": got["kernel_flops"] / msize},
        "kernels": got["kernels"],
        "collectives_B_per_dev": colls,
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant,
            "model_flops": model_flops, "hlo_flops_global": flops_global,
            "useful_ratio": (model_flops / flops_global
                             if flops_global else 0.0),
        },
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 mesh (same as --mesh 2x16x16)")
    ap.add_argument("--mesh", default="", choices=["", *MESHES],
                    help="16x16 (default), 2x16x16 or 1x1 (one card)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length in place of the shape's")
    ap.add_argument("--no-cost", action="store_true",
                    help="memory only: no FLOP or byte counting")
    ap.add_argument("--smoke", action="store_true",
                    help="paper-llama-124m train_4k on meta; fails on any "
                         "error")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    mesh = args.mesh or ("2x16x16" if args.multi_pod else "16x16")

    if args.smoke:
        rec = run_one("paper-llama-124m", "train_4k", mesh=mesh)
        if rec["status"] != "ok":
            log(str(rec.get("traceback", rec)))
            raise SystemExit(1)
        log("=== dry-run smoke OK ===")
        return

    archs = arch_ids() if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    results = []
    for arch in archs:
        for shape in shapes:
            results.append(run_one(arch, shape, mesh=mesh,
                                   with_cost=not args.no_cost,
                                   batch=args.batch, seq=args.seq))
            if args.out:   # incremental write
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    log(f"\n=== dry-run complete: {ok} ok / {sk} skipped / {err} errors "
        f"over {len(results)} pairs ===")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
