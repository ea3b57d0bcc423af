"""The pipeline-parallel training backend behind ``Trainer(backend="spmd")``:
one ``torch.distributed`` rank per stage, a GPipe schedule between them,
and CheckFree's recovery as neighbour transfers into the failed rank.

The counterpart of ``repro.pipeline.spmd``.  JAX has one controller over a
``("stage",)`` mesh and lets ``ppermute`` carry the activations (and, by
its transpose, their gradients).  Here each stage is a process
(``launch/mesh.py``) that holds its slice of the stacked tower
(``blocks[r*L/K : (r+1)*L/K]``) and full copies of every other leaf (the
embedding, head and final norm: the paper's S0 replication path), with
Adam moments of the same shapes.  Every rank runs the same training loop on
the same batches and the same schedule, so every rank makes the same
decisions; the scalars the loop reads are reduced over the group so that
every rank holds the same values.

The schedule is explicit, as ``torch.distributed.pipelining``'s GPipe is,
never communication inside autograd (the ranks' autograd engines would run
such backwards in orders that do not match, and gloo would deadlock):

* forward: at each tick a rank runs its live microbatch (stage 0 of the
  route embeds; the others take the activation received, detached, with
  ``requires_grad_()``), and one ``dist.batch_isend_irecv`` a tick sends
  and receives the tick's live hops (:func:`route_tick_sends`), its ops in
  one global order on every rank;
* backward: the ticks in reverse; a rank receives its output's gradient,
  calls ``torch.autograd.backward`` on the output (and on its part of the
  loss: the CE on the last stage of the route, the MoE aux on every stage,
  since the global loss is the sum of the per-rank partials) and sends its
  input's gradient back.

CheckFree+'s swapped half does not move weights, as JAX's
``_swapped_blocks`` does (four 4-layer slices a step at paper-llama-1.5b):
its microbatches visit the stages in the swapped order
(``core.swap.stage_permutations``), which computes the same function, and
each slice's gradient lands on its holder.  After the schedule: one
all-reduce of the replicated leaves' gradients, ``ops.adam_sumsq`` over the
rank's leaves (its tower's sum is its stage's omega), one all-reduce of the
omegas' one-hot with the CE and aux partials, the clip norm, Adam on the
rank's leaves, the ``lr_scale`` decay and the step's ring row
(:class:`SpmdStep`).  A window (:class:`SpmdWindow`) runs k such steps and
drains once; it captures no CUDA graph, since gloo's transfers run on the
host (``pipeline/transport.py``).

Recovery: the neighbours send their slices to the failed rank, which merges
them through ``ops.stage_merge``, the call of ``core/recovery.py``, so the
result is bit-equal to the host backend's (:func:`checkfree_recover_spmd`).
Replicated leaves need no transfer: replication is the restore.

The strategies that snapshot or restore state (``checkpoint``,
``tiered_ckpt``, ``neighbor``, ``adaptive``'s children) keep per-rank
shards: each rank saves its slice of the tower with its moments, and rank 0
the replicated leaves once.  Whatever only one rank knows, or must hold on
every rank alike (the step a rollback returns to, a restore's tier, priced
read and recovery error), goes through :class:`GroupReduce`, the group's
all-reduce of host numbers, so every rank makes the same decisions.

Scope: dense and MoE decoder towers with full attention and a number of
layers that the stages divide (:func:`refusal`), as JAX asserts; every
recovery strategy.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import telemetry
from repro_torch import tree as TR
from repro_torch.config import ModelConfig
from repro_torch.core.recovery import _merge_trees
from repro_torch.core.stages import StagePartition
from repro_torch.core.swap import stage_permutations
from repro_torch.core.window import FusedWindow
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adam import adam_step
from repro_torch.pipeline.transport import Transport

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]

#: the reinits with a neighbour-transfer form; MergeRecovery routes exactly
#: these through the in-mesh recovery
IN_MESH_REINITS = ("grad_norm", "uniform", "copy_prev", "twin_copy")

def refusal(cfg: ModelConfig, num_stages: int) -> Optional[str]:
    """Why the spmd backend cannot run this model or stage count (None
    when it can)."""
    if cfg.arch_type not in ("dense", "moe"):
        return (f"spmd backend supports dense/moe towers, not "
                f"{cfg.arch_type} ({cfg.name})")
    if cfg.sliding_window:
        return (f"spmd backend: full attention only, not a sliding window "
                f"of {cfg.sliding_window} ({cfg.name})")
    if cfg.num_layers % num_stages:
        return (f"spmd backend shards the tower evenly: num_layers "
                f"{cfg.num_layers} is not a multiple of num_stages "
                f"{num_stages}")
    return None


# ---------------------------------------------------------------------------
# the schedule's hops
# ---------------------------------------------------------------------------

def route_tick_sends(t: int, route: Sequence[int], num_microbatches: int
                     ) -> List[Tuple[int, int]]:
    """The live rank -> rank hops at GPipe tick ``t`` of a microbatch train
    that visits the stages in ``route`` order: position i holds microbatch
    ``t - i`` at tick t, and its send to position i + 1 is live iff that
    microbatch exists."""
    lo = max(0, t - num_microbatches + 1)
    hi = min(t, len(route) - 2)
    return [(route[i], route[i + 1]) for i in range(lo, hi + 1)]


def swap_route(num_stages: int) -> List[int]:
    """CheckFree+'s swapped stage order, as a route: S1, S0, ..., S_{K-1},
    S_{K-2} (the identity below 4 stages)."""
    return list(stage_permutations(num_stages)[1])


# ---------------------------------------------------------------------------
# the rank's shard
# ---------------------------------------------------------------------------

class ShardPartition(StagePartition):
    """The stage partition as this rank sees its shard, for the recovery
    strategies: the tower leaves in ``params`` are the rank's own slice, so
    stage ``rank`` is the whole local tower and every other stage an empty
    slice of it (zeroing a stage's moments then touches only its rank)."""

    def __init__(self, cfg: ModelConfig, num_stages: int, rank: int):
        super().__init__(cfg, num_stages)
        self.rank = rank

    def get_stage(self, params: Params, i: int) -> Params:
        own = i == self.rank
        return TR.map(lambda a: a if own else a[:0], params[self.tower_key])

    @torch.no_grad()
    def set_stage(self, params: Params, i: int, stage: Params) -> Params:
        if i == self.rank:
            TR.map(lambda a, s: a.copy_(s), params[self.tower_key], stage)
        return params


def init_shard(cfg: ModelConfig, gen: torch.Generator, device,
               part: StagePartition, rank: int) -> Params:
    """This rank's slice of ``transformer.init``'s fp32 tree: the same draws
    from ``gen`` in the same order, each stacked weight cut to the rank's
    layers as soon as it is drawn, so no rank holds the whole tower."""
    lo, hi = part.stage_bounds(rank)
    dtype = L.to_dtype(cfg.param_dtype)
    params: Params = {"embed": {"table": L.embed_init(
        gen, (cfg.vocab_size, cfg.d_model), dtype, device)}}
    with L.keep_drawn(lambda t: t[lo:hi].clone()):
        blocks = T.init_block(gen, cfg, dtype, device, cfg.num_layers)
    # the norms are not drawn: cut them here
    params["blocks"] = TR.map(
        lambda t: t[lo:hi].clone() if t.shape[0] == cfg.num_layers else t,
        blocks)
    params["final_norm"] = L.init_norm_cfg((cfg.d_model,), dtype, device, cfg)
    if not cfg.tie_embeddings:
        params["head"] = {"w": L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                            dtype, device)}
    if not cfg.use_rope:
        params["pos_embed"] = {"table": L.embed_init(
            gen, (cfg.max_seq_len, cfg.d_model), dtype, device)}
    return params


def shard_params(params: Params, part: StagePartition, rank: int) -> Params:
    """The rank's shard of a whole tree: its slice of the tower (a copy),
    the other leaves as they are."""
    lo, hi = part.stage_bounds(rank)
    out = dict(params)
    out[part.tower_key] = TR.map(lambda t: t[lo:hi].clone(),
                                 params[part.tower_key])
    return out


# ---------------------------------------------------------------------------
# the GPipe schedule
# ---------------------------------------------------------------------------

class Pipeline:
    """The forward and backward schedule of one rank over ``num_micro``
    microbatches a route."""

    def __init__(self, cfg: ModelConfig, part: StagePartition,
                 transport: Transport, num_micro: int, use_swap: bool):
        self.cfg = cfg
        self.part = part
        self.transport = transport
        self.rank = transport.rank
        self.num_micro = num_micro
        self.routes = ([list(range(part.num_stages)),
                        swap_route(part.num_stages)] if use_swap
                       else [list(range(part.num_stages))])
        self.dtype = L.to_dtype(cfg.dtype)
        self.coef = cfg.moe.router_aux_coef

    def _blocks(self, layers: List[Params], x: torch.Tensor,
                positions: torch.Tensor):
        """This rank's slice of the tower over one microbatch -> (hidden,
        the layers' summed aux, 0 for a dense tower)."""
        aux = 0.0
        for bp in layers:
            x, _, a = T._block(bp, x, positions, self.cfg, 0)
            aux = aux + a
        return x, aux

    def _split(self, batch: Batch):
        """(tokens, labels, masks) as (M, mb, S), and the CE weights: 1/M,
        or each microbatch's share of the valid tokens under a loss mask."""
        m = self.num_micro
        tokens, labels = batch["tokens"], batch["labels"]
        b, s = tokens.shape
        if b % m:
            raise ValueError(f"spmd backend: a batch of {b} rows does not "
                             f"split into {m} microbatches")
        toks = tokens.reshape(m, b // m, s)
        labs = labels.reshape(m, b // m, s)
        mask = batch.get("loss_mask")
        if mask is None:
            masks = [None] * m
            ce_w = torch.full((m,), 1.0 / m, dtype=torch.float32,
                              device=tokens.device)
        else:
            masks = mask.reshape(m, b // m, s)
            counts = masks.reshape(m, -1).float().sum(1)
            ce_w = counts / torch.clamp(counts.sum(), min=1e-9)
        return toks, labs, masks, ce_w

    def run(self, params: Params, batch: Batch, *, grad: bool,
            ce_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every route's forward (and with ``grad`` its backward, the
        gradients accumulating into ``params``' ``.grad``) over its share
        of ``batch`` -> this rank's partial (ce, aux) as 0-d fp32 tensors:
        their sums over the group are the batch's CE and aux."""
        routes = self.routes
        n = len(routes)
        rows = batch["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"swap schedule: a batch of {rows} rows does "
                             "not halve")
        half = rows // n
        device = batch["tokens"].device
        ce = torch.zeros((), dtype=torch.float32, device=device)
        aux = torch.zeros((), dtype=torch.float32, device=device)
        for j, route in enumerate(routes):
            part = {k: v[j * half:(j + 1) * half] for k, v in batch.items()}
            with torch.set_grad_enabled(grad):
                c, a, lanes = self._forward(params, part, route, 1.0 / n,
                                            grad=grad, ce_only=ce_only)
            ce += c
            aux += a
            if grad:
                self._backward(lanes, route, (half // self.num_micro,
                                              batch["tokens"].shape[1],
                                              self.cfg.d_model))
        return ce, aux

    def _forward(self, params: Params, batch: Batch, route: List[int],
                 scale: float, *, grad: bool, ce_only: bool):
        cfg, rank, big_m = self.cfg, self.rank, self.num_micro
        k = len(route)
        pos = route.index(rank)
        cparams = L.cast_tree(params, self.dtype)
        layers = T.unstack(cparams["blocks"], self.part.layer_counts[rank])
        toks, labs, masks, ce_w = self._split(batch)
        mb, s = toks.shape[1:]
        positions = T.token_positions(toks[0])
        ce = torch.zeros((), dtype=torch.float32, device=toks.device)
        aux = torch.zeros((), dtype=torch.float32, device=toks.device)
        inbox: Dict[int, torch.Tensor] = {}
        lanes: Dict[int, tuple] = {}
        for t in range(big_m + k - 1):
            m = t - pos
            h = None
            if 0 <= m < big_m:
                if pos == 0:
                    x = T.embed_tokens(cparams, cfg, toks[m], positions)
                else:
                    x = inbox.pop(m)
                    if grad:
                        x.requires_grad_()
                h, a = self._blocks(layers, x, positions)
                obj = None
                if pos == k - 1:
                    logits = T.logits_from_hidden(cparams, cfg, h)
                    c = L.cross_entropy(logits, labs[m], masks[m])
                    obj = c * (ce_w[m] * scale)
                    ce += obj.detach()
                if torch.is_tensor(a) and not ce_only:
                    term = a * (scale / big_m)
                    aux += term.detach()
                    term = term * self.coef
                    obj = term if obj is None else obj + term
                if grad:
                    lanes[m] = (x, h, obj)
            ops_ = []
            for src, dst in route_tick_sends(t, route, big_m):
                if src == rank:
                    ops_.append(("send", dst, h.detach()))
                if dst == rank:
                    ops_.append(("recv", src, (mb, s, cfg.d_model),
                                 self.dtype))
            got = self.transport.exchange(ops_, "activation")
            if any(op[0] == "recv" for op in ops_):
                inbox[t + 1 - pos] = got[0]
        return ce, aux, lanes

    def _backward(self, lanes: Dict[int, tuple], route: List[int],
                  shape: Tuple[int, int, int]) -> None:
        rank, big_m = self.rank, self.num_micro
        k = len(route)
        pos = route.index(rank)
        inbox: Dict[int, torch.Tensor] = {}
        for t in reversed(range(big_m + k - 1)):
            m = t - pos
            gx = None
            if 0 <= m < big_m:
                x, h, obj = lanes.pop(m)
                roots, grads = [], []
                if pos < k - 1:
                    roots.append(h)
                    grads.append(inbox.pop(m))
                if obj is not None:
                    roots.append(obj)
                    grads.append(None)
                torch.autograd.backward(roots, grads)
                if pos > 0:
                    gx = x.grad
            if t == 0:
                break
            # the hops of forward tick t - 1, reversed
            ops_ = []
            for src, dst in route_tick_sends(t - 1, route, big_m):
                if dst == rank:
                    ops_.append(("send", src, gx))
                if src == rank:
                    ops_.append(("recv", dst, shape, self.dtype))
            got = self.transport.exchange(ops_, "gradient")
            if any(op[0] == "recv" for op in ops_):
                inbox[t - 1 - pos] = got[0]


def pipeline_loss(cfg: ModelConfig, part: StagePartition,
                  transport: Transport, num_microbatches: int, *,
                  ce_only: bool = False) -> Callable[[Params, Batch],
                                                     torch.Tensor]:
    """``loss_fn(shard, batch)`` -> the batch's loss (CE + router_aux_coef *
    aux; the CE alone with ``ce_only``) through the pipeline, no gradients,
    the same 0-d tensor on every rank.  It equals ``Model.loss`` for dense
    towers at any M and for MoE at M = 1; for MoE at M > 1 the aux term is
    the mean of the microbatches' aux, as routing and capacity are per
    microbatch under GPipe (``repro/pipeline/spmd.py:148-160``)."""
    pipe = Pipeline(cfg, part, transport, num_microbatches, use_swap=False)

    @torch.no_grad()
    def loss_fn(params: Params, batch: Batch) -> torch.Tensor:
        ce, aux = pipe.run(params, batch, grad=False, ce_only=ce_only)
        total = (ce + pipe.coef * aux).reshape(1)
        transport.all_reduce_([total], "scalars")
        return total[0]

    return loss_fn


# ---------------------------------------------------------------------------
# the training step and its window
# ---------------------------------------------------------------------------

class SpmdStep:
    """One rank's training step (``make_spmd_fused_train_step``'s body):
    :meth:`body` has ``Trainer._body``'s contract and returns the step's
    record (``core.window.RECORD``, then the K omegas), the same on every
    rank."""

    def __init__(self, cfg: ModelConfig, part: StagePartition,
                 transport: Transport, opt_cfg, num_micro: int, *,
                 use_swap: bool, lr_decay: float):
        self.part = part
        self.transport = transport
        self.opt_cfg = opt_cfg
        self.lr_decay = lr_decay
        self.pipe = Pipeline(cfg, part, transport, num_micro, use_swap)

    def body(self, params: Params, m: List[torch.Tensor],
             v: List[torch.Tensor], batch: Batch, step: torch.Tensor,
             lr_scale: torch.Tensor) -> torch.Tensor:
        leaves = TR.leaves(params)
        for p in leaves:
            # every leaf reduces a gradient, the stages that do not touch a
            # replicated leaf a zero one
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        ce, aux = self.pipe.run(params, batch, grad=True)
        grads = [p.grad for p in leaves]
        flags = self.part.tower_flags(params)
        k, rank = self.part.num_stages, self.transport.rank
        with torch.no_grad():
            self.transport.all_reduce_(
                [g for g, tower in zip(grads, flags) if not tower],
                "allreduce")
            per_layer, total = ops.adam_sumsq(
                grads, flags, self.part.layer_counts[rank])
            omega = per_layer.sum()
            # one reduction: the omegas' one-hot, the CE and aux partials,
            # and rank 0's sum over the replicated leaves (the same on
            # every rank after the all-reduce: one value for all)
            onehot = torch.zeros((k,), dtype=torch.float32, device=ce.device)
            onehot[rank] = omega
            repl = (total - omega) if rank == 0 else torch.zeros_like(total)
            vec = torch.cat([onehot, torch.stack([ce, aux, repl])])
            self.transport.all_reduce_([vec], "scalars")
            omegas, ce, aux = vec[:k], vec[k], vec[k + 1]
            grad_norm = (omegas.sum() + vec[k + 2]).sqrt()
            scalars = adam_step(self.opt_cfg, leaves, grads, m, v, step,
                                lr_scale, grad_norm)
            lr_scale.sub_(1).mul_(self.lr_decay).add_(1)
            loss = ce + self.pipe.coef * aux
            return torch.cat([
                torch.stack([loss, ce, aux, grad_norm, scalars[1], lr_scale,
                             step.float()]),
                omegas])


class SpmdWindow(FusedWindow):
    """Windows of :class:`SpmdStep` steps: the body run k times, eagerly on
    the card too (no CUDA graph: gloo's transfers run on the host), the
    ring drained once; each dispatch in an ``spmd_window_dispatch`` span
    (``repro/pipeline/spmd.py:402-406``)."""

    def __init__(self, body, device: torch.device, part: StagePartition):
        super().__init__(body, device, part, graphs=False)

    def dispatch(self, state, stacked, *, part):
        with telemetry.span("spmd_window_dispatch", cat="pipeline",
                            stages=self.part.num_stages):
            return super().dispatch(state, stacked, part=part)


# ---------------------------------------------------------------------------
# recovery as neighbour transfers
# ---------------------------------------------------------------------------

def recovery_sources(failed: int, num_stages: int, strategy: str
                     ) -> List[int]:
    """The stages whose slices the failed stage's rank receives, as
    ``checkfree_recover_spmd`` of the JAX package (and ``recover_stage``)
    picks them."""
    k = num_stages
    first, last = failed == 0, failed == k - 1
    if strategy == "copy_prev":
        return [failed - 1 if failed > 0 else failed + 1]
    if strategy == "twin_copy" or first or last:
        return [1 if first else (k - 2 if last else failed - 1)]
    return [failed - 1, failed + 1]


def checkfree_recover_spmd(transport: Transport, num_stages: int):
    """``recover(blocks, omegas, failed, strategy) -> blocks``: the failed
    rank's tower slice rebuilt in place from its neighbours' slices, sent
    to it point to point (every rank calls it).  A middle stage merges both
    neighbours through ``ops.stage_merge`` with Alg. 1's weights (or equal
    ones for ``uniform``); an edge stage, or ``twin_copy``, copies the
    twin's slice; ``copy_prev`` the previous stage's (the next one's for
    S0): bit-equal to ``core.recovery.recover_stage``."""
    rank = transport.rank

    @torch.no_grad()
    def recover(blocks: Params, omegas: torch.Tensor, failed: int,
                strategy: str = "grad_norm") -> Params:
        assert 0 <= failed < num_stages, (failed, num_stages)
        if strategy not in IN_MESH_REINITS:
            raise ValueError(f"no in-mesh recovery for reinit {strategy!r}; "
                             f"supported: {IN_MESH_REINITS}")
        srcs = recovery_sources(failed, num_stages, strategy)
        leaves = TR.leaves(blocks)
        ops_ = []
        for src in srcs:
            for leaf in leaves:
                if rank == src:
                    ops_.append(("send", failed, leaf))
                if rank == failed:
                    ops_.append(("recv", src, leaf.shape, leaf.dtype))
        got = transport.exchange(ops_, "recovery", keep=False)
        if rank != failed:
            return blocks
        n = len(leaves)
        _, treedef = TR.flatten(blocks)
        hops = [TR.unflatten(treedef, got[i * n:(i + 1) * n])
                for i in range(len(srcs))]
        if len(srcs) == 1:
            for a, b in zip(leaves, TR.leaves(hops[0])):
                a.copy_(b)
            return blocks
        if strategy == "uniform":
            wa = torch.ones((), device=omegas.device)
            wb = torch.ones((), device=omegas.device)
        else:  # grad_norm (Alg. 1)
            wa = omegas[failed - 1].float()
            wb = omegas[failed + 1].float()
        _merge_trees(hops[0], hops[1], wa, wb, out=blocks)
        return blocks

    return recover


class InMeshRecover:
    """The ``recover_in_mesh`` binding of the recovery strategies
    (``make_in_mesh_recover``): calling it rebuilds a stage by neighbour
    transfers (replicated leaves are untouched: replication is the
    restore); :meth:`gathered` runs the host math on the whole tower for
    the reinits without a transfer form; :meth:`total` sums a value over
    the group."""

    def __init__(self, transport: Transport, part: StagePartition):
        self.transport = transport
        self.part = part
        self._recover = checkfree_recover_spmd(transport, part.num_stages)

    def __call__(self, params: Params, omegas: torch.Tensor, failed: int,
                 strategy: str = "grad_norm") -> Params:
        self._recover(params[self.part.tower_key], omegas, failed, strategy)
        return params

    @torch.no_grad()
    def gathered(self, params: Params,
                 fn: Callable[[Params, StagePartition], Any]) -> Params:
        """``fn(tree, part)`` (``recover_stage``, ``recover_consecutive``)
        on the tower gathered from every rank, under the whole partition;
        this rank keeps its own slice of the result."""
        key = self.part.tower_key
        tower = params[key]
        whole = TR.map(lambda a: torch.cat(self.transport.all_gather(
            a, "recovery")), tower)
        fn({key: whole}, self.part)
        lo, hi = self.part.stage_bounds(self.transport.rank)
        TR.map(lambda a, w: a.copy_(w[lo:hi]), tower, whole)
        return params

    def total(self, x: torch.Tensor) -> torch.Tensor:
        vec = x.detach().float().reshape(1).clone()
        self.transport.all_reduce_([vec], "scalars")
        return vec[0]


def make_in_mesh_recover(transport: Transport,
                         part: StagePartition) -> InMeshRecover:
    return InMeshRecover(transport, part)


# ---------------------------------------------------------------------------
# decisions of the group
# ---------------------------------------------------------------------------

class GroupReduce:
    """The stage group's all-reduce of host numbers, which the trainer binds
    to every strategy on this backend (``RecoveryStrategy.
    bind_group_reduce``), so that the ranks decide as one: :meth:`min`
    agrees on a step every rank can restore, :meth:`share` hands every rank
    what one rank alone knows (a restore's step, tier, priced read, bytes
    and recovery error).  The numbers go through gloo as float64 host
    tensors (``Transport.reduce_numbers``), on the card too, so a shared
    value arrives bit for bit."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.rank, self.size = transport.rank, transport.size

    def __call__(self, values: Sequence[float], op: str = "sum"
                 ) -> List[float]:
        return self.transport.reduce_numbers(values, op, "decisions")

    def min(self, value: float) -> float:
        return self([value], "min")[0]

    def share(self, values: Optional[Sequence[float]], owner: int,
              n: int) -> List[float]:
        """Rank ``owner``'s ``n`` values (None on the other ranks) on every
        rank."""
        if (values is None) == (self.rank == owner):
            raise ValueError(f"rank {self.rank}: only rank {owner} gives "
                             "the values of a share")
        return self([0.0] * n if values is None else values)
