"""The plain training reference: what a family's model, Adam and the
CheckFree recoveries do to the benchmark's weights over the checked steps,
in plain PyTorch, a layer at a time.

It imports nothing of the program.  A family module (``perfbench/reference
/<family>.py``) gives the model: its leaves and their draws, the embedding,
one layer's residual branch and the tail (final norm, head, logits).  This
module gives what every family shares:

* the weights from a seed, one generator a leaf on the device
  (:func:`make_params`, :func:`make_leaf`), in the program's nested-dict
  layout, so that both sides take the very same tensors;
* the loss and its gradients by a manual walk: the forward keeps only each
  layer's input, the backward recomputes one layer at a time under autograd
  (:func:`loss_and_grads`), so a full-size model fits beside its Adam
  state; CheckFree+'s second half walks the swapped stage order
  (:func:`swap_order`);
* Adam with global-norm clipping, warm-up and cosine decay, and CheckFree's
  learning-rate boost (:func:`adam_step`);
* the recoveries: the neighbours' merge weighted by their squared gradient
  norms (Alg. 1), and CheckFree+'s copy of the twin into an edge stage, with
  the lost stage's moments zeroed (:func:`recover`);
* :func:`follow`, which runs those over a sequence of steps and failures and
  returns what the check compares.

``Ops`` holds the precision: :data:`FP32` computes every product in float32
(TF32 off), :func:`fp8_ops` rounds every product's operands to float8 with
one scale a tensor (e4m3 forward, e5m2 for gradients), the control.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

Tree = Dict[str, Any]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def leaves_with_path(tree: Tree, prefix: Tuple[str, ...] = ()
                     ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) in sorted key order at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_path(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def get_path(tree: Tree, path: Sequence[str]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree: Tree, path: Sequence[str], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def name(path: Sequence[str]) -> str:
    return ".".join(path)


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------

def leaf_seed(seed: int, path: Sequence[str]) -> int:
    """The generator seed of one leaf: the run's seed and the leaf's name."""
    h = hashlib.sha256(f"{int(seed)}/{name(path)}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def make_leaf(fam, conf: dict, path: Sequence[str], seed: int,
              device) -> torch.Tensor:
    """One leaf of the weights of ``seed``, fp32 on ``device``: drawn by a
    generator of its own, so any leaf can be drawn again alone."""
    for p, shape, draw in fam.leaf_specs(conf):
        if tuple(p) == tuple(path):
            gen = torch.Generator(device=device)
            gen.manual_seed(leaf_seed(seed, path))
            return draw(gen, shape, torch.device(device))
    raise KeyError(name(path))


def make_params(fam, conf: dict, seed: int, device) -> Tree:
    """Every leaf of the weights of ``seed``, fp32 on ``device``, in the
    program's nested layout."""
    tree: Tree = {}
    for path, _, _ in fam.leaf_specs(conf):
        set_path(tree, path, make_leaf(fam, conf, path, seed, device))
    return tree


def normal(std: float):
    def draw(gen, shape, device):
        return torch.randn(shape, generator=gen, device=device).mul_(std)
    return draw


def constant(value: float):
    def draw(gen, shape, device):
        return torch.full(shape, float(value), device=device)
    return draw


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ops:
    """The products of a reference pass: ``mm(a, b)`` is ``a @ b``."""
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 anywhere in the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


FP32 = Ops(torch.matmul)

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with one scale for the tensor
    (its largest magnitude onto the format's largest), back in fp32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Q8(torch.autograd.Function):
    """Forward operands in e4m3, their gradients in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_ops() -> Ops:
    def mm(a, b):
        return torch.matmul(_Q8.apply(a), _Q8.apply(b))
    return Ops(mm)


# ---------------------------------------------------------------------------
# shared layers
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over tokens of logsumexp - the label's logit."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def stage_bounds(num_layers: int, num_stages: int) -> List[Tuple[int, int]]:
    """Contiguous stages, the first ``num_layers % num_stages`` one layer
    longer."""
    base, extra = divmod(num_layers, num_stages)
    out, lo = [], 0
    for i in range(num_stages):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def swap_order(num_layers: int, num_stages: int) -> List[int]:
    """CheckFree+'s swapped walk (paper §4.3): the first two stages and the
    last two run in each other's place; fewer than 4 stages swap nothing."""
    stages = list(range(num_stages))
    if num_stages >= 4:
        stages[0], stages[1] = stages[1], stages[0]
        stages[-1], stages[-2] = stages[-2], stages[-1]
    bounds = stage_bounds(num_layers, num_stages)
    return [i for s in stages for i in range(*bounds[s])]


# ---------------------------------------------------------------------------
# loss and gradients, a layer at a time
# ---------------------------------------------------------------------------

def _detached(tree: Tree) -> Tree:
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def loss_and_grads(fam, conf: dict, params: Tree, tokens: torch.Tensor,
                   labels: torch.Tensor, order: Sequence[int], scale: float,
                   grads: Tree, ops: Ops) -> float:
    """The mean cross-entropy of one batch through the layers in ``order``;
    adds ``scale`` times its gradient into ``grads`` (a tree like
    ``params``).  Keeps each layer's input and recomputes one layer at a
    time in the backward."""
    key = fam.TOWER
    tower = params[key]
    with torch.no_grad():
        x = fam.embed(params, tokens, conf)
        inputs = []
        for i in order:
            inputs.append(x)
            x = x + fam.block(tree_map(lambda t: t[i], tower), x, conf, ops)
    # the tail, every leaf outside the tower differentiable
    outside = {k: _detached(v) for k, v in params.items() if k != key}
    x_last = x.detach().requires_grad_()
    loss = fam.loss_tail({**outside, key: tower}, x_last, labels, conf, ops)
    (loss * scale).backward()
    for path, leaf in leaves_with_path(outside):
        if leaf.grad is not None:
            get_path(grads, path).add_(leaf.grad)
    g = x_last.grad
    for i, x_in in zip(reversed(list(order)), reversed(inputs)):
        x_in = x_in.detach().requires_grad_()
        layer = _detached(tree_map(lambda t: t[i], tower))
        out = fam.block(layer, x_in, conf, ops)
        torch.autograd.backward([out], [g])
        g = g + x_in.grad
        for path, leaf in leaves_with_path(layer):
            get_path(grads[key], path)[i].add_(leaf.grad)
        del out, layer
    fam.embed_backward(grads, tokens, g, conf)
    return float(loss.detach())


# ---------------------------------------------------------------------------
# Adam and CheckFree
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Optim:
    lr: float
    warmup_steps: int
    total_steps: int
    grad_clip: float
    min_lr_ratio: float
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8

    @classmethod
    def of(cls, d: dict) -> "Optim":
        return cls(lr=d["lr"], warmup_steps=d["warmup_steps"],
                   total_steps=d["total_steps"], grad_clip=d["grad_clip"],
                   min_lr_ratio=d["min_lr_ratio"])

    def lr_at(self, step: int) -> float:
        """Warm-up, then cosine decay to ``min_lr_ratio``; ``step`` counts
        from 1."""
        warm = min(step / max(self.warmup_steps, 1), 1.0)
        t = min(max((step - self.warmup_steps)
                    / max(self.total_steps - self.warmup_steps, 1), 0.0), 1.0)
        decay = self.min_lr_ratio + (1 - self.min_lr_ratio) * 0.5 * (
            1 + math.cos(math.pi * t))
        return self.lr * warm * decay


def global_norm(grads: Tree) -> float:
    return math.sqrt(sum(float(g.double().square().sum())
                         for _, g in leaves_with_path(grads)))


@torch.no_grad()
def adam_step(opt: Optim, params: Tree, grads: Tree, m: Tree, v: Tree,
              step: int, lr_scale: float) -> Tree:
    """One Adam step in place; returns the clipped gradient's tree (the
    gradient as the optimizer gets it)."""
    norm = global_norm(grads)
    clip = min(opt.grad_clip / (norm + 1e-9), 1.0) if opt.grad_clip > 0 \
        else 1.0
    b1, b2 = opt.betas
    lr = opt.lr_at(step) * lr_scale
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    clipped = {}
    for path, g in leaves_with_path(grads):
        p, mm, vv = (get_path(t, path) for t in (params, m, v))
        gc = g * clip
        mm.mul_(b1).add_(gc, alpha=1 - b1)
        vv.mul_(b2).add_(gc.square(), alpha=1 - b2)
        p.sub_((mm / bc1).mul_(lr).div_((vv / bc2).sqrt_().add_(opt.eps)))
        set_path(clipped, path, gc)
    return clipped


def stage_sqnorms(grads: Tree, key: str, bounds) -> List[float]:
    """omega_i: the squared norm of stage i's slice of every tower
    gradient (Alg. 1's weights)."""
    out = []
    for lo, hi in bounds:
        out.append(sum(float(g[lo:hi].double().square().sum())
                       for _, g in leaves_with_path(grads[key])))
    return out


@torch.no_grad()
def recover(params: Tree, m: Tree, v: Tree, key: str, bounds, stage: int,
            omegas: Sequence[float], edges_losable: bool) -> None:
    """Rebuild stage ``stage`` of the tower in place: the neighbours'
    average weighted by their omegas (interior stages), or a copy of the
    neighbour (an edge stage, CheckFree+); the stage's moments zeroed."""
    k = len(bounds)
    lo, hi = bounds[stage]
    n = hi - lo
    if stage in (0, k - 1):
        if not edges_losable:
            raise ValueError("plain CheckFree cannot rebuild an edge stage")
        twin = 1 if stage == 0 else k - 2
        tlo, thi = bounds[twin]
        rows = (list(range(tlo, tlo + n)) if twin > stage
                else list(range(thi - n, thi)))
        for _, t in leaves_with_path(params[key]):
            t[lo:hi].copy_(t[rows])
    else:
        plo, phi = bounds[stage - 1]
        nlo, nhi = bounds[stage + 1]
        prev_rows = list(range(phi - n, phi))
        next_rows = list(range(nlo, nlo + n))
        wa, wb = float(omegas[stage - 1]), float(omegas[stage + 1])
        denom = wa + wb + 1e-30
        for _, t in leaves_with_path(params[key]):
            t[lo:hi].copy_(t[prev_rows] * (wa / denom)
                           + t[next_rows] * (wb / denom))
    for tree in (m, v):
        for _, t in leaves_with_path(tree[key]):
            t[lo:hi].zero_()


# ---------------------------------------------------------------------------
# the checked steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Followed:
    """What the reference gives for the checked steps."""
    losses: List[float]
    first_grad: Dict[str, float]      # leaf -> norm of the clipped gradient
    first_omegas: List[float]         # per stage, unclipped, squared
    params: Tree                      # after the last step


def follow(fam, conf: dict, params: Tree, batches: Sequence[Dict[str, Any]],
           failures: Dict[int, List[int]], *, strategy: dict, optim: Optim,
           ops: Ops = FP32, device="cuda",
           grad_hook: Optional[Callable[[Tree], None]] = None) -> Followed:
    """Train ``params`` in place over ``batches`` (one a step), with the
    stages of ``failures[w]`` lost at the boundary before wall step ``w``
    (w >= 1, counted from 0), as the program's trainer does.
    ``grad_hook(grads)`` may alter each step's gradients before the norms
    and Adam see them (a planted fault)."""
    key = fam.TOWER
    layers = fam.num_layers(conf)
    stages = int(strategy["stages"])
    bounds = stage_bounds(layers, stages)
    swap = bool(strategy["swap"])
    zeros = lambda t: torch.zeros_like(t)  # noqa: E731
    m, v = tree_map(zeros, params), tree_map(zeros, params)
    lr_scale, omegas = 1.0, None
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    first_omegas: List[float] = []
    for wall, batch in enumerate(batches):
        for stage in failures.get(wall, ()):
            recover(params, m, v, key, bounds, stage, omegas,
                    edges_losable=swap)
            lr_scale = min(lr_scale * strategy["lr_boost"],
                           strategy["lr_boost_cap"])
        tokens = torch.as_tensor(batch["tokens"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        grads = tree_map(zeros, params)
        if swap:
            half = tokens.shape[0] // 2
            l1 = loss_and_grads(fam, conf, params, tokens[:half],
                                labels[:half], range(layers), 0.5, grads, ops)
            l2 = loss_and_grads(fam, conf, params, tokens[half:],
                                labels[half:], swap_order(layers, stages),
                                0.5, grads, ops)
            loss = 0.5 * (l1 + l2)
        else:
            loss = loss_and_grads(fam, conf, params, tokens, labels,
                                  range(layers), 1.0, grads, ops)
        losses.append(loss)
        if grad_hook is not None:
            grad_hook(grads)
        omegas = stage_sqnorms(grads, key, bounds)
        clipped = adam_step(optim, params, grads, m, v, wall + 1, lr_scale)
        if wall == 0:
            first_grad = {name(p): float(g.double().norm())
                          for p, g in leaves_with_path(clipped)}
            first_omegas = list(omegas)
        del grads, clipped
        lr_scale = (lr_scale - 1.0) * strategy["lr_boost_decay"] + 1.0
    return Followed(losses, first_grad, first_omegas, params)
