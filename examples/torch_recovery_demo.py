"""Algorithm 1, dissected, on the PyTorch port: kill a stage of a trained
model and compare every reinitialization strategy's error term and loss
damage (paper Fig. 2 / §4.4).

The counterpart of ``examples/recovery_demo.py``.  Runs on the card by
default (the merge kernel, the flash-attention and Adam kernels);
``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples/torch_recovery_demo.py
"""
import argparse
from typing import Optional, Sequence

import torch

from repro_torch import tree as TR
from repro_torch.config import ModelConfig, OptimizerConfig
from repro_torch.core.recovery import recover_stage, recovery_error
from repro_torch.core.stages import StagePartition
from repro_torch.data.pipeline import make_batches
from repro_torch.models.model import Model
from repro_torch.optim.adam import adam_update, init_adam

CFG = ModelConfig(
    name="demo-llama", arch_type="dense", num_layers=8, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=160, vocab_size=256, max_seq_len=64,
    dtype="float32", param_dtype="float32")
FAILED = 2
STRATEGIES = ["grad_norm", "uniform", "copy_prev", "random"]


def main(argv: Optional[Sequence[str]] = None, params=None) -> dict:
    """Run the demo; ``params`` (a tree of tensors, e.g. JAX's
    ``model.init(PRNGKey(0))`` through ``repro_torch.convert``) replaces
    the seeded draw.  Returns what it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_recovery_demo: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    device = torch.device(args.device)
    model = Model(CFG, device=device, weights=False)
    part = StagePartition(CFG, 4)
    batches = make_batches(CFG, batch=8, seq=64, seed=0)

    def next_batch():
        return {k: torch.as_tensor(v, device=device)
                for k, v in next(batches).items()}

    def trainable(tree):
        return TR.map(lambda t: t.detach().to(device, torch.float32)
                      .clone().requires_grad_(), tree)

    # --- train briefly so the stages hold real signal ---------------------
    params = trainable(model.init(torch.Generator(device).manual_seed(0))
                       if params is None else params)
    ocfg = OptimizerConfig(lr=2e-3, total_steps=40, warmup_steps=5)
    opt = init_adam(params)
    _, treedef = TR.flatten(params)

    def step(p, o, b):
        loss, _ = model.loss(p, b)
        g = TR.unflatten(treedef, list(torch.autograd.grad(loss,
                                                           TR.leaves(p))))
        p, o, _ = adam_update(ocfg, p, g, o)
        return p, o, loss.detach(), g

    for _ in range(40):
        params, opt, loss, grads = step(params, opt, next_batch())
    trained = float(loss)
    print(f"trained 40 steps, loss {trained:.4f}")

    # --- Alg. 1 ingredients ------------------------------------------------
    omegas = part.stage_grad_sqnorms(grads)   # ||grad W_s||^2 per stage
    host_omegas = [float(w) for w in omegas]
    print("per-stage grad sqnorms (Alg. 1's omegas):",
          [f"{w:.3e}" for w in host_omegas])

    probe = next_batch()

    @torch.no_grad()
    def loss_fn(p):
        return float(model.loss(p, probe)[0])

    base = loss_fn(params)

    print(f"\nstage {FAILED} dies. base loss {base:.4f}. reinit options "
          "(each followed by 20 recovery steps):")
    print(f"{'strategy':12s} {'error term (§4.4)':>18s} {'loss@reinit':>12s} "
          f"{'loss@+20':>9s}")
    rows = []
    for strat in STRATEGIES:
        # the recovery writes in place: into a copy of the trained model
        p2 = trainable(params)
        recover_stage(p2, part, FAILED, omegas, strategy=strat,
                      generator=torch.Generator(device).manual_seed(1))
        with torch.no_grad():
            err = float(recovery_error(params, p2, part, FAILED))
        post = loss_fn(p2)
        o2 = init_adam(p2)
        for _ in range(20):
            p2, o2, l2, _ = step(p2, o2, next_batch())
        tag = "  <- Alg. 1 (CheckFree)" if strat == "grad_norm" else ""
        print(f"{strat:12s} {err:18.4e} {post:12.4f} {float(l2):9.4f}{tag}")
        rows.append({"strategy": strat, "error": err, "loss_at_reinit": post,
                     "loss_after_20": float(l2)})

    print("\nthe §4.4 bound says convergence past a failure is governed by "
          "the reinit\nerror term; the weighted average trades a small "
          "parameter-space error for\nthe best post-recovery loss (paper "
          "Fig. 2).")
    return {"trained_loss": trained, "omegas": host_omegas,
            "base_loss": base, "rows": rows}


if __name__ == "__main__":
    main()
