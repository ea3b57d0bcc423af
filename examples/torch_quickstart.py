"""Quickstart on the PyTorch port: CheckFree in ~40 lines.

The counterpart of ``examples/quickstart.py``.  Builds a small llama-family
model, trains it while a stage failure is injected mid-run, and shows
Alg. 1 recovering it — no checkpoint anywhere.  Runs on the card by default
(the hand-written kernels); ``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.config import (ModelConfig, OptimizerConfig, RecoveryConfig,
                                TrainConfig)
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import make_batches
from repro_torch.models.model import Model

# 1) a model, split into 4 pipeline stages (2 layers each)
CFG = ModelConfig(
    name="quickstart-llama", arch_type="dense", num_layers=8, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=160, vocab_size=256, max_seq_len=64,
    dtype="float32", param_dtype="float32")


# 2) train with the CheckFree recovery strategy; stage 2 dies at step 12
class OneFailure:
    def at(self, step):
        return [2] if step == 12 else []


def main(argv: Optional[Sequence[str]] = None, params=None) -> dict:
    """Run the quickstart; ``params`` (a tree of tensors, e.g. JAX's
    ``model.init(PRNGKey(0))`` through ``repro_torch.convert``) replaces
    the seeded draw.  Returns what it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_quickstart: no CUDA device; pass "
                           "--device cpu to run on the CPU")

    tcfg = TrainConfig(
        global_batch=8, microbatch=8, seq_len=64, steps=30,
        optimizer=OptimizerConfig(lr=2e-3, total_steps=30, warmup_steps=5),
        recovery=RecoveryConfig(strategy="checkfree", num_stages=4))
    trainer = Trainer(Model(CFG, device=args.device, weights=False), tcfg,
                      schedule=OneFailure())
    state, hist = trainer.run(make_batches(CFG, batch=8, seq=64, seed=0),
                              params=None if params is None
                              else TR.clone(params))

    # 3) the loss dips at the failure and recovers — no rollback, no replay
    print("step loss  (failure at step 12, CheckFree merge of stages 1&3)")
    for s, l in zip(hist.steps, hist.loss):
        marker = "  <- stage 2 failed, recovered via Alg. 1" if s == 13 else ""
        print(f"{s:4d} {l:.4f}{marker}")
    (step, err), = hist.recovery_errors
    print(f"\nrecovery error term ||w1 f3 + w2 f1 - f2||^2 = {err:.3e}")
    assert np.isfinite(hist.loss).all()
    print("ok")
    return {"steps": list(hist.steps), "loss": list(hist.loss),
            "failures": list(hist.failures),
            "recovery_errors": list(hist.recovery_errors),
            "dispatches": hist.dispatches, "wall_iters": hist.wall_iters}


if __name__ == "__main__":
    main()
