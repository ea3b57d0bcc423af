"""Batched serving on the PyTorch port: prefill + greedy decode across
architectures.

The counterpart of ``examples/serve_batched.py``.  Runs the reduced variant
of three families (dense / MoE / SSM) through the port's serving path
(``launch.serve.generate``: the argmax stays on the device, and the
generated tokens cross to the host in one copy at the end), and prints
throughput.  On the card by default (the flash-attention and SSD scan
kernels); ``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples/torch_serve_batched.py
"""
import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.launch.serve import generate
from repro_torch.models.model import Model

ARCHS = ["qwen3-4b", "granite-moe-3b-a800m", "mamba2-1.3b"]
BATCH, PROMPT, NEW = 4, 24, 12


def main(argv: Optional[Sequence[str]] = None,
         params: Optional[Dict[str, dict]] = None) -> dict:
    """Serve each arch; ``params`` maps an arch to its parameter tree (e.g.
    JAX's ``model.init(PRNGKey(0))`` through ``repro_torch.convert``), in
    place of the seeded draw.  Returns what it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_serve_batched: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    device = torch.device(args.device)
    rows = []
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        tree = (params or {}).get(arch)
        model = Model(cfg, tree, device=device,
                      generator=(torch.Generator(device).manual_seed(0)
                                 if tree is None else None))
        src = SyntheticLM(cfg.vocab_size, seed=7)
        rng = np.random.default_rng(0)
        batch = {k: torch.as_tensor(v, device=device) for k, v in
                 batch_for(cfg, src.sample(rng, BATCH, PROMPT), rng).items()}
        gen = generate(model, batch, new_tokens=NEW)
        toks = gen.tokens
        assert np.isfinite(toks).all() and toks.shape == (BATCH, NEW)
        rate = BATCH * (NEW - 1) / gen.decode_s
        print(f"{arch:22s} [{cfg.arch_type:6s}] decode "
              f"{rate:6.1f} tok/s (batch {BATCH})  "
              f"sample: {toks[0, :8].tolist()}")
        rows.append({"arch": arch, "arch_type": cfg.arch_type,
                     "tokens": toks, "decode_tok_s": rate,
                     "prefill_s": gen.prefill_s, "decode_s": gen.decode_s})
    print("ok")
    return {"rows": rows}


if __name__ == "__main__":
    main()
