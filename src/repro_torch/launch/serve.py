"""Batched serving: prefill a prompt batch, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-llama-1.5b \
        --full --batch 8 --prompt-len 512 --new-tokens 32

The PyTorch counterpart of ``repro.launch.serve``, for every family (the
encoder-decoder's frames and the VLM's patches come from the same seeded
draw as JAX's).  It runs on the card (``--device cuda``, the default),
where prefill goes through the flash-attention kernel and, for the ssm and
hybrid families, the SSD scan kernel; ``--device cpu`` runs the plain
versions.
Parameters are drawn from a ``torch.Generator`` seeded with ``--seed`` on the
device, and prompts come from the same synthetic source as
``repro.launch.serve``'s.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs import ARCHS, PAPER_MODELS, get_config, reduced
from repro_torch.data.pipeline import SyntheticLM, batch_for
from repro_torch.models.model import Model, build_model
from repro_torch.telemetry import log


@dataclass
class Generation:
    tokens: np.ndarray        # (B, new_tokens) int32, on the host
    prefill_s: float          # prompt forward + first token
    decode_s: float           # the remaining new_tokens - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, batch: Union[torch.Tensor, Dict[str, torch.Tensor]],
             *, new_tokens: int, window: int = 0) -> Generation:
    """Greedy generation of ``new_tokens`` tokens after the prompt: a batch
    dict with the (B, S) ``tokens`` and the family's other inputs (``frames``,
    ``patches``), or the (B, S) tokens alone.

    ``window`` > 0 serves from a ring KV cache of that capacity; otherwise
    the cache holds the prompt, the VLM's P patch positions before it, and
    the new tokens.  The argmax stays on the device: the generated tokens
    cross to the host in one copy at the end.  The two synchronisations only
    time the phases.
    """
    if new_tokens < 1:
        raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
    if torch.is_tensor(batch):
        batch = {"tokens": batch}
    s = batch["tokens"].shape[1]
    prefix = batch["patches"].shape[1] if "patches" in batch else 0
    capacity = window or (prefix + s + new_tokens)
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, capacity)
    next_tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
    _sync(model.device)
    t_prefill = time.perf_counter() - t0

    out = [next_tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, cache = model.decode_step(cache, next_tok, window=window)
        next_tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
        out.append(next_tok)
    _sync(model.device)
    t_decode = time.perf_counter() - t0
    # the one device-to-host copy of the whole generation
    gen = torch.stack(out, dim=1).cpu().numpy()
    return Generation(gen, t_prefill, t_decode)


def main(argv: Optional[Sequence[str]] = None) -> Generation:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=sorted(ARCHS) + sorted(PAPER_MODELS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: SWA ring-cache serving (long-context mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the parameters and the prompt draw")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to serve with the plain versions on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device).manual_seed(args.seed))
    log(f"serving {cfg.name} on {device}: {cfg.param_count() / 1e6:.1f}M "
        f"params, batch={args.batch} prompt={args.prompt_len} "
        f"new={args.new_tokens} window={args.window or 'full'}")

    src = SyntheticLM(cfg.vocab_size, seed=7)
    rng = np.random.default_rng(args.seed)
    raw = src.sample(rng, args.batch, args.prompt_len)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_for(cfg, raw, rng).items() if k != "labels"}
    res = generate(model, batch, new_tokens=args.new_tokens,
                   window=args.window)
    steps = args.new_tokens - 1
    log(f"prefill: {res.prefill_s * 1e3:.1f} ms "
        f"({args.batch * args.prompt_len} tokens)")
    log(f"decode:  {res.decode_s * 1e3:.1f} ms ({args.batch * steps} tokens, "
        f"{steps / max(res.decode_s, 1e-9):.1f} tok/s/seq)")
    for i in range(min(args.batch, 2)):
        log(f"  seq{i}: prompt={raw[i, :8].tolist()}... "
            f"gen={res.tokens[i].tolist()}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise RuntimeError("generated token ids outside the vocabulary")
    return res


if __name__ == "__main__":
    main()
