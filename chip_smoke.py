#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (built for sm_90a: H100).

    python3 chip_smoke.py

Drives only the port (``src/repro_torch``), on the card.  Each phase prints
one JSON line; any failure raises, so the script exits non-zero and prints no
result.  Phases:

1. env     — card, power limit, torch/CUDA versions; TF32 off for fp32.
2. build   — compiles every CUDA source under src/repro_torch/csrc.
3. kernel  — the flash-attention forward kernel (bf16 on the tensor cores,
             fp32 on the CUDA cores) against its plain version over dtypes,
             MHA/GQA/MQA groups, every head dim it is built for (16, 32,
             64, 80, 120, 128, 256), masks (causal, a window of 100, full,
             the 4096 window at S 512), lengths shorter than one tile,
             ragged and long,
             and the four serving shapes (paper-llama-1.5b 16 x 128,
             zamba2-2.7b's shared attention 32 x 80, h2o-danube-3-4b 32/8 x
             120 with its 4096 window, gemma-2b 8/1 x 256, granite-moe-3b-
             a800m 24/8 x 64, also swept at S 512 and 333), and over
             another key length than the query length (cross-attention,
             full: 1, 65, 416 and 448 rows over 1500 keys, 100 over 37, 7
             over 1; MHA and GQA, every head dim); then kernel,
             plain version and SDPA (as a yardstick only) timed at the
             serving shapes with CUDA events around back-to-back calls,
             beside the bound (and at whisper-large-v3's encoder, B 8 x
             1500 frames, 20 x 64, full, and its cross-attention, 416 rows
             over the 1500 frames, and at the examples' small model, B 8 x
             64, 4 x 16).  The same for the two backward kernels
             (bf16 on the tensor cores, fp32 on the CUDA cores; against
             ``flash_attention_bwd_ref`` and PyTorch's autograd through the
             plain forward over every head dim, MHA/GQA/MQA, masks, S 128,
             1000 and 2048, gemma-2b's 8/1 group at D 256 and
             h2o-danube-3-4b's 32/8 group with its 4096 window at D 120;
             timed at four training shapes, B 4 x 512: paper-llama-1.5b
             16 x 128, gemma-2b 8/1 x 256, h2o-danube-3-4b 32/8 x 120 and
             zamba2-2.7b's attention 32 x 80, and at granite-moe-3b-a800m's
             24/8 x 64, B 2 x 512, and whisper's encoder and cross-
             attention at B 4, 1500 and 448 x 1500, with SDPA's flash
             backward as the yardstick; the cross sweep as the forward's)
             and for the stage merge (against
             ``stage_merge_ref``; timed on one 4-layer stage of
             paper-llama-1.5b, ``torch._foreach_lerp`` as the yardstick).
             The two Adam kernels (``adam_sumsq``, ``adam_update``) against
             their plain versions over small leaf sets (tower and other
             leaves, ragged tails, misaligned views, weight decay, a clip
             that bites; each launched twice for bit-equality) and the whole
             tree of paper-llama-1.5b, timed there beside their bound, the
             plain versions and ``torch.optim.Adam(fused=True)`` (a
             yardstick only).
             The SSD scan (bf16 on the tensor cores, fp32 on the CUDA cores)
             against its two plain versions (chunked and token by token)
             over tests/test_kernels.py's sweep, ragged lengths, wider P and
             N, starting states and the real decay range, then the bf16
             kernel at both serving widths cut in batch and heads, P 48, 20
             and 4 and N 36 and 4 (padded inside the block), chunks of 1 and
             48 with ragged ends, and B and C rows 8, 4 and 2 bytes off a
             16-byte boundary; a state-carry check, and both models' serving
             shapes, timed there beside its bound and the chunked plain
             version (no PyTorch call computes it).
             The SSD backward (bf16 on the tensor cores, several blocks a
             head; fp32 on the CUDA cores) against ``ssd_chunked_bwd_ref``
             over tests/test_kernels.py's SSD shapes, ragged chunks and a
             chunk of 1 at the widest P and N with the real decay, starting
             states and dfinal, both training widths cut in batch and heads
             and B and C rows off a 16-byte boundary, each case launched
             twice for bit-equality; timed at both models' training shapes
             (B 8 x 512 x 64 heads, N 128; B 4 x 512 x 80 heads, N 64)
             beside its bound (and as a multiple of it) and the plain
             version (no PyTorch call computes it), and the fp32 check path
             at mamba2-1.3b's.
4. model   — paper-llama-1.5b, mamba2-1.3b, zamba2-2.7b, gemma-2b,
             h2o-danube-3-4b, whisper-large-v3 (2 encoder and 2 decoder
             layers over 1500 frames) and internvl2-76b (256 patches before
             the prompt; drawn on the card) at full width cut to 2 layers,
             fp32: prefill logits (and cache) on the card (kernels) against
             the port on the CPU (plain versions).
4b. model_moe — granite-moe-3b-a800m and deepseek-moe-16b the same way,
             batch 2: full-sequence logits, the (token, layer) routing
             decisions of card and CPU compared, the logits held on the
             tokens whose routing agreed (MOE_ROUTE_DIFF_MAX).
5. serve   — paper-llama-1.5b, all 24 layers, random weights from a seeded
             generator on the card: batch 8, prompt 512, 32 new tokens
             through ``launch.serve.generate``; the kernel must launch once
             per layer in the prefill.  Then, outside the counted run, the
             prefill with the kernel against the prefill with the plain
             version, and the kernel against the plain version on each
             layer's own attention inputs.  The same for mamba2-1.3b (48 SSD
             launches a prefill) and zamba2-2.7b (54 SSD launches and 6
             flash-forward launches at head dim 80), the SSD kernel held
             against the chunked plain version on every layer's inputs and
             against the token-by-token one on the first and last; and
             gemma-2b (18 flash-forward launches a prefill at head dim 256)
             and h2o-danube-3-4b (24 at head dim 120, window 4096), all
             layers, as paper-llama-1.5b.  serve_moe, serve_deepseek:
             granite-moe-3b-a800m (32 flash-forward launches at 24/8 x 64)
             and deepseek-moe-16b (28 at 16 x 128, all 28 layers, 33.8 GB in
             bf16, drawn leaf by leaf), the same checks with the routing
             drift of every comparison printed; the plain prefill is pinned
             to the kernel run's routing, and both bf16 prefills, pinned to
             an fp32 prefill's routing, are held against it
             (SERVE_LOGITS_TOL says why).  serve_whisper: whisper-large-v3
             at full size, batch 8 of 1500 frames, a 416-token prompt (96
             flash-forward launches a prefill: the encoder's, the decoder's
             causal and its cross-attention over the frames); serve_vlm:
             internvl2-76b cut to 26 of its 80 layers (SERVE_VLM says
             why), 256 patches before a 512-token prompt.
6. train_model — the same 2-layer fp32 cut, two Adam steps of the Trainer on
             the card (kernels) and on the CPU (plain versions) from the same
             parameters: loss and parameters agree.
7. train   — paper-llama-1.5b at full width and depth (24 layers, 6 stages,
             bf16 compute, fp32 masters and moments), batch 8 x 512:
             ``checkfree_plus`` for 6 steps under a forced schedule (a merge,
             an edge twin copy, a consecutive run of two merges), then
             ``checkfree`` for 4 steps with one merge.  Launch counts, the
             failures, the step-2 merge against its plain version, zeroed
             moments and the lr boost are asserted; the first two steps are
             held against the same steps with the plain attention swapped
             in, and the backward kernels are held against their plain
             version on each layer's own inputs of one step.
7b. train_fused — paper-llama-1.5b as train, ``checkfree_plus`` for 40 steps
             in fused windows of 8 (each a replayed CUDA graph under
             ``set_sync_debug_mode("error")``), stage 3 failing at wall 13
             so that a window is cut short and the merge runs at its
             boundary, stage 2 at wall 25; the same run in eager steps
             beside it.  Window sizes, launches (the graph's replays
             counted), the loss trace and omegas against the eager run,
             window ms, ms a step, tokens/s, peak memory and both merges'
             ms, device ms and new device allocations (none allowed: the
             capture keeps the cache of the eager step's blocks).
7c. train_telemetry — train_fused's fused run three times: dark (no
             recorder), lit (``telemetry.configure`` streaming into a run
             directory) and dark again, each under
             ``set_sync_debug_mode("warn")``.  Lit against dark: losses,
             omegas, dispatches and walls bit-equal, the same number of
             synchronizing-call warnings; the stream schema-valid with
             ``run_end.effective_steps`` 40, a ``window_dispatch`` and a
             ``window_drain`` span a window, 2 ``recovery`` spans, the
             ``step_window`` k summing to the walls; the port's report
             ``--strict`` returns 0 and the Chrome trace loads; the lit ms a
             step (median of the full windows after the first) within 2% of
             the mean of the two dark runs'.
7d. train_elastic — paper-llama-1.5b as train, ``elastic`` with the edge
             stages protected, 40 walls of the port's own simulated
             ``spot_shrink`` (ELASTIC_SCENARIO, seed 71): a failure at wall
             15, a departure that shrinks 6 -> 5 stages at 16, a merge on
             the uneven 5-stage layout (a gathered 4-layer neighbour) at 26
             and a regrow to 6 at 27; in fused windows of 8 and the same
             walls eagerly.  The repartition logs against the one the
             schedule implies, failures, losses and omegas (each first
             window after a re-layout at the new K) against the eager run,
             one capture per layout epoch, reserved memory after the last
             capture within 2 GiB of the first, the uneven merge against its
             plain version, launch counts; each re-layout's host ms, the
             first window of each epoch, ms a step and memory peaks per
             epoch, the uneven merge's ms.
8. train_gemma, train_danube — the same checks for ``checkfree`` (4 steps,
             a merge of stage 2 at step 2) at full width, batch 4 x 512:
             gemma-2b at full depth (18 layers, 6 stages; MQA at head dim
             256) and h2o-danube-3-4b cut to 12 of its 24 layers (6 stages;
             GQA at head dim 120, window 4096), the backward kernels
             running at those head dims.
8b. train_ssm — mamba2-1.3b at full width and depth (48 layers, 8 stages,
             batch 8 x 512): ``checkfree_plus`` for 6 eager steps under
             train's schedule with train's checks (the SSD scan and its
             backward launched once a layer and half-batch, the step-2
             merge against its plain version, the first two steps against
             the same steps with the plain SSD scan, the SSD backward
             against its plain version on every layer's inputs of one step,
             finite gradients; the plain comparison at batch 4, where the
             plain SSD's autograd fits); then 16 steps in fused windows of
             8 (the capture emptying the allocator's cache, which would not
             leave room for the graph's pool), stage 3 failing at the window
             boundary, against the same steps eagerly, bit for bit.  ms a
             step, tokens/s, peak allocated and reserved.
8c. train_hybrid — zamba2-2.7b at full width and depth (54 SSM layers and
             the shared attention block after every 9, 6 stages, batch 4 x
             512): train_gemma's checks for ``checkfree``, with the SSD
             kernels and the flash kernels at head dim 80 (6 a pass).
8d. train_moe — granite-moe-3b-a800m at full width and depth (32 layers, 8
             stages, batch 4 x 512): ``checkfree_plus`` for 6 eager steps
             with train's checks (the step-2 merge of a stage holding the
             (4, 40, 1536, 512) expert tensors, the backward kernels on a
             step's own inputs at 24/8 x 64) and aux of the order of 1 a
             layer; then 16 steps in fused windows of 8 at batch 2
             (MOE_FUSED_BATCH says why), bit-equal to the same steps
             eagerly.  train_deepseek: deepseek-moe-16b cut to 4 of its 28
             layers (4 stages of 1, batch 4; TRAIN_DEEPSEEK says why),
             train_gemma's checks for ``checkfree``.
8e. train_whisper — whisper-large-v3 at full size (8 stages of 4 encoder
             layers, the staged tower; batch 8 x 448 with 1500 frames):
             train_moe's checks for ``checkfree_plus`` (96 launches of each
             flash kernel a pass, 64 of them over 1500 keys), the plain
             comparison at batch 2, then 16 steps in fused windows of 8 at
             batch 4 against the same steps eagerly.  train_vlm:
             internvl2-76b cut to 2 of its 80 layers (TRAIN_VLM), 2 stages,
             batch 2 x (256 patches + 256 tokens), ``checkfree`` with an
             edge stage copied from its neighbour.
9. train_ckpt — the checkpoint baseline at TRAIN's full width and depth
             (cut to 12 layers, and said so, if the host cannot hold the
             state in half its free memory, or two saves in half the free
             space of the temporary directory): ``checkpoint`` every 3
             steps for 6 steps, wall 1 failing before the first save
             (restart from the initial parameters at step 0) and wall 5
             rolling back from step 4 to 3.  The effective-step trace, the
             replayed steps' losses against their first run, the restored
             parameters and moments bit-equal to the initial ones and to the
             checkpoint read back; save, device-to-host, rollback and step
             times beside ``torch.save`` of the same state to the same disk
             (a yardstick only).  About 32 GB on disk under the temporary
             directory, removed at the end.
10. train_neighbor — ``neighbor`` without its disk tier, 4 steps: six
             stage shards snapshotted to host memory every step, stage 3
             failing at wall 2 and served from the memory tier, bit-equal to
             the shard saved at step 2; snapshot time a step beside its
             bound over the host link.  A recorder of the run's own: one
             schema-valid ``snapshot_save`` event for each snapshot, with its
             bytes, and the one ``snapshot_restore`` with those of the shard
             it served.
10b. train_spmd — the pipeline-parallel backend (``Trainer(backend=
             "spmd")``) at TRAIN's full width and depth: six ranks, one a
             stage, all on the one card (gloo between them, staged through
             pinned host memory; no CUDA graph), ``checkfree_plus`` without
             edge protection for 12 steps in windows of up to 4, batch 8 x
             512 in microbatches of 4 (2 a half), stage 2 merged at wall 5
             by its neighbours' slices sent to its rank and stage 0 copied
             from its twin at wall 9.  First the same steps on the host
             backend (fused windows).  Every rank must exit 0; the failures
             equal the host run's, the losses within FUSED_LOSS_TOL * (1 +
             |loss|), the omegas within TRAIN_OMEGA_TOL, the recovery errors
             within SPMD_RECOVERY_TOL; each rank's flash forward, dq, dkv
             and Adam launches as the schedule implies and no plain-version
             call; rank 2's one merge launch.  ms a step (median of the full
             windows) and tokens/s beside the host run's, bytes sent a step
             by kind, host ms a step in transfers, each rank's peak memory,
             the merge's device ms on rank 2.
10c. train_spmd_store — the strategies that snapshot or restore state on
             the pipeline backend, in one spawn of six ranks on the card
             (SPMD's batch 8 in microbatches of 4, windows of up to 4), each
             schedule also run on the host backend, eagerly.
             paper-llama-1.5b at full width cut to 12 of its 24 layers
             (SPMD_STORE_LAYERS: at 24 the phase outgrew the host's memory
             and the script's time), said so with the host's readings, and
             the phase's lowest free host memory printed: ``checkpoint``
             (rollbacks from steps 5 and 6 to
             the save at 4, the second for the edge stage 0), ``neighbor``
             (a hot restore, then a consecutive pair whose replica holder
             dies with it, so the disk tier serves), ``tiered_ckpt``, and
             ``adaptive`` (``checkfree`` merging stage 2, switched to
             ``checkpoint`` by an observed failure rate and back, with a
             rollback while high).  Then the gathered path (a consecutive
             run merged on the tower gathered from every rank; a ``random``
             reinit) and the MoE pipeline (granite-moe-3b-a800m cut to 24
             of 32 layers, ``checkfree_plus``, batch 4 in one microbatch a
             half).  Gates: failures, effective-step trace, restore log and
             switches equal to the host run's; losses within
             FUSED_LOSS_TOL * (1 + |loss|), omegas within TRAIN_OMEGA_TOL;
             hot restores' recovery errors exactly 0, rollbacks NaN on both
             sides, the others within SPMD_RECOVERY_TOL; every rank's
             History equal to rank 0's; no plain-version call on any rank;
             each rank's flash and Adam launches as its walls say, the
             merge on the failed rank (every rank for the gathered run).
             ms a step, each rank's host ms of a save and a restore, peak
             memory by rank.
10d. train_remat — the dry-run's train_step (``launch.dryrun``: loss with
             remat, backward, ``adam_sumsq`` and ``adam_update``) with remat
             off, then on under REPRO_REMAT "nothing" and "dots", on the
             same weights and batch, for every family (REMAT_RUNS):
             paper-llama-1.5b cut to 4 layers, mamba2-1.3b and
             granite-moe-3b-a800m to 2, zamba2-2.7b to one segment,
             whisper-large-v3 to 2 + 2, internvl2-76b to 2; loss and
             gradients within REMAT_TOL * (1 + |w|) of remat off (bit
             equality printed), launches as ``remat_expected`` says (the
             flash forward twice a layer under "nothing", once under
             "dots").  Then the dry-run's estimate at ``--mesh 1x1`` (meta
             tensors) of paper-llama-1.5b at 4 layers, batch 8 x 512, and
             of qwen3-4b and h2o-danube-3-4b at full depth, batch 1 x 512,
             and three train_steps of each of those two on the card at the
             depth the estimate says fits: finite gradients, a falling
             loss, the kernels' launches equal to the dry-run's kernel
             calls, the estimate's peak within REMAT_PEAK_TOL of
             ``max_memory_allocated()``; ms a step, tokens/s, peak
             allocated and reserved.
10e. train_guarded — paper-llama-124m at full width and depth (12 layers,
             4 stages of 3, batch 8 x 512, bf16), ``checkfree`` in fused
             windows of 8 for 32 steps, stage 2 failing at step 16, the
             whole ``Trainer.run`` inside ``repro_torch.analysis.runtime.
             guarded()`` (``set_sync_debug_mode("error")`` from the set-up
             to the last drain: any implicit sync raises), then the same
             run unguarded.  Implicit syncs 0; the explicit sections by
             kind (drains, the capture, the set-up) and the dispatches;
             exactly one capture (``assert_capture_bound``); the merge's
             launch; ms a step of both runs; losses bit-equal.
10f. examples — each port example's ``main`` in-process on the card:
             torch_quickstart, torch_recovery_demo, torch_serve_batched,
             torch_spot_trace_demo (``--steps 24``) and
             torch_train_with_failures ``--full --steps 40`` (its four
             default strategies at paper-llama-124m's full size).  Every
             loss finite, each train_with_failures run's failures its
             schedule's, a merge, the greedy tokens (4, 12); each
             example's wall time and its launches (the windows' replays
             counted).
11. kernels — one line for every kernel: launches (the training paths and
             for the SSD scan the serving ones, and by path), error, times,
             bound.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

LOADED = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import telemetry  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.ckpt.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.config import (OptimizerConfig, RecoveryConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.stages import StagePartition  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.core.window import OMEGAS, RECORD, FusedWindow  # noqa: E402
from repro_torch.data.pipeline import (SyntheticLM, batch_for,  # noqa: E402
                                       make_batches)
from repro_torch.kernels import adam as AD  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels import stage_merge as SM  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import spawn_stages  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adam as A  # noqa: E402
from repro_torch.recovery import default_protect_edges  # noqa: E402
from repro_torch.sim import get_scenario, simulate  # noqa: E402
from repro_torch.analysis import runtime as guard  # noqa: E402
from repro_torch.statestore import codec as ss_codec  # noqa: E402
from repro_torch.statestore import store as store_mod  # noqa: E402
from repro_torch.statestore import strategies as ss_strategies  # noqa: E402
from repro_torch.telemetry import report as tel_report  # noqa: E402

# H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core peak, fp32 peak
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# tests/test_kernels.py's tolerances; lse in fp32 for both dtypes
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
LSE_TOL = 1e-4
# bf16 at the serving shape and on the serving path's own inputs: kernel and
# plain version both round an fp32 result to bf16, so they differ by at most
# one bf16 ulp, 2**-7 of |w| < 1e-2 * (1 + |w|)
SERVE_TOL = 1e-2
# the full 24-layer bf16 prefill with the kernel against the same prefill with
# the plain version, as a share of the largest |logit|
# (tests/test_smoke_archs.py's bf16 limit).  The MoE models route: a bf16
# difference in the attention moves the router's inputs, a choice flips and
# the flip travels through the later layers (about half of the decisions
# differ after 28-32 layers of random weights, for the plain version as for
# the kernel).  There the plain prefill is pinned to the kernel run's
# routing (each layer's experts taken from it, weighed by its own gates) and
# held to this limit; and both bf16 prefills, pinned to the routing of an
# fp32 prefill with the plain versions on the same weights, are held to it
# against that fp32 prefill
SERVE_LOGITS_TOL = 0.05
# the 2-layer fp32 model on the card against the CPU: cuBLAS and the CPU's
# BLAS sum d=2048 and d_ff=5504 products in different orders
MODEL_TOL = 1e-3
SERVE = dict(arch="paper-llama-1.5b", batch=8, prompt=512, new_tokens=32)
# the 2-layer cuts held card vs CPU: (arch, prompt, config changes)
# (gemma-2b and h2o-danube-3-4b: the fp32 kernel at head dims 256 and 120)
# (whisper-large-v3: 2 encoder and 2 decoder layers at d 1280 over 1500
# frames, the flash kernels at Sq != Sk; internvl2-76b: 2 layers at d 8192,
# 3.9 B parameters, 256 patches before the prompt)
MODEL_CHECKS = (("paper-llama-1.5b", 256, {}), ("mamba2-1.3b", 128, {}),
                ("zamba2-2.7b", 128, {"attn_every": 1}), ("gemma-2b", 200, {}),
                ("h2o-danube-3-4b", 200, {}),
                ("whisper-large-v3", 128, {"num_encoder_layers": 2}),
                ("internvl2-76b", 64, {}))
# cuts larger than this (parameters) are drawn on the card and copied to the
# host (the CPU's generator draws about 20 M a second)
MODEL_DRAW_ON_CARD = 1e9
# the backward kernels: tests/test_kernels.py's VJP tolerance for fp32; bf16
# gradients are rounded once from fp32 sums taken in different orders by the
# kernel and the plain version: 3e-2 * (1 + |w|) (tests/test_kernels.py:16-17)
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# the merge: fp32 1e-6 * (1 + |w|) (tests/test_recovery.py:118); bf16 one ulp
# (2**-7 of |w|: 8 significant bits)
MERGE_TOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7}
# the training shape: half of checkfree_plus's batch of 8 x 512 runs each
# stage order, so the attention kernels see B 4
TRAIN = dict(arch="paper-llama-1.5b", stages=6, batch=8, seq=512)
# what one layer of a training step gives the backward kernels, batch 4 x
# 512: paper-llama-1.5b (checkfree_plus's half batch), gemma-2b and
# h2o-danube-3-4b (checkfree, batch 4), and zamba2-2.7b's shared attention
# (no training path yet: its head dim 80, timed at the same batch)
TRAIN_ATTN_SHAPES = {
    "d128": dict(b=4, h=16, hkv=16, s=512, d=128, window=0),
    "d256": dict(b=4, h=8, hkv=1, s=512, d=256, window=0),
    "d120": dict(b=4, h=32, hkv=8, s=512, d=120, window=4096),
    "d80": dict(b=4, h=32, hkv=32, s=512, d=80, window=0),
    "d64": dict(b=2, h=24, hkv=8, s=512, d=64, window=0),
    # the examples' small model, as its forward
    "d16": dict(b=8, h=4, hkv=4, s=64, d=16, window=0),
    # whisper-large-v3's attentions at train_whisper's half batch of 4:
    # the encoder's over its 1500 frames (full) and the decoder's 448 rows
    # over them (cross-attention, full)
    "enc": dict(b=4, h=20, hkv=20, s=1500, d=64, window=0, causal=False),
    "cross": dict(b=4, h=20, hkv=20, s=448, sk=1500, d=64, window=0,
                  causal=False)}
# checkfree_plus: a merge, an edge twin copy, a consecutive run (two merges)
PLUS_SCHEDULE = {2: [3], 4: [0], 5: [2, 3]}
PLUS_STEPS, PLUS_MERGES = 6, 3
CHECKFREE_SCHEDULE = {2: [2]}
CHECKFREE_STEPS, CHECKFREE_MERGES = 4, 1
# the two dense models whose backward runs at head dims no other path runs:
# gemma-2b at full depth (18 layers, 3 a stage; MQA at head dim 256) and
# h2o-danube-3-4b (GQA at head dim 120, window 4096) cut to 12 of its 24
# layers, 2 a stage: at full depth its fp32 masters, Adam moments and
# gradients alone (3.97 B parameters x 16 B = 63.5 GB) and its bf16 weights
# and activations would not fit the card's 80 GB.  Both: batch 4 x 512,
# ``checkfree`` under CHECKFREE_SCHEDULE (stage 2 merged at step 2).
TRAIN_GEMMA = dict(arch="gemma-2b", stages=6, batch=4, seq=512)
TRAIN_DANUBE = dict(arch="h2o-danube-3-4b", stages=6, batch=4, seq=512,
                    layers=12)
# kernels vs plain attention over the first two (failure-free) training
# steps, bf16 compute: both round attention outputs to bf16 from fp32 sums in
# different orders, and one-ulp differences travel through 24 layers and the
# first Adam update.  The loss is a mean over 4,096 tokens: 1%.  Each stage's
# omega is a squared gradient norm, which squares the relative differences of
# the gradients: 5%.
TRAIN_LOSS_TOL = 0.01
TRAIN_OMEGA_TOL = 0.05
# 2 layers at full width, fp32, two Adam steps, card vs CPU: cuBLAS and the
# CPU's BLAS sum in different orders, and Adam's first steps move each
# parameter by about lr whatever the gradient's size
TRAIN_MODEL_TOL = 1e-3
# the SSD scan: tests/test_kernels.py's tolerances for y (fp32 1e-4, bf16
# 3e-2), and 1e-4 * (1 + |w|) for the fp32 final state in both dtypes (kernel
# and plain versions sum the same fp32 products in different orders)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SSD_STATE_TOL = 1e-4
# what one layer's prefill gives the SSD kernel: B 8 x T 512, one group, bf16
SSD_SERVE = {"mamba2-1.3b": dict(b=8, t=512, h=64, p=64, g=1, n=128),
             "zamba2-2.7b": dict(b=8, t=512, h=80, p=64, g=1, n=64)}
SSD_CHUNK = 64
SERVE_SSM = dict(arch="mamba2-1.3b", batch=8, prompt=512, new_tokens=32)
SERVE_HYBRID = dict(arch="zamba2-2.7b", batch=8, prompt=512, new_tokens=32)
# of the prefill's SSD inputs, these layers are also held against the
# token-by-token definition (the chunked plain version checks every layer)
SSD_TOKEN_LAYERS = (0, -1)
# what one layer of a prefill gives the flash forward, batch 8 x 512:
# paper-llama-1.5b (16 heads of 128), zamba2-2.7b's shared attention (32 of
# 80), h2o-danube-3-4b (32 query heads on 8 kv heads of 120, window 4096),
# gemma-2b (8 query heads on one kv head of 256)
ATTN_SHAPES = {"d128": dict(b=8, h=16, hkv=16, s=512, d=128, window=0),
               "d80": dict(b=8, h=32, hkv=32, s=512, d=80, window=0),
               "d120": dict(b=8, h=32, hkv=8, s=512, d=120, window=4096),
               "d256": dict(b=8, h=8, hkv=1, s=512, d=256, window=0),
               "d64": dict(b=8, h=24, hkv=8, s=512, d=64, window=0),
               # the examples' small model (examples/torch_quickstart.py):
               # batch 8 x 64 tokens, 4 heads of 16
               "d16": dict(b=8, h=4, hkv=4, s=64, d=16, window=0),
               # whisper-large-v3, batch 8: the encoder over 1500 frames
               # (full) and the decoder's 416 prompt rows over them
               "enc": dict(b=8, h=20, hkv=20, s=1500, d=64, window=0,
                           causal=False),
               "cross": dict(b=8, h=20, hkv=20, s=416, sk=1500, d=64,
                             window=0, causal=False)}
# cross-attention (Sq != Sk, full) in the kernel sweeps: whisper's decoder
# rows (one, a ragged 65, the serving prompt 416, the training 448) over its
# 1500 frames, and short key runs below one tile (a lone key, 37 keys)
CROSS_LENGTHS = ((1, 1500), (65, 1500), (416, 1500), (448, 1500), (100, 37),
                 (7, 1))
SERVE_GEMMA = dict(arch="gemma-2b", batch=8, prompt=512, new_tokens=32)
# the checkpoint baseline at TRAIN's shape: no save before wall 1 (restart
# from the initial parameters at step 0), saves at steps 3 and 6, wall 5
# rolls back from step 4 to 3; each replayed step repeats its first run's
# arithmetic on the same inputs, so its loss may differ only by the
# card's nondeterminism: 1e-6 relative
CKPT_EVERY, CKPT_STEPS = 3, 6
CKPT_SCHEDULE = {1: [2], 5: [4]}
CKPT_TRACE = [1, 1, 2, 3, 4, 4, 5, 6]
CKPT_REPLAY_TOL = 1e-6
# neighbour replication without a disk tier: stage 3 fails at wall 2 and is
# served by its replica on host 4 from the memory tier, saved at step 2
NEIGHBOR_STEPS = 4
NEIGHBOR_SCHEDULE = {2: [3]}
NEIGHBOR_RESTORE = (2, 3, 2, "mem")
# the depth both phases fall back to when the host cannot hold their state
CKPT_CUT_LAYERS = 12
# the card's host link, each way: PCIe 5.0 x16 (H100 SXM data sheet)
HOST_LINK_BYTES_PER_S = 64e9
SERVE_DANUBE = dict(arch="h2o-danube-3-4b", batch=8, prompt=512,
                    new_tokens=32)
# the Adam kernels against their plain versions: the sums of squares are
# taken in fp64 by the kernel and in fp32 by the plain version, 1e-6
# relative; the update repeats the plain version's fp32 arithmetic (one
# rounding may differ where the plain version's add fuses a multiply),
# 1e-6 * (1 + |w|)
ADAM_SUMSQ_TOL = 1e-6
ADAM_TOL = 1e-6
# at the main path's size each of p, m and v is also held against the size
# of its own change in the plain version: within ADAM_STEP_TOL * |w_new -
# w_old| + ADAM_ULPS * |w_new| (two fp32 ulps), so that a kernel that
# leaves a tensor unchanged or scales its step by 1.001 or more fails even
# where the change is far below 1e-6
ADAM_STEP_TOL = 1e-3
ADAM_ULPS = 2.0 ** -22
# fused windows at TRAIN's shape: checkfree_plus, windows of up to 8, stage
# 3 fails at wall 13, so the window from wall 8 is cut to 4 and 1 and the
# merge runs at a window boundary, and stage 2 at wall 25 (the first merge
# after the capture and a later one); the windows are FUSED_SIZES.  The fused
# run against the same run in eager steps, the same kernels: the loss
# within 1e-3 * (1 + |loss|) (a graph replays the eager step's kernels, but
# nothing asks cuBLAS for the same algorithms under capture), the omegas
# within TRAIN_OMEGA_TOL
FUSED_WINDOW, FUSED_STEPS = 8, 40
FUSED_SCHEDULE = {13: [3], 25: [2]}
FUSED_SIZES = [8, 4, 1, 8, 4, 8, 4, 2, 1]
FUSED_LOSS_TOL = 1e-3
# telemetry on the main path: train_fused's fused run (TRAIN, FUSED_SCHEDULE,
# windows of 8) dark (no recorder), lit (a recorder streaming into a run
# directory) and dark again; lit and dark equal bit for bit with the same
# dispatches and synchronizing calls, and the lit ms a step within 2% of
# the mean of the two dark runs' (a fused window idles the card under 2%,
# and the sites run once a window, on the host)
TELEMETRY_MS_TOL = 0.02
# elastic repartitioning at TRAIN's shape: the port's simulator on
# spot_shrink with these overrides and seed, 6 stages, the edges protected
# (``elastic`` has no swap twins).  spot_shrink makes every failure a
# departure (rejoin "never"); respawning the node and departing it with
# probability 0.5 gives transient failures too, and 91.3 s walls are the wall
# model's iteration time (40 walls: about one simulated hour).  Chosen on the
# CPU (the simulator is numpy: the same events on any machine) so that within
# ELASTIC_STEPS walls slot 4 fails at wall 15 (6 stages), departs at 16 (6 ->
# 5 stages, 5/5/5/5/4 layers), slot 3 fails at 26 (stage 3 of 5: neighbours
# of 5 and 4 layers, so the merge takes a gathered neighbour) and slot 4
# regrows at 27 (5 -> 6).  Windows of 8 against the same walls eagerly, at
# train_fused's limits; reserved memory after the last capture within
# ELASTIC_RESERVED_GIB of its value after the first
ELASTIC_SCENARIO = dict(rate_per_hour=0.8, regrow_h=0.4, rejoin="respawn",
                        depart_prob=0.5, iteration_time_s=91.3)
ELASTIC_SEED, ELASTIC_STEPS, ELASTIC_WINDOW = 71, 40, 8
ELASTIC_STORY = [(15, "fail", 4), (16, "depart", 4), (26, "fail", 3),
                 (27, "regrow", 4)]
ELASTIC_UNEVEN = (26, 3)              # (wall, stage) of the uneven merge
ELASTIC_RESERVED_GIB = 2.0
CARD_BYTES = 80e9
# training the ssm and hybrid families at full width and depth (random
# weights, bf16 compute, fp32 masters and moments, seq 512): mamba2-1.3b in
# 8 stages of 6 layers, batch 8 (checkfree_plus's half batch gives the SSD
# kernels B 4), and zamba2-2.7b in 6 stages of 9 (the shared attention block
# after each), batch 4
TRAIN_SSM = dict(arch="mamba2-1.3b", stages=8, batch=8, seq=512)
TRAIN_HYBRID = dict(arch="zamba2-2.7b", stages=6, batch=4, seq=512)
# the plain SSD scan's autograd keeps its chunked intermediates: mamba2-
# 1.3b's two steps with it run at batch 4, beside the same two steps with the
# kernels at batch 4 (at batch 8 the plain run did not fit the card: out of
# memory at 76.7 GiB allocated on an NVIDIA H100 80GB HBM3, 700 W)
SSM_PLAIN_BATCH = 4
# train_ssm's fused walls: 16 steps in windows of 8, stage 3 failing at wall
# 8, between the two windows; the fused run equals the eager one bit for
# bit.  At batch 8 the eager step's cached blocks (38.6 GiB) and the graph's
# own pool do not fit the card together, so the capture empties the cache
# (core/window.py) and the merge between the windows allocates anew
SSM_FUSED_STEPS, SSM_FUSED_SCHEDULE, SSM_FUSED_SIZES = 16, {8: [3]}, [8, 8]
# the SSD backward, timed at both models' training shapes (bf16, chunk 64,
# the real decay, B and C strided views of xBC)
SSD_TRAIN = {"mamba2-1.3b": dict(b=8, t=512, h=64, p=64, g=1, n=128),
             "zamba2-2.7b": dict(b=4, t=512, h=80, p=64, g=1, n=64)}
# the MoE family.  granite-moe-3b-a800m's attention is 24 query heads on 8
# kv heads of 64, a group of 3 that no other path gives the flash kernels:
# swept at S 512 and a ragged 333, timed at its serving shape (ATTN_SHAPES)
# and its training shape (TRAIN_ATTN_SHAPES)
GRANITE_GROUP = (24, 8, 64)
GRANITE_SWEEP_LENGTHS = (512, 333)
# the 2-layer fp32 cuts held card vs CPU, batch 2 x prompt.  Routing is
# discrete: cuBLAS and the CPU's BLAS sum the router's d-long products in
# different orders, so a gate within ~1e-6 of the next one may swap a
# choice (and then the slots of the choices after it).  The check counts
# the (token, layer) decisions (top-k set and kept set) that differ, holds
# the full-sequence logits to MODEL_TOL on the rows whose own routing and
# whose sequence's earlier tokens' routing agreed in every layer, and fails
# if more than MOE_ROUTE_DIFF_MAX of the decisions differ (in fp32 the gates
# of 40 or 64 experts from random weights are rarely within 1e-6: a larger
# share would be a fault, not rounding)
MOE_MODEL_CHECKS = (("granite-moe-3b-a800m", 256), ("deepseek-moe-16b", 256))
MOE_MODEL_BATCH = 2
MOE_ROUTE_DIFF_MAX = 0.01
SERVE_MOE = dict(arch="granite-moe-3b-a800m", batch=8, prompt=512,
                 new_tokens=32)
# all 28 layers in bf16 (16.9 B parameters, 33.8 GB), drawn leaf by leaf
# in bf16 (its fp32 tree, 67.5 GB, would not fit beside it)
SERVE_DEEPSEEK = dict(arch="deepseek-moe-16b", batch=8, prompt=512,
                      new_tokens=32)
# granite-moe-3b-a800m at full width and depth: 32 layers, 8 stages of 4,
# batch 4 x 512 (checkfree_plus's half batch: 2 x 512 a stage order),
# checkfree_plus under PLUS_SCHEDULE; then 16 steps in fused windows of 8,
# stage 3 failing at the window boundary, bit-equal to the same steps
# eagerly
TRAIN_MOE = dict(arch="granite-moe-3b-a800m", stages=8, batch=4, seq=512)
MOE_FUSED_STEPS, MOE_FUSED_SCHEDULE, MOE_FUSED_SIZES = 16, {8: [3]}, [8, 8]
# the fused windows run at batch 2 x 512: at batch 4 the captured step's
# private pool took 38.60 GiB beside the 38.49 GiB of fp32 masters and
# moments, and the merge after the first window found no room for 480 MiB
# (NVIDIA H100 80GB HBM3, 700 W), as zamba2-2.7b's capture did at batch 4
# (ROADMAP.md queue 1, "Fused windows: what is left")
MOE_FUSED_BATCH = 2
# deepseek-moe-16b cut to 4 of its 28 layers, 4 stages of 1: at full depth
# its fp32 masters, gradients and Adam moments alone (16.9 B parameters x
# 16 B = 270 GB) would not fit the card's 80 GB; 4 layers hold 2.77 B
# parameters (the 102400 x 2048 embedding and head are a sixth of them),
# 44.3 GB of state.  checkfree, batch 4 x 512, stage 2 merged at step 2
TRAIN_DEEPSEEK = dict(arch="deepseek-moe-16b", stages=4, batch=4, seq=512,
                      layers=4)
# the encoder-decoder family: whisper-large-v3 at full size (32 encoder and
# 32 decoder layers, d 1280, 20 x 64, 1.535 B parameters).  Serving: batch 8
# of 1500 frames, a prompt of 416 tokens and 32 new ones (448 is whisper's
# text context); a prefill launches the flash forward 96 times (32 over the
# frames without a mask, 32 causal over the prompt, 32 cross from the prompt
# to the frames).  Training: 8 stages of 4 encoder layers (the JAX trainer
# stages the encoder, ``towers(cfg)[0]``), batch 8 x 448 tokens with 1500
# frames, checkfree_plus under PLUS_SCHEDULE
SERVE_WHISPER = dict(arch="whisper-large-v3", batch=8, prompt=416,
                     new_tokens=32)
TRAIN_WHISPER = dict(arch="whisper-large-v3", stages=8, batch=8, seq=448)
# the plain attention's autograd keeps three fp32 (B, 20, 1500, 1500)
# tensors an encoder layer: its two steps run at batch 2 (a sample a stage
# order), beside the same steps with the kernels at batch 2
WHISPER_PLAIN_BATCH = 2
# the fused windows: 16 steps in windows of 8 at batch 4 (a capture takes
# 1.6-2 times the eager working set, as granite-moe's and zamba2's did, and
# at batch 8 the eager step alone peaks at 57.8 GiB), stage 3 failing at the
# window boundary, against the same steps eagerly
WHISPER_FUSED_BATCH = 4
WHISPER_FUSED_STEPS, WHISPER_FUSED_SCHEDULE, WHISPER_FUSED_SIZES = \
    16, {8: [3]}, [8, 8]
# the VLM family: internvl2-76b (80 layers, d 8192, GQA 64/8 x 128, d_ff
# 28672, vocab 128256 untied: 70.6 B parameters, 141 GB in bf16) cut in
# depth.  Serving: 26 of 80 layers (48.9 GB of bf16 weights), the deepest
# cut whose build fits the card with room to spare: the build draws each
# stacked leaf in fp32 before it casts it, so the last MLP leaf's fp32 (0.94
# GB a layer) sits beside the bf16 weights drawn so far (1.71 GB a layer,
# and 4.4 GB of embedding, head and projector).  On an NVIDIA H100 80GB
# HBM3 (700 W) 24 layers built at a 61.24 GiB peak; at 28 the cast of the
# last MLP leaf (12.25 GiB) found 10.12 GiB free beside 58.90 GiB allocated
# and 9.42 GiB of the allocator's split blocks.  Batch 8 of 256 patches and
# a 512-token prompt, 32 new tokens (a cache of 800).
# Training: 2 of 80 layers (3.89 B parameters, 62.2 GB of fp32 masters,
# moments and gradients and a 7.8 GB bf16 cast; 3 layers would need ~85 GB),
# 2 stages of 1, batch 2 x (256 patches + 256 tokens), checkfree with stage 1
# failing at step 2: with 2 stages both are edges, and CheckFree copies the
# neighbour there (repro/recovery/strategies.py:171-174)
SERVE_VLM = dict(arch="internvl2-76b", batch=8, prompt=512, new_tokens=32,
                 layers=26)
TRAIN_VLM = dict(arch="internvl2-76b", stages=2, batch=2, seq=256, layers=2,
                 schedule={2: [1]})
# the load-balance loss of a layer is about 1 where the router spreads the
# tokens evenly (E * sum of E shares of 1/E each) and E where one expert
# takes every token's first choice; aux sums the layers.  A step's aux per
# layer must lie between MOE_AUX_LOW and E / MOE_AUX_SPREAD: of the order
# of 1, at most half the way to a router that sends everything to one
# expert (random weights route unevenly, the more so in small groups)
MOE_AUX_LOW, MOE_AUX_SPREAD = 0.5, 2.0
# train_remat: the dry-run's train_step with remat off, then on under
# REPRO_REMAT "nothing" and "dots", on the same weights and batch (lr 0, so
# that Adam leaves the weights as they were); zamba2-2.7b at one segment
# (its attn_every mamba2 layers and the shared block), whisper at 2 + 2
# layers, internvl2-76b at batch 1 x (256 patches + 256 tokens), where its
# 3.9 B parameters, their moments and two sets of gradients fit
REMAT_RUNS = (dict(arch="paper-llama-1.5b", layers=4, batch=8, seq=512),
              dict(arch="mamba2-1.3b", layers=2, batch=4, seq=512),
              dict(arch="granite-moe-3b-a800m", layers=2, batch=4, seq=512),
              dict(arch="zamba2-2.7b", layers=None, batch=4, seq=512),
              dict(arch="whisper-large-v3", layers=2, batch=4, seq=448),
              dict(arch="internvl2-76b", layers=2, batch=1, seq=512))
REMAT_POLICIES = (None, "nothing", "dots")      # None: remat off
REMAT_TOL = 1e-5                                # x (1 + |remat-off value|)
# then the dry-run's estimate at --mesh 1x1 and the same step on the card,
# three steps of each model at full depth (or the depth the estimate says
# fits), batch 1 x 512, "nothing"; the estimate's peak within
# REMAT_PEAK_TOL of max_memory_allocated(); a model fits where its
# estimate, grown by REMAT_PEAK_TOL, fits the card's free memory
REMAT_FULL = ("qwen3-4b", "h2o-danube-3-4b")
REMAT_FULL_BATCH, REMAT_FULL_SEQ, REMAT_STEPS = 1, 512, 3
REMAT_ESTIMATE_CUT = dict(arch="paper-llama-1.5b", layers=4, batch=8,
                          seq=512)
REMAT_PEAK_TOL = 0.10
# train_guarded: examples/train_with_failures.py --full's model at full
# width and depth, checkfree in windows of 8, stage 2 failing at step 16;
# the whole Trainer.run under repro_torch.analysis.runtime.guarded(), and
# the same run unguarded
GUARDED = dict(arch="paper-llama-124m", stages=4, batch=8, seq=512,
               steps=32, window=8, schedule={16: [2]})
# examples: each port example's main on the card, in-process
# (argv beside --device cuda); spot_trace_demo's steps cut to seconds
EXAMPLES = (("torch_quickstart", []), ("torch_recovery_demo", []),
            ("torch_serve_batched", []),
            ("torch_spot_trace_demo", ["--steps", "24"]),
            ("torch_train_with_failures", ["--full", "--steps", "40"]))


def emit(phase: str, **kw) -> None:
    """One JSON line of a phase, with ``t_s``: the seconds since this
    module was loaded (the script's clock, for the phases' durations)."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - LOADED}), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def qkv(gen, b, hq, hkv, s, d, dtype, sk=None):
    """q of ``s`` rows, k and v of ``sk`` (default ``s``)."""
    sk = s if sk is None else sk
    shapes = ((b, hq, s, d), (b, hkv, sk, d), (b, hkv, sk, d))
    return [torch.randn(sh, generator=gen, device="cuda").to(dtype)
            for sh in shapes]


def time_ms(fn, groups: int = 21, per_group: int = 20, warmup: int = 3
            ) -> float:
    """Device ms per call: the median over ``groups`` of one CUDA-event pair
    around ``per_group`` back-to-back calls, divided by ``per_group``.

    Each group is queued behind a ~10 ms device sleep, so the host has
    enqueued every call before the start event fires and the events see
    device time only, not the host's work before each launch.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_group)
    return float(np.median(times))


def compare(q, k, v, *, causal: bool, window: int, tol: float) -> tuple:
    """The kernel against its plain version on the same inputs, element-wise:
    out within ``tol * (1 + |want|)``, lse within ``LSE_TOL * (1 + |lse|)``.
    Returns (ok, max |out error|, max |lse error|)."""
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)
    o, w = out.float(), want.float()
    ok = bool(((o - w).abs() <= tol * (1 + w.abs())).all())
    ok &= bool(((lse - want_lse).abs() <= LSE_TOL * (1 + want_lse.abs())).all())
    ok &= bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    return ok, float((o - w).abs().max()), float((lse - want_lse).abs().max())


def phase_env() -> str:
    card = smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


def demangled(lines: list) -> list:
    """``lines`` with each quoted mangled C++ name (``'_Z...'``) replaced by
    its demangled form, so that the instantiations read as
    ``ssd_scan_bf16_kernel<128>(Params)``; unchanged without c++filt."""
    names = sorted({m for ln in lines for m in re.findall(r"'(_Z\w+)'", ln)})
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return lines
    plain = dict(zip(names, out))
    return [re.sub(r"'(_Z\w+)'", lambda m: f"'{plain.get(m[1], m[1])}'", ln)
            for ln in lines]


def phase_build() -> None:
    t0 = time.perf_counter()
    info = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: demangled([ln.strip() for ln in r["log"].splitlines()
                              if "entry function" in ln or "registers" in ln
                              or "spill" in ln])
             for name, r in info.items()}
    emit("build", seconds=seconds, sources=sorted(info), ptxas=ptxas)


# The sweeps draw each case's inputs from the phase's generator in turn, at
# the head dims of FIRST_HEAD_DIMS; head dim 16, the examples' small model,
# is swept after them from a generator of its own (later_gen), so its cases
# leave the inputs of the others as they were.
FIRST_HEAD_DIMS = tuple(d for d in FA.FWD_HEAD_DIMS if d != 16)
LAST_HEAD_DIMS = (16,)
assert FA.BWD_HEAD_DIMS == FA.FWD_HEAD_DIMS


def later_gen() -> torch.Generator:
    return torch.Generator("cuda").manual_seed(16)


def sweep_cases(dims=FIRST_HEAD_DIMS):
    """(dtype, b, hq, hkv, s, d, causal, window, tol) of the kernel sweep,
    at the head dims ``dims``."""
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in ((16, 16), (32, 8), (4, 1), (8, 1)):
            for dd in dims:
                for causal, window in ((True, 0), (True, 100), (False, 0)):
                    # shorter than one tile, ragged, long
                    for ss in (1, 37, 63, 128, 1000, 2048):
                        yield (dtype, 1 if ss == 2048 else 2, hq, hkv, ss, dd,
                               causal, window, TOL[dtype])
                # h2o-danube's window, longer than the prompt
                yield (dtype, 2, hq, hkv, 512, dd, True, 4096, TOL[dtype])
        # granite-moe-3b-a800m's group of 3
        hq, hkv, dd = GRANITE_GROUP
        for ss in GRANITE_SWEEP_LENGTHS if dd in dims else ():
            yield (dtype, 2, hq, hkv, ss, dd, True, 0, TOL[dtype])
        # the serving shapes, where bf16 is held to one ulp
        for shape in ATTN_SHAPES.values():
            if "sk" in shape or not shape.get("causal", True) or \
                    shape["d"] not in dims:
                continue                  # in cross_cases, or another pass
            yield (dtype, shape["b"], shape["h"], shape["hkv"], shape["s"],
                   shape["d"], True, shape["window"],
                   TOL[dtype] if dtype == torch.float32 else SERVE_TOL)


def cross_cases(dims=FIRST_HEAD_DIMS):
    """(dtype, b, hq, hkv, sq, sk, d) of the sweep over another key length
    than the query length (cross-attention, full): whisper's decoder rows
    over its 1500 frames (23 tiles of 64 and a ragged 28), MHA and GQA,
    at the head dims ``dims``, and short key runs."""
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in ((4, 4), (8, 2)):
            for d in dims:
                for sq, sk in CROSS_LENGTHS:
                    yield dtype, 1, hq, hkv, sq, sk, d


def time_fwd(shape: dict, gen) -> dict:
    """The forward kernel, its plain version and SDPA at a bf16 serving
    shape (causal unless ``shape["causal"]`` says otherwise; ``shape["sk"]``
    keys when given), beside the bound."""
    b, h, hkv, s, d, window = (shape[x] for x in
                               ("b", "h", "hkv", "s", "d", "window"))
    causal, sk = shape.get("causal", True), shape.get("sk", s)
    q, k, v = qkv(gen, b, h, hkv, s, d, torch.bfloat16, sk)
    ok, err, lse_err = compare(q, k, v, causal=causal, window=window,
                               tol=SERVE_TOL)
    if not ok:
        raise AssertionError(f"serving shape {shape}: out error {err}, lse "
                             f"error {lse_err}")
    kernel_ms = time_ms(lambda: FA.flash_attention_fwd(q, k, v, causal=causal,
                                                       window=window))
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                       window=window))
    # the yardstick computes the same function only where the window does
    # not cut the prompt
    assert window == 0 or window >= s, shape
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=hkv != h))
    # q, k, v read once; out (like q) and the fp32 lse written once
    nbytes, flops = cost.flash_fwd(b, h, hkv, s, sk, d, itemsize=2,
                                   causal=causal, window=window)
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[torch.bfloat16] * 1e3
    row = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    emit("kernel_time", kernel="flash_attention_fwd",
         shape=dict(shape, dtype="bfloat16", causal=causal, sk=sk),
         bytes=nbytes,
         flops=flops, **row, lse_err=lse_err, tol=SERVE_TOL,
         library="scaled_dot_product_attention",
         timing="median of 21 groups of 20 back-to-back calls, CUDA events")
    return row


def phase_kernel() -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    cases = failures = 0
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    for dims, g in ((FIRST_HEAD_DIMS, gen), (LAST_HEAD_DIMS, later_gen())):
        for dtype, b, hq, hkv, s, d, causal, window, tol in sweep_cases(dims):
            q, k, v = qkv(g, b, hq, hkv, s, d, dtype)
            ok, out_err, lse_err = compare(q, k, v, causal=causal,
                                           window=window, tol=tol)
            name = str(dtype).split(".")[1]
            worst[name][0] = max(worst[name][0], out_err)
            worst[name][1] = max(worst[name][1], lse_err)
            cases += 1
            if not ok:
                failures += 1
                print(f"MISMATCH dtype={name} b={b} hq={hq} hkv={hkv} d={d} "
                      f"causal={causal} window={window} s={s}",
                      file=sys.stderr)
        for dtype, b, hq, hkv, sq, sk, d in cross_cases(dims):
            q, k, v = qkv(g, b, hq, hkv, sq, d, dtype, sk)
            ok, out_err, lse_err = compare(q, k, v, causal=False, window=0,
                                           tol=TOL[dtype])
            name = str(dtype).split(".")[1]
            worst[name][0] = max(worst[name][0], out_err)
            worst[name][1] = max(worst[name][1], lse_err)
            cases += 1
            if not ok:
                failures += 1
                print(f"MISMATCH cross dtype={name} hq={hq} hkv={hkv} d={d} "
                      f"sq={sq} sk={sk}", file=sys.stderr)
    emit("kernel_check", kernel="flash_attention_fwd", cases=cases,
         failures=failures, cross_lengths=CROSS_LENGTHS,
         max_abs_err={k: {"out": v[0], "lse": v[1]} for k, v in worst.items()},
         tol={"float32": TOL[torch.float32], "bfloat16": TOL[torch.bfloat16],
              "bfloat16_serving_shape": SERVE_TOL, "lse": LSE_TOL})
    if failures:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain "
                             f"version in {failures} of {cases} cases")

    # the serving shapes: bf16, causal, one layer of paper-llama-1.5b (the
    # row's numbers), zamba2-2.7b's shared block at head dim 80,
    # h2o-danube-3-4b at 120 and gemma-2b at 256
    row = {"name": "flash_attention_fwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:39",
           **time_fwd(ATTN_SHAPES["d128"], gen)}
    for name in ("d80", "d120", "d256", "d64", "enc", "cross", "d16"):
        row[name] = time_fwd(ATTN_SHAPES[name], gen)
    return row


def within(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple:
    """(all |got - want| <= tol * (1 + |want|) and finite, max |error|)."""
    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs()
    ok = bool((err <= tol * (1 + w.abs())).all()) and bool(
        torch.isfinite(g).all())
    return ok, float(err.max())


def bwd_cases(dims=FIRST_HEAD_DIMS):
    """(dtype, b, hq, hkv, s, d, causal, window) of the backward sweep at
    the head dims ``dims``: MHA, GQA and MQA, masks and lengths; gemma-2b's
    MQA group at D 256 and h2o-danube-3-4b's group and 4096 window at D 120;
    the training shapes."""
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in ((16, 16), (32, 8), (4, 1)):
            for d in dims:
                for causal, window in ((True, 0), (True, 100), (False, 0)):
                    for s in (128, 1000, 2048):
                        yield (dtype, 1 if s == 2048 else 2, hq, hkv, s, d,
                               causal, window)
        for s in (128, 1000, 2048):
            b = 1 if s == 2048 else 2
            if 256 in dims:
                yield (dtype, b, 8, 1, s, 256, True, 0)
            if 120 in dims:
                yield (dtype, b, 32, 8, s, 120, True, 4096)
        hq, hkv, d = GRANITE_GROUP
        for s in GRANITE_SWEEP_LENGTHS if d in dims else ():
            yield (dtype, 2, hq, hkv, s, d, True, 0)
        for shape in TRAIN_ATTN_SHAPES.values():
            if "sk" in shape or not shape.get("causal", True) or \
                    shape["d"] not in dims:
                continue                  # in cross_cases, or another pass
            yield (dtype, shape["b"], shape["h"], shape["hkv"], shape["s"],
                   shape["d"], True, shape["window"])


def compare_bwd(q, k, v, do, *, causal: bool, window: int) -> tuple:
    """dq, dk, dv of the kernels against ``flash_attention_bwd_ref`` and
    against PyTorch's autograd through ``flash_attention_ref``, on the plain
    forward's out and lse.  Returns (ok, max |error|)."""
    tol = GRAD_TOL[q.dtype]
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o, _ = ref.flash_attention_ref(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(o, leaves, do)
    ok, worst = True, 0.0
    for g, w, a in zip(got, want, auto):
        for oracle in (w, a):
            good, err = within(g, oracle, tol)
            ok &= good and g.dtype == q.dtype
            worst = max(worst, err)
    return ok, worst


def phase_kernel_bwd() -> list:
    gen = torch.Generator("cuda").manual_seed(1)
    cases = failures = 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dims, g in ((FIRST_HEAD_DIMS, gen), (LAST_HEAD_DIMS, later_gen())):
        for dtype, b, hq, hkv, s, d, causal, window in bwd_cases(dims):
            q, k, v = qkv(g, b, hq, hkv, s, d, dtype)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            ok, err = compare_bwd(q, k, v, do, causal=causal, window=window)
            name = str(dtype).split(".")[1]
            worst[name] = max(worst[name], err)
            cases += 1
            if not ok:
                failures += 1
                print(f"MISMATCH bwd dtype={name} b={b} hq={hq} hkv={hkv} "
                      f"d={d} causal={causal} window={window} s={s} "
                      f"err={err}", file=sys.stderr)
        for dtype, b, hq, hkv, sq, sk, d in cross_cases(dims):
            q, k, v = qkv(g, b, hq, hkv, sq, d, dtype, sk)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            ok, err = compare_bwd(q, k, v, do, causal=False, window=0)
            name = str(dtype).split(".")[1]
            worst[name] = max(worst[name], err)
            cases += 1
            if not ok:
                failures += 1
                print(f"MISMATCH bwd cross dtype={name} hq={hq} hkv={hkv} "
                      f"d={d} sq={sq} sk={sk} err={err}", file=sys.stderr)
    emit("kernel_check", kernel="flash_attention_bwd_dq+dkv", cases=cases,
         failures=failures, cross_lengths=CROSS_LENGTHS, max_abs_err=worst,
         tol={"float32": GRAD_TOL[torch.float32],
              "bfloat16": GRAD_TOL[torch.bfloat16]},
         oracles=["flash_attention_bwd_ref",
                  "autograd through flash_attention_ref"])
    if failures:
        raise AssertionError(f"the backward kernels disagree with their plain "
                             f"versions in {failures} of {cases} cases")

    rows = time_bwd(TRAIN_ATTN_SHAPES["d128"], gen)
    for name in ("d256", "d120", "d80", "d64", "enc", "cross", "d16"):
        for row, sub in zip(rows, time_bwd(TRAIN_ATTN_SHAPES[name], gen)):
            row[name] = {k: sub[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")}
    return rows


def sdpa_backward(q, k, v, do, hkv: int, causal: bool = True):
    """The yardstick: SDPA's flash backend (GQA and MQA through
    ``enable_gqa``, no copy of k and v) run forward once, then its backward
    under ``torch.autograd.grad``: dq, dk and dv together.  Timed here, never
    called by the port.  Where the flash backend refuses the shape, PyTorch's
    own choice of backend.  Returns (call, grads of one call, backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    gqa = hkv != q.shape[1]
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                 enable_gqa=gqa)
        backend = "flash"
    except RuntimeError:
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=gqa)
        backend = "default (flash refused the shape)"

    def call():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    return call, call(), backend


def time_bwd(shape: dict, gen) -> list:
    """Both backward kernels at a bf16 training shape (causal unless
    ``shape["causal"]`` says otherwise; ``shape["sk"]`` keys when given):
    checked against the plain version, then timed beside their bounds, the
    plain version and SDPA's backward.  Returns the dq and dkv rows."""
    b, h, hkv, s, d, window = (shape[x] for x in
                               ("b", "h", "hkv", "s", "d", "window"))
    causal, sk = shape.get("causal", True), shape.get("sk", s)
    q, k, v = qkv(gen, b, h, hkv, s, d, torch.bfloat16, sk)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    ok, err = compare_bwd(q, k, v, do, causal=causal, window=window)
    if not ok:
        raise AssertionError(f"training shape {shape}: backward error {err}")
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    delta = (do.float() * out.float()).sum(-1)
    dq_ms = time_ms(lambda: FA.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, causal=causal, window=window))
    dkv_ms = time_ms(lambda: FA.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, causal=causal, window=window))
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal, window), groups=11, per_group=5)
    # the yardstick computes the same function only where the window does
    # not cut the sequence
    assert window == 0 or window >= s, shape
    library, lib_grads, backend = sdpa_backward(q, k, v, do, hkv, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window)
    library_ok = all(within(g, w, GRAD_TOL[torch.bfloat16])[0]
                     for g, w in zip(lib_grads, want))
    library_ms = time_ms(library)

    mask = dict(itemsize=2, causal=causal, window=window)
    rows = []
    for name, products, (nbytes, flops), ms in (
            # q, k, v, dO, lse and delta read once; dq written once
            ("flash_attention_bwd_dq", 3,
             cost.flash_bwd_dq(b, h, hkv, s, sk, d, **mask), dq_ms),
            # the same read once; dk and dv written once
            ("flash_attention_bwd_dkv", 4,
             cost.flash_bwd_dkv(b, h, hkv, s, sk, d, **mask), dkv_ms)):
        tb = nbytes / MEM_BYTES_PER_S * 1e3
        to = flops / PEAK_FLOP_PER_S[torch.bfloat16] * 1e3
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                     "replaces": ("src/repro/kernels/flash_attention.py:118"
                                  if products == 3 else
                                  "src/repro/kernels/flash_attention.py:165"),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": library_ms})
        emit("kernel_time", kernel=name,
             shape=dict(shape, dtype="bfloat16", causal=causal, sk=sk),
             bytes=nbytes, flops=flops, bound_bytes_ms=tb, bound_ops_ms=to,
             **{k: rows[-1][k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
             plain="flash_attention_bwd_ref: dq, dk and dv together",
             library="scaled_dot_product_attention"
                     f"{' (enable_gqa)' if hkv != h else ''}, backend "
                     f"{backend}, backward under torch.autograd.grad: dq, dk "
                     "and dv together",
             library_agrees=library_ok,
             timing="median of 21 groups of 20 back-to-back calls, CUDA "
                    "events (plain: 11 groups of 5)")
    return rows


def merge_stage_shapes(cfg) -> list:
    """The 9 leaves of one 4-layer stage of the dense tower, sorted by key
    (the order of ``tree.leaves``)."""
    n = cfg.num_layers // TRAIN["stages"]
    d, ff = cfg.d_model, cfg.d_ff
    hq = cfg.num_heads * cfg.resolved_head_dim
    hkv = cfg.num_kv_heads * cfg.resolved_head_dim
    stage = {"attn": {"wq": (n, d, hq), "wk": (n, d, hkv), "wv": (n, d, hkv),
                      "wo": (n, hq, d)},
             "attn_norm": {"scale": (n, d)},
             "mlp": {"w_gate": (n, d, ff), "w_up": (n, d, ff),
                     "w_down": (n, ff, d)},
             "mlp_norm": {"scale": (n, d)}}
    return TR.leaves(stage)


def phase_kernel_merge() -> dict:
    gen = torch.Generator("cuda").manual_seed(2)
    shapes = [(5,), (8, 1024), (3, 65, 33), (8193,)]
    cases = failures = 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for ca, cb in ((1.0, 0.0), (0.0, 1.0), (0.5, 0.5)):
            xs = [torch.randn(sh, generator=gen, device="cuda").to(dtype)
                  for sh in shapes]
            ys = [torch.randn(sh, generator=gen, device="cuda").to(dtype)
                  for sh in shapes]
            got = ops.stage_merge(xs, ys, ca, cb)
            for x, y, g in zip(xs, ys, got):
                want = ref.stage_merge_ref(x, y, ca, cb)
                ok, err = within(g, want, MERGE_TOL[dtype])
                worst[str(dtype).split(".")[1]] = max(
                    worst[str(dtype).split(".")[1]], err)
                cases += 1
                failures += not ok
    # one real stage of the tower: 9 leaves, merged in place into a third
    cfg = get_config(TRAIN["arch"])
    shapes = merge_stage_shapes(cfg)
    numel = sum(math.prod(sh) for sh in shapes)
    xs = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
    ys = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
    outs = [torch.empty_like(x) for x in xs]
    w = torch.rand(2, generator=gen, device="cuda")
    ca, cb = w[0] / w.sum(), w[1] / w.sum()
    ops.stage_merge(xs, ys, ca, cb, out=outs)
    stage_err = 0.0
    for x, y, o in zip(xs, ys, outs):
        ok, err = within(o, ref.stage_merge_ref(x, y, ca, cb),
                         MERGE_TOL[torch.float32])
        stage_err = max(stage_err, err)
        cases += 1
        failures += not ok
    emit("kernel_check", kernel="stage_merge", cases=cases, failures=failures,
         max_abs_err=dict(worst, stage=stage_err),
         tol={"float32": MERGE_TOL[torch.float32],
              "bfloat16": MERGE_TOL[torch.bfloat16]})
    if failures:
        raise AssertionError(f"the merge kernel disagrees with its plain "
                             f"version in {failures} of {cases} cases")

    kernel_ms = time_ms(lambda: ops.stage_merge(xs, ys, ca, cb, out=outs),
                        groups=11, per_group=10)
    plain_ms = time_ms(lambda: [o.copy_(ref.stage_merge_ref(x, y, ca, cb))
                                for x, y, o in zip(xs, ys, outs)],
                       groups=11, per_group=5)
    # the yardstick: ca + cb == 1, so x + cb * (y - x) is the same function
    weight = cb.item()
    library_ms = time_ms(lambda: torch._foreach_lerp(xs, ys, weight),
                         groups=11, per_group=10)
    nbytes, flops = cost.stage_merge(numel)  # x, y read, out written, fp32
    tb = nbytes / MEM_BYTES_PER_S * 1e3
    to = flops / PEAK_FLOP_PER_S[torch.float32] * 1e3
    row = {"name": "stage_merge", "route": "cuda",
           "source": "src/repro_torch/csrc/stage_merge.cu",
           "replaces": "src/repro/kernels/stage_merge.py:23",
           "max_abs_err": max(stage_err, *worst.values()), "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": max(tb, to),
           "bound_by": "bytes" if tb >= to else "operations",
           "library_ms": library_ms}
    emit("kernel_time", kernel="stage_merge",
         shape={"arch": TRAIN["arch"], "stage_layers": 4, "leaves": len(shapes),
                "elements": numel, "dtype": "float32"},
         bytes=nbytes, flops=flops,
         **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
         library="torch._foreach_lerp over the stage's leaves",
         timing="median of 11 groups of 10 back-to-back calls, CUDA events "
                "(plain: 11 groups of 5)")
    return row


def adam_case(gen, shapes, tower, offset: int, grad_scale: float):
    """(p, g, m, v) leaves of ``shapes`` on the card, each ``offset``
    elements into a larger buffer (off its 16-byte boundary when odd)."""
    def leaves(scale, positive=False):
        out = []
        for sh in shapes:
            n = math.prod(sh)
            t = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
            out.append((t.abs() if positive else t).mul_(scale).view(sh))
        return out
    return (leaves(1.0), leaves(grad_scale), leaves(0.1),
            leaves(0.01, positive=True))


def adam_within(got, want, rel: bool) -> tuple:
    """(ok, max |error|, max |error| / |want|): within ``ADAM_SUMSQ_TOL``
    relative (``rel``) or ``ADAM_TOL * (1 + |w|)``."""
    err = (got - want).abs()
    bound = (ADAM_SUMSQ_TOL * want.abs() if rel
             else ADAM_TOL * (1 + want.abs()))
    if not err.numel():
        return True, 0.0, 0.0
    return (bool((err <= bound).all()) and bool(torch.isfinite(got).all()),
            float(err.max()), float((err / want.abs()).max()))


def adam_step_within(got, new, old) -> tuple:
    """(ok, max |error| / (|w_new - w_old| + ulps)): ``got`` within
    ``ADAM_STEP_TOL`` of the plain version's change ``new - old``."""
    err = (got - new).abs()
    scale = (new - old).abs() + ADAM_ULPS / ADAM_STEP_TOL * new.abs()
    ok = bool((err <= ADAM_STEP_TOL * scale + 1e-30).all()) and \
        bool(torch.isfinite(got).all())
    return ok, float((err / (scale + 1e-30)).max())


def phase_kernel_adam() -> tuple:
    """Both Adam kernels against their plain versions: a sweep of small
    leaf sets (tower and other leaves, ragged tails, misaligned views, weight
    decay, a clip that bites), then the whole tree of paper-llama-1.5b's
    gradients and state, where they are timed beside their bound, the plain
    versions and ``torch.optim.Adam(fused=True)`` (a yardstick, never on the
    path).  Returns the rows of the kernels line."""
    gen = torch.Generator("cuda").manual_seed(4)
    shapes = [(3, 16384), (3, 5, 7), (3, 33000), (3, 96), (1000, 24), (13,)]
    tower = [True, True, True, True, False, False]
    cases = failures = 0
    worst = {"adam_sumsq": 0.0, "adam_update": 0.0}
    worst_rel = 0.0                        # adam_sumsq, relative
    deterministic = True
    for offset in (0, 1, 2):
        for grad_scale, wd in ((1.0, 0.0), (100.0, 0.0), (1.0, 0.01)):
            cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                                  weight_decay=wd)
            p, g, m, v = adam_case(gen, shapes, tower, offset, grad_scale)
            got = AD.adam_sumsq(g, tower, 3)
            again = AD.adam_sumsq(g, tower, 3)
            want = ref.adam_sumsq_ref(g, tower, 3)
            deterministic &= all(torch.equal(a, b) for a, b in zip(got, again))
            for a, w in zip(got, want):
                ok, err, rel = adam_within(a, w, rel=True)
                worst["adam_sumsq"] = max(worst["adam_sumsq"], err)
                worst_rel = max(worst_rel, rel)
                cases += 1
                failures += not ok
            scalars = A.adam_scalars(cfg, torch.tensor(5, device="cuda"),
                                     torch.tensor(1.1, device="cuda"),
                                     got[1].sqrt())
            opts = A.update_options(cfg)
            outs = []
            for _ in range(2):
                pk, mk, vk = ([t.clone() for t in ts] for ts in (p, m, v))
                AD.adam_update(pk, g, mk, vk, scalars, **opts)
                outs.append(pk + mk + vk)
            ref.adam_update_ref(p, g, m, v, scalars, **opts)
            deterministic &= all(torch.equal(a, b) for a, b in zip(*outs))
            for a, w in zip(outs[0], p + m + v):
                ok, err, _ = adam_within(a, w, rel=False)
                worst["adam_update"] = max(worst["adam_update"], err)
                cases += 1
                failures += not ok

    # the main path's call: every leaf of paper-llama-1.5b, the moments at
    # the gradients' scale (m ~ g, v ~ g^2), a step past the warm-up
    cfg = get_config(TRAIN["arch"])
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    params = Model(cfg, device="cuda", weights=False).init(gen)
    part_tower = [path[0] == "blocks"
                  for path, _ in TR.leaves_with_path(params)]
    p = TR.leaves(params)

    def draw(t, square=False):
        x = torch.randn(t.shape, generator=gen, device="cuda") * 1e-3
        return x.square_() if square else x

    g = [draw(t) for t in p]
    m = [draw(t) for t in p]
    v = [draw(t, square=True) for t in p]
    numel = sum(t.numel() for t in p)
    got = AD.adam_sumsq(g, part_tower, cfg.num_layers)
    want = ref.adam_sumsq_ref(g, part_tower, cfg.num_layers)
    for a, w in zip(got, want):
        ok, err, rel = adam_within(a, w, rel=True)
        worst["adam_sumsq"] = max(worst["adam_sumsq"], err)
        worst_rel = max(worst_rel, rel)
        cases += 1
        failures += not ok
    scalars = A.adam_scalars(opt, torch.tensor(50, device="cuda"),
                             torch.tensor(1.0, device="cuda"), got[1].sqrt())
    opts = A.update_options(opt)
    pk, mk, vk = ([t.clone() for t in ts] for ts in (p, m, v))
    AD.adam_update(pk, g, mk, vk, scalars, **opts)
    olds = [t.clone() for t in p + m + v]
    ref.adam_update_ref(p, g, m, v, scalars, **opts)
    step_rel = 0.0
    for a, w, o in zip(pk + mk + vk, p + m + v, olds):
        ok, err, _ = adam_within(a, w, rel=False)
        good, rel = adam_step_within(a, w, o)
        worst["adam_update"] = max(worst["adam_update"], err)
        step_rel = max(step_rel, rel)
        cases += 1
        failures += not (ok and good)
    del pk, mk, vk, olds
    emit("kernel_check", kernel="adam", cases=cases, failures=failures,
         max_abs_err=worst, adam_sumsq_max_rel_err=worst_rel,
         adam_update_max_err_over_step=step_rel,
         main_path_scalars=scalars.tolist(),
         bit_deterministic=deterministic,
         tol={"adam_sumsq": f"{ADAM_SUMSQ_TOL} relative",
              "adam_update": f"{ADAM_TOL} * (1 + |w|)",
              "adam_update_main_path": f"also {ADAM_STEP_TOL} * |w_new - "
                                       f"w_old| + {ADAM_ULPS} * |w_new|"})
    if failures or not deterministic:
        raise AssertionError(f"the Adam kernels disagree with their plain "
                             f"versions in {failures} of {cases} cases "
                             f"(bit-deterministic: {deterministic})")

    timing = dict(groups=11, per_group=5)
    sumsq_ms = time_ms(lambda: AD.adam_sumsq(g, part_tower, cfg.num_layers),
                       **timing)
    sumsq_plain = time_ms(lambda: ref.adam_sumsq_ref(g, part_tower,
                                                     cfg.num_layers), **timing)
    update_ms = time_ms(lambda: AD.adam_update(p, g, m, v, scalars, **opts),
                        **timing)
    update_plain = time_ms(lambda: ref.adam_update_ref(p, g, m, v, scalars,
                                                       **opts), **timing)
    # the yardstick: PyTorch's fused Adam over the same parameters and
    # gradients (its own moments; no clipping, no norms)
    ps = [torch.nn.Parameter(t) for t in p]
    for t, grad in zip(ps, g):
        t.grad = grad
    fused = torch.optim.Adam(ps, lr=opt.lr, betas=opt.betas, eps=opt.eps,
                             fused=True)
    library_ms = time_ms(fused.step, **timing)
    del fused, ps
    rows = []
    for name, ms, plain_ms, nbytes, flops, lib, replaces in (
            ("adam_sumsq", sumsq_ms, sumsq_plain, *cost.adam_sumsq(numel),
             None, "src/repro/optim/adam.py:34"),
            ("adam_update", update_ms, update_plain,
             *cost.adam_update(numel), library_ms,
             "src/repro/optim/adam.py:64")):
        tb = nbytes / MEM_BYTES_PER_S * 1e3
        to = flops / PEAK_FLOP_PER_S[torch.float32] * 1e3
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/adam.cu",
                     "replaces": replaces,
                     "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": lib})
        emit("kernel_time", kernel=name,
             shape={"arch": TRAIN["arch"], "leaves": len(p),
                    "elements": numel, "dtype": "float32"},
             bytes=nbytes, flops=flops,
             **{k: rows[-1][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
             library=("torch.optim.Adam(fused=True).step over the same "
                      "parameters and gradients" if lib else None),
             replaces_note="no TPU kernel: jnp code that XLA fuses in the "
                           "jitted step",
             timing="median of 11 groups of 5 back-to-back calls, CUDA events")
    del params, p, g, m, v, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def ssd_inputs(gen, b, t, h, p, g, n, dtype, *, real: bool,
               init: bool = False, strided: bool = False,
               offset: int = 0) -> tuple:
    """(xb, a, bmat, cmat, init_state) for the SSD scan, model layout.

    ``real``: as a mamba2 layer makes them from ``init_mamba_block``'s
    parameters: dt = softplus(N(0, 1) + dt_bias) with softplus(dt_bias)
    log-uniform in [1e-3, 1e-1], A = -exp(a_log) = -linspace(1, 16, H),
    a = dt A (down to about -1.6 a token, so exp(cs_i - cs_j) above the
    diagonal overflows), xb = x dt.  Otherwise tests/test_kernels.py's draws:
    x 0.5 N(0, 1), a = -0.1 |N(0, 1)|, B and C 0.4 N(0, 1).  ``strided``: B
    and C are views of one (B, T, H P + offset + 2 G N) tensor, as the
    model's xBC, starting ``offset`` elements after x's columns (an offset
    that is not a multiple of 8 leaves their bf16 rows off 16-byte
    boundaries).
    """
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    if real:
        u = torch.rand(h, generator=gen, device="cuda")
        dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
        dt = F.softplus(randn(b, t, h) + dt_bias)
        a = dt * -torch.linspace(1.0, 16.0, h, device="cuda")
        xb = (randn(b, t, h, p) * dt[..., None]).to(dtype)
        scale = 1.0
    else:
        a = -randn(b, t, h).abs() * 0.1
        xb = randn(b, t, h, p, scale=0.5).to(dtype)
        scale = 0.4
    if strided:
        o = h * p + offset
        xbc = randn(b, t, o + 2 * g * n, scale=scale).to(dtype)
        bmat = xbc[..., o:o + g * n].reshape(b, t, g, n)
        cmat = xbc[..., o + g * n:].reshape(b, t, g, n)
    else:
        bmat = randn(b, t, g, n, scale=scale).to(dtype)
        cmat = randn(b, t, g, n, scale=scale).to(dtype)
    init_state = randn(b, h, p, n, scale=0.5) if init else None
    return xb, a, bmat, cmat, init_state


def compare_ssd(xb, a, bmat, cmat, init_state, chunk: int, *,
                token: bool = True, got=None) -> tuple:
    """The SSD kernel (or ``got``, its result) against the chunked plain
    version at the same chunk and, with ``token``, the token-by-token one:
    y within SSD_TOL * (1 + |w|), the final state within
    SSD_STATE_TOL * (1 + |w|), all finite.  Returns (ok, max |y error|,
    max |state error|)."""
    if got is None:
        got = SSD.ssd_scan(xb, a, bmat, cmat, chunk=chunk,
                           init_state=init_state)
    y, state = got
    wants = [ref.ssd_chunked(xb, a, bmat, cmat, chunk, init_state)]
    if token:
        wy, ws = ref.ssd_scan_ref(*(v.transpose(1, 2) for v in
                                    (xb, a, bmat, cmat)), init_state)
        wants.append((wy.transpose(1, 2), ws))
    ok, y_err, s_err = y.dtype == xb.dtype, 0.0, 0.0
    for wy, ws in wants:
        good, err = within(y, wy, SSD_TOL[xb.dtype])
        ok &= good
        y_err = max(y_err, err)
        good, err = within(state, ws, SSD_STATE_TOL)
        ok &= good
        s_err = max(s_err, err)
    return ok, y_err, s_err


def ssd_cases():
    """(dtype, shape, chunk, real, init, offset) of the SSD sweep; the
    offset is that of B and C in the xBC rows."""
    for dtype in (torch.float32, torch.bfloat16):
        # tests/test_kernels.py's sweep: B 2, P 16, N 8
        for t in (64, 128):
            for chunk in (16, 32, 64):
                for h, g in ((2, 1), (4, 2)):
                    yield (dtype, dict(b=2, t=t, h=h, p=16, g=g, n=8), chunk,
                           False, False, 0)
        # ragged T, a prime prompt's chunk of 1, wider P and N, a starting
        # state, and the real decay range
        for t, chunk in ((509, 64), (1000, 64), (509, 1), (100, 48)):
            for p, n in ((32, 16), (64, 64), (64, 128)):
                for init in (False, True):
                    yield (dtype, dict(b=2, t=t, h=4, p=p, g=2, n=n), chunk,
                           True, init, 0)
    # the bf16 tensor-core kernel: both serving widths cut in batch and
    # heads, P not a multiple of the block height, N not a multiple of the
    # tile, chunks of 1 and 48 with ragged ends, and B and C rows 8, 4 and 2
    # bytes off a 16-byte boundary
    bf16 = torch.bfloat16
    for n in (128, 64):
        for init in (False, True):
            yield (bf16, dict(b=2, t=512, h=8, p=64, g=1, n=n), 64, True,
                   init, 0)
    for p, n in ((48, 64), (20, 128), (32, 36), (4, 4)):
        yield (bf16, dict(b=2, t=200, h=4, p=p, g=2, n=n), 64, True, True, 0)
    for t, chunk in ((37, 1), (301, 48), (130, 48)):
        yield (bf16, dict(b=2, t=t, h=4, p=64, g=1, n=128), chunk, True,
               True, 0)
    for offset in (4, 2, 1):
        for n in (128, 36):
            yield (bf16, dict(b=2, t=150, h=4, p=64, g=1, n=n), 64, True,
                   False, offset)


def phase_kernel_ssd() -> dict:
    gen = torch.Generator("cuda").manual_seed(3)
    cases = failures = 0
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    for dtype, shp, chunk, real, init, offset in ssd_cases():
        inputs = ssd_inputs(gen, **shp, dtype=dtype, real=real, init=init,
                            strided=real, offset=offset)
        ok, y_err, s_err = compare_ssd(*inputs, chunk)
        name = str(dtype).split(".")[1]
        worst[name][0] = max(worst[name][0], y_err)
        worst[name][1] = max(worst[name][1], s_err)
        cases += 1
        if not ok:
            failures += 1
            print(f"MISMATCH ssd dtype={name} {shp} chunk={chunk} real={real} "
                  f"init={init} offset={offset} y={y_err} state={s_err}",
                  file=sys.stderr)

    # the carried state matters (tests/test_kernels.py:220): independent
    # scans of each chunk must differ from the full scan; two halves chained
    # through init_state must equal it
    x, a, bm, cm, _ = ssd_inputs(gen, 1, 64, 1, 8, 1, 4, torch.float32,
                                 real=False)
    full, full_state = SSD.ssd_scan(x, a, bm, cm, chunk=16)
    chopped = torch.cat([SSD.ssd_scan(x[:, i:i + 16], a[:, i:i + 16],
                                      bm[:, i:i + 16], cm[:, i:i + 16],
                                      chunk=16)[0] for i in range(0, 64, 16)],
                        dim=1)
    carry_gap = float((full - chopped).abs().max())
    y1, s1 = SSD.ssd_scan(x[:, :32], a[:, :32], bm[:, :32], cm[:, :32],
                          chunk=16)
    y2, s2 = SSD.ssd_scan(x[:, 32:], a[:, 32:], bm[:, 32:], cm[:, 32:],
                          chunk=16, init_state=s1)
    chained_ok, chained_err = within(torch.cat([y1, y2], dim=1), full,
                                     SSD_TOL[torch.float32])
    chained_ok &= within(s2, full_state, SSD_STATE_TOL)[0]
    cases += 2
    failures += (carry_gap <= 1e-3) + (not chained_ok)
    emit("kernel_check", kernel="ssd_scan", cases=cases, failures=failures,
         max_abs_err={k: {"y": v[0], "state": v[1]} for k, v in worst.items()},
         state_carry_gap=carry_gap, chained_halves_err=chained_err,
         tol={"float32": SSD_TOL[torch.float32],
              "bfloat16": SSD_TOL[torch.bfloat16], "state": SSD_STATE_TOL},
         oracles=["ref.ssd_chunked", "ref.ssd_scan_ref (token by token)"])
    if failures:
        raise AssertionError(f"the SSD kernel disagrees with its plain "
                             f"versions in {failures} of {cases} cases")

    # the serving shapes: one layer's prefill of each model, real decay,
    # B and C strided views of xBC
    shapes = {}
    for arch, shp in SSD_SERVE.items():
        xb, a, bm, cm, _ = ssd_inputs(gen, **shp, dtype=torch.bfloat16,
                                      real=True, strided=True)
        ok, y_err, s_err = compare_ssd(xb, a, bm, cm, None, SSD_CHUNK)
        if not ok:
            raise AssertionError(f"{arch} serving shape: y error {y_err}, "
                                 f"state error {s_err}")
        kernel_ms = time_ms(
            lambda: SSD.ssd_scan(xb, a, bm, cm, chunk=SSD_CHUNK))
        plain_ms = time_ms(lambda: ref.ssd_chunked(xb, a, bm, cm, SSD_CHUNK),
                           groups=11, per_group=5)
        nbytes, flops = cost.ssd_fwd(**shp, chunk=SSD_CHUNK)
        tb = nbytes / MEM_BYTES_PER_S * 1e3
        to = flops / PEAK_FLOP_PER_S[torch.bfloat16] * 1e3
        shapes[arch] = {"max_abs_err": y_err, "state_max_abs_err": s_err,
                        "ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": max(tb, to),
                        "bound_by": "bytes" if tb >= to else "operations",
                        "library_ms": None}
        emit("kernel_time", kernel="ssd_scan",
             shape=dict(shp, arch=arch, chunk=SSD_CHUNK, dtype="bfloat16"),
             bytes=nbytes, flops=flops, bound_bytes_ms=tb, bound_ops_ms=to,
             **shapes[arch], library="none: no single PyTorch call computes "
             "the SSD scan", timing="median of 21 groups of 20 back-to-back "
             "calls, CUDA events (plain: 11 groups of 5)")
    main_shape = shapes["mamba2-1.3b"]
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:22",
            **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "max_abs_err": max(v[0] for v in worst.values()),
            "shapes": shapes}


def ssd_bwd_cases():
    """(dtype, shape, chunk, real, init, offset) of the SSD backward's sweep:
    tests/test_kernels.py's SSD shapes, ragged chunks and a chunk of 1 at
    the widest P and N with the real decay, a starting state and dfinal,
    both training widths cut in batch and heads, and B and C rows off a
    16-byte boundary."""
    for dtype in (torch.float32, torch.bfloat16):
        for t in (64, 128):
            for chunk in (16, 32, 64):
                for h, g in ((2, 1), (4, 2)):
                    yield (dtype, dict(b=2, t=t, h=h, p=16, g=g, n=8), chunk,
                           False, False, 0)
        for t, chunk in ((509, 64), (37, 1), (100, 48)):
            for p, n in ((32, 16), (64, 128)):
                for init in (False, True):
                    yield (dtype, dict(b=2, t=t, h=4, p=p, g=2, n=n), chunk,
                           True, init, 0)
    for n, h in ((128, 8), (64, 10)):
        yield (torch.bfloat16, dict(b=2, t=512, h=h, p=64, g=1, n=n), 64,
               True, False, 0)
    for offset in (4, 1):
        yield (torch.bfloat16, dict(b=2, t=150, h=4, p=64, g=1, n=36), 64,
               True, True, offset)


def compare_ssd_bwd(xb, a, bmat, cmat, init_state, dy, dfinal,
                    chunk: int) -> tuple:
    """The SSD backward kernel against ``ssd_chunked_bwd_ref``: each
    gradient within GRAD_TOL * (1 + |w|), finite, in its dtype, and a second
    launch's bits equal to the first's.  Returns (ok, max |error|)."""
    got = SSD.ssd_scan_bwd(xb, a, bmat, cmat, dy, chunk=chunk,
                           init_state=init_state, dfinal=dfinal)
    again = SSD.ssd_scan_bwd(xb, a, bmat, cmat, dy, chunk=chunk,
                             init_state=init_state, dfinal=dfinal)
    want = ref.ssd_chunked_bwd_ref(xb, a, bmat, cmat, chunk, init_state, dy,
                                   dfinal)
    ok, worst = (got[4] is None) == (init_state is None), 0.0
    for g1, g2, w in zip(got, again, want):
        if g1 is None:
            continue
        good, err = within(g1, w, GRAD_TOL[xb.dtype])
        ok &= good and g1.dtype == w.dtype and torch.equal(g1, g2)
        worst = max(worst, err)
    return ok, worst


def phase_kernel_ssd_bwd() -> dict:
    gen = torch.Generator("cuda").manual_seed(4)
    cases = failures = 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, shp, chunk, real, init, offset in ssd_bwd_cases():
        xb, a, bm, cm, init_state = ssd_inputs(
            gen, **shp, dtype=dtype, real=real, init=init, strided=real,
            offset=offset)
        dy = torch.randn(xb.shape, generator=gen, device="cuda").to(dtype)
        dfinal = torch.randn(init_state.shape, generator=gen,
                             device="cuda") if init else None
        ok, err = compare_ssd_bwd(xb, a, bm, cm, init_state, dy, dfinal, chunk)
        name = str(dtype).split(".")[1]
        worst[name] = max(worst[name], err)
        cases += 1
        if not ok:
            failures += 1
            print(f"MISMATCH ssd_bwd dtype={name} {shp} chunk={chunk} "
                  f"real={real} init={init} offset={offset} err={err}",
                  file=sys.stderr)
    emit("kernel_check", kernel="ssd_scan_bwd", cases=cases,
         failures=failures, max_abs_err=worst,
         tol={"float32": GRAD_TOL[torch.float32],
              "bfloat16": GRAD_TOL[torch.bfloat16]},
         oracles=["ref.ssd_chunked_bwd_ref"],
         deterministic="two launches of every case compared bit for bit")
    if failures:
        raise AssertionError(f"the SSD backward disagrees with its plain "
                             f"version in {failures} of {cases} cases")

    # the training shapes: one layer's backward of each model
    shapes = {}
    for arch, shp in SSD_TRAIN.items():
        xb, a, bm, cm, _ = ssd_inputs(gen, **shp, dtype=torch.bfloat16,
                                      real=True, strided=True)
        dy = torch.randn(xb.shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        ok, err = compare_ssd_bwd(xb, a, bm, cm, None, dy, None, SSD_CHUNK)
        if not ok:
            raise AssertionError(f"{arch} training shape: backward error "
                                 f"{err}")
        kernel_ms = time_ms(lambda: SSD.ssd_scan_bwd(xb, a, bm, cm, dy,
                                                     chunk=SSD_CHUNK),
                            groups=11, per_group=5)
        plain_ms = time_ms(lambda: ref.ssd_chunked_bwd_ref(
            xb, a, bm, cm, SSD_CHUNK, None, dy, None), groups=5, per_group=3)
        nbytes, flops = cost.ssd_bwd(**shp, chunk=SSD_CHUNK)
        tb = nbytes / MEM_BYTES_PER_S * 1e3
        to = flops / PEAK_FLOP_PER_S[torch.bfloat16] * 1e3
        shapes[arch] = {"max_abs_err": err, "ms": kernel_ms,
                        "plain_ms": plain_ms, "bound_ms": max(tb, to),
                        "bound_by": "bytes" if tb >= to else "operations",
                        "library_ms": None}
        extra = {}
        if arch == "mamba2-1.3b":
            # the fp32 kernel (CUDA cores) on the same inputs in fp32: the
            # card-vs-CPU checks' path, never a training path's
            f32 = [v.float() for v in (xb, bm, cm, dy)]
            extra["check_path_f32_ms"] = time_ms(
                lambda: SSD.ssd_scan_bwd(f32[0], a, f32[1], f32[2], f32[3],
                                         chunk=SSD_CHUNK),
                groups=5, per_group=3)
            del f32
        emit("kernel_time", kernel="ssd_scan_bwd",
             shape=dict(shp, arch=arch, chunk=SSD_CHUNK, dtype="bfloat16"),
             bytes=nbytes, flops=flops, bound_bytes_ms=tb, bound_ops_ms=to,
             bound_fp32_ops_ms=flops / PEAK_FLOP_PER_S[torch.float32] * 1e3,
             **shapes[arch], times_bound=kernel_ms / max(tb, to), **extra,
             library="none: no PyTorch call computes the "
             "SSD scan's backward", plain="ref.ssd_chunked_bwd_ref",
             timing="median of 11 groups of 5 back-to-back calls, CUDA "
                    "events (plain and the fp32 check path: 5 groups of 3)")
        del xb, a, bm, cm, dy
    main_shape = shapes["mamba2-1.3b"]
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/models/ssm.py:52",
            "replaces_note": "no TPU kernel: JAX's autodiff of ssd_chunked",
            **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "max_abs_err": max(worst.values()), "shapes": shapes}


def pass_launches(cfg) -> tuple:
    """(attention, SSD) launches of each direction in one forward and
    backward pass of ``cfg``: a flash kernel a dense or VLM layer or a
    hybrid's shared-block application, three an encoder-decoder layer pair
    (the encoder's, the decoder's self- and cross-attention), an SSD kernel
    an SSM layer."""
    attention = {"dense": cfg.num_layers, "moe": cfg.num_layers,
                 "vlm": cfg.num_layers,
                 "encdec": cfg.num_encoder_layers + 2 * cfg.num_layers,
                 "hybrid": cfg.num_layers // max(cfg.attn_every, 1)}
    ssd = cfg.num_layers if cfg.arch_type in ("ssm", "hybrid") else 0
    return attention.get(cfg.arch_type, 0), ssd


def path_launches(cfg) -> dict:
    """The flash-forward and SSD launches that one prefill of ``cfg`` makes."""
    attention, ssd = pass_launches(cfg)
    return {"flash_attention_fwd": attention, "ssd_scan": ssd}


def phase_model() -> None:
    """Each family at full width cut to 2 layers (zamba2: the shared block
    after each; whisper: 2 encoder and 2 decoder layers over its 1500
    frames; internvl2: 256 patches before the prompt), fp32: prefill logits
    and the whole cache on the card (kernels) against the port on the CPU
    (plain versions)."""
    for arch, prompt, kw in MODEL_CHECKS:
        cfg = get_config(arch).replace(num_layers=2, dtype="float32", **kw)
        if cfg.param_count() > MODEL_DRAW_ON_CARD:
            # drawn on the card: the CPU's generator would take minutes
            drawn = Model(cfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
            params = TR.map(lambda t: t.detach().cpu(), drawn.params)
            del drawn
        else:
            params = Model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0)).params
        cpu = Model(cfg, params, device="cpu")
        card = Model(cfg, params, device="cuda")
        raw = SyntheticLM(cfg.vocab_size, seed=7).sample(
            np.random.default_rng(1), 1, prompt)
        batch = {k: torch.from_numpy(v)
                 for k, v in batch_for(cfg, raw).items() if k != "labels"}
        capacity = cfg.num_patches + prompt
        zero_counts()
        logits, cache = card.prefill({k: t.cuda() for k, t in batch.items()},
                                     capacity)
        torch.cuda.synchronize()
        launched = counts()
        want, want_cache = cpu.prefill(batch, capacity)
        err = float((logits.cpu() - want).abs().max())
        scale = float(want.abs().max())
        cache_err = max(float((cache[k].cpu().float()
                               - want_cache[k].float()).abs().max())
                        for k in want_cache if k != "pos")
        want_launches = {**dict.fromkeys(launched, 0), **path_launches(cfg)}
        emit("model", arch=cfg.name, layers=cfg.num_layers,
             d_model=cfg.d_model, **model_shape(cfg), dtype=cfg.dtype,
             batch=1, prompt=prompt,
             kernel_launches=launched, logits_max_abs_err=err,
             logits_max_abs=scale, cache_max_abs_err=cache_err, tol=MODEL_TOL)
        if launched != want_launches:
            raise AssertionError(f"{arch}: launches {launched}, want "
                                 f"{want_launches}")
        if not (math.isfinite(err) and err <= MODEL_TOL * (1 + scale)
                and cache_err <= MODEL_TOL):
            raise AssertionError(f"{arch} card vs CPU: logits {err}, cache "
                                 f"{cache_err}")
        del cpu, card, params, cache, want_cache
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(spec: dict, phase: str) -> dict:
    """Serve ``spec["arch"]`` at full width and depth: the counted run
    through ``generate`` (every kernel of the path must launch as often as
    ``path_launches`` says, no other kernel at all), then the prefill with
    the kernels against the prefill with the plain versions, and each kernel
    against its plain versions on the inputs the path gave it.  The
    encoder-decoder family takes its frames and the VLM its patches from
    the same seeded draw as the prompt; ``spec["layers"]`` cuts the depth.
    Returns the launch counts of the counted run and the largest errors."""
    cfg = train_model_config(spec)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    raw = SyntheticLM(cfg.vocab_size, seed=7).sample(
        np.random.default_rng(0), spec["batch"], spec["prompt"])
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in batch_for(cfg, raw).items() if k != "labels"}
    toks = batch["tokens"]
    generate(model, batch, new_tokens=2)                 # warm-up
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    res = generate(model, batch, new_tokens=spec["new_tokens"])
    launched = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # comparison runs, after the counted one: the prefill with the kernels,
    # recording what the path gives them, then with the plain versions
    capacity = cfg.num_patches + spec["prompt"] + spec["new_tokens"]
    ssd_seen, attn_seen = [], []
    ssd_kernel, fwd_kernel = SSD.ssd_scan, FA.flash_attention_fwd

    def ssd_recording(xb, a, bmat, cmat, *, chunk, init_state=None):
        got = ssd_kernel(xb, a, bmat, cmat, chunk=chunk, init_state=init_state)
        ssd_seen.append(((xb, a, bmat, cmat, init_state, chunk), got))
        return got

    def ssd_plain(xb, a, bmat, cmat, *, chunk, init_state=None):
        return ref.ssd_chunked(xb, a, bmat, cmat, chunk, init_state)

    def fwd_recording(q, k, v, *, causal, window):
        attn_seen.append((q, k, v, causal, window))
        return fwd_kernel(q, k, v, causal=causal, window=window)

    def fwd_plain(q, k, v, *, causal, window):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

    route_fn, routes = MOE.route, {"kernel": [], "plain": []}
    try:
        SSD.ssd_scan, FA.flash_attention_fwd = ssd_recording, fwd_recording
        MOE.route = recording_routes(route_fn, routes["kernel"])
        logits = model.prefill(batch, capacity)[0]
        SSD.ssd_scan, FA.flash_attention_fwd = ssd_plain, fwd_plain
        MOE.route = recording_routes(route_fn, routes["plain"])
        want = model.prefill(batch, capacity)[0]
    finally:
        SSD.ssd_scan, FA.flash_attention_fwd = ssd_kernel, fwd_kernel
        MOE.route = route_fn
    n_params = sum(p.numel() for p in model.parameters())
    moe = {}
    if cfg.arch_type == "moe":
        # the routing is discrete: a bf16 difference in the attention moves
        # the router's inputs, a choice flips, and the flip travels.  The
        # plain prefill again, its routing pinned to the kernel run's, is
        # the comparison the limit holds; the free-running one is reported
        try:
            FA.flash_attention_fwd = fwd_plain
            MOE.route = pinned_routes(route_fn, routes["kernel"])
            want_free = want
            want = model.prefill(batch, capacity)[0]
        finally:
            FA.flash_attention_fwd, MOE.route = fwd_kernel, route_fn
        drift = routing_drift(routes["kernel"], routes["plain"])
        drift.pop("clean")
        want_free = want_free.float().cpu()
        moe = {"routing_kernel_vs_plain": drift,
               "logits_vs_plain_free_max_abs_err": float(
                   (logits.float().cpu() - want_free).abs().max()),
               "logits_vs_plain_compared": "routing pinned to the kernel "
                                           "run's"}
    logits, want = logits.float().cpu(), want.float().cpu()
    logits_err = float((logits - want).abs().max())
    logits_scale = float(want.abs().max())
    first_ok = bool((logits[:, -1].argmax(-1).cpu().numpy()
                     == res.tokens[:, 0]).all())
    ssd_checked, ssd_fail, ssd_err, ssd_state_err = len(ssd_seen), 0, 0.0, 0.0
    token_layers = sorted({i % ssd_checked for i in SSD_TOKEN_LAYERS}) \
        if ssd_checked else []
    for i, ((xb, a, bmat, cmat, init_state, chunk), got) in enumerate(ssd_seen):
        ok, y_err, s_err = compare_ssd(xb, a, bmat, cmat, init_state, chunk,
                                       token=i in token_layers, got=got)
        ssd_fail += not ok
        ssd_err, ssd_state_err = max(ssd_err, y_err), max(ssd_state_err, s_err)
    ssd_seen.clear()
    attn_checked, attn_fail, attn_err, attn_lse_err = len(attn_seen), 0, 0.0, 0.0
    head_dims = sorted({q.shape[-1] for q, *_ in attn_seen})
    # the encoder's attentions run without a mask, the cross-attentions over
    # another key length (Sq != Sk)
    attn_full = sum(not causal for _, _, _, causal, _ in attn_seen)
    attn_cross = sum(q.shape[2] != k.shape[2] for q, k, *_ in attn_seen)
    for q, k, v, causal, window in attn_seen:
        ok, err, lse_err = compare(q, k, v, causal=causal, window=window,
                                   tol=SERVE_TOL)
        attn_fail += not ok
        attn_err, attn_lse_err = max(attn_err, err), max(attn_lse_err, lse_err)
    attn_seen.clear()
    if moe:
        # the fp32 reference needs the room: nothing of this run may stay
        # on the card but the prompt and the routing records (small blocks:
        # a tensor left in a large cached segment, such as a prefill's
        # cache, keeps the whole segment from going back)
        model = None
        gc.collect()
        torch.cuda.empty_cache()
        moe.update(moe_fp32_reference(cfg, toks, capacity, logits, want_free,
                                      routes["kernel"], routes["plain"],
                                      fwd_plain))

    want_launches = {**dict.fromkeys(launched, 0), **path_launches(cfg)}
    steps = spec["new_tokens"] - 1
    new = spec["batch"] * spec["new_tokens"]
    emit(phase, arch=cfg.name, layers=cfg.num_layers,
         layers_published=get_config(spec["arch"]).num_layers,
         d_model=cfg.d_model, **model_shape(cfg), vocab=cfg.vocab_size,
         dtype=cfg.dtype,
         params=n_params, batch=spec["batch"], prompt=spec["prompt"],
         new_tokens=spec["new_tokens"], capacity=capacity, init_s=init_s,
         init_peak_memory_gib=init_peak_gib,
         attention_launches_a_prefill=path_launches(cfg)[
             "flash_attention_fwd"],
         prefill_ms=res.prefill_s * 1e3,
         decode_ms_per_token=res.decode_s / steps * 1e3,
         decode_tokens_per_s=spec["batch"] * steps / res.decode_s,
         tokens_per_s=new / (res.prefill_s + res.decode_s),
         peak_memory_gib=peak_gib, launches=launched,
         first_tokens=res.tokens[0, :8].tolist(),
         first_token_is_prefill_argmax=first_ok,
         logits_vs_plain_max_abs_err=logits_err, logits_max_abs=logits_scale,
         logits_tol=SERVE_LOGITS_TOL, ssd_inputs_checked=ssd_checked,
         ssd_token_by_token_layers=token_layers, ssd_failures=ssd_fail,
         ssd_max_abs_err=ssd_err, ssd_state_max_abs_err=ssd_state_err,
         ssd_tol={"y": SSD_TOL[torch.bfloat16], "state": SSD_STATE_TOL},
         attention_inputs_checked=attn_checked, attention_head_dims=head_dims,
         attention_inputs_full=attn_full, attention_inputs_cross=attn_cross,
         attention_failures=attn_fail, attention_max_abs_err=attn_err,
         attention_lse_max_abs_err=attn_lse_err, attention_tol=SERVE_TOL,
         **moe)
    problems = []
    if launched != want_launches:
        problems.append(f"launches {launched}, want {want_launches}")
    if attn_checked != want_launches["flash_attention_fwd"] or (
            attn_checked and head_dims != [cfg.resolved_head_dim]):
        problems.append(f"{attn_checked} attention inputs, head dims "
                        f"{head_dims}")
    if ssd_checked != want_launches["ssd_scan"]:
        problems.append(f"{ssd_checked} SSD inputs")
    if cfg.arch_type == "encdec" and (
            attn_cross != cfg.num_layers
            or attn_full != cfg.num_encoder_layers + cfg.num_layers):
        problems.append(f"{attn_full} full attentions, {attn_cross} over "
                        "another key length")
    if moe and moe["routing_kernel_vs_plain"]["layers"] != cfg.num_layers:
        problems.append(f"routing of {moe['routing_kernel_vs_plain']} "
                        "layers recorded")
    if res.tokens.shape != (spec["batch"], spec["new_tokens"]) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        problems.append(f"bad generation {res.tokens.shape}")
    if not first_ok:
        problems.append("the first generated tokens are not the argmax of "
                        "the prefill logits")
    if not (math.isfinite(logits_err)
            and logits_err <= SERVE_LOGITS_TOL * logits_scale):
        problems.append(f"prefill with the kernels vs the plain versions: "
                        f"logits {logits_err} of {logits_scale}")
    if moe and not all(
            math.isfinite(e) and e <= SERVE_LOGITS_TOL
            * moe["fp32_logits_max_abs"]
            for e in moe["vs_fp32_pinned_max_abs_err"].values()):
        problems.append(f"the bf16 prefills vs the fp32 one, routing pinned "
                        f"to its: {moe['vs_fp32_pinned_max_abs_err']} of "
                        f"{moe['fp32_logits_max_abs']}")
    if ssd_fail or attn_fail:
        problems.append(f"kernels vs plain versions on the path's inputs: "
                        f"{ssd_fail} SSD, {attn_fail} attention failures")
    del model, res
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"{phase}: " + "; ".join(problems))
    return {"launches": launched, "ssd_err": ssd_err, "attn_err": attn_err}


def moe_fp32_reference(cfg, toks, capacity: int, kernel_logits,
                       plain_logits, kernel_routes: list, plain_routes: list,
                       fwd_plain) -> dict:
    """An fp32 prefill with the plain attention on the bf16 model's own
    weights (the seeded draws, each rounded to bf16 and held in fp32: the
    bf16 model is freed first, since deepseek-moe-16b's fp32 tree, 67.5 GB,
    would not fit beside it), then the bf16 model again with the kernel and
    with the plain attention, both pinned to the fp32 run's routing.
    Returns each bf16 prefill's distance to the fp32 one (free-running and
    pinned) and the routing drift of each free-running bf16 run from it."""
    cfg32 = cfg.replace(dtype="float32")
    allocated_gib = torch.cuda.memory_allocated() / 2 ** 30
    tree = Model(cfg32, device="cuda", weights=False).init(
        torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        for leaf in TR.leaves(tree):
            for part in (leaf.unbind(0) if leaf.dim() > 1 else (leaf,)):
                part.copy_(part.to(torch.bfloat16))
    model32 = Model(cfg32, tree, device="cuda")
    del tree
    route_fn, fwd_kernel = MOE.route, FA.flash_attention_fwd
    fp32_routes, out = [], {}
    try:
        FA.flash_attention_fwd = fwd_plain
        MOE.route = recording_routes(route_fn, fp32_routes)
        ref32 = model32.prefill({"tokens": toks}, capacity)[0].float().cpu()
    finally:
        FA.flash_attention_fwd, MOE.route = fwd_kernel, route_fn
    del model32
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(0))
    for name, fwd in (("kernel", fwd_kernel), ("plain", fwd_plain)):
        try:
            FA.flash_attention_fwd = fwd
            MOE.route = pinned_routes(route_fn, fp32_routes)
            out[name] = model.prefill({"tokens": toks},
                                      capacity)[0].float().cpu()
        finally:
            FA.flash_attention_fwd, MOE.route = fwd_kernel, route_fn
    del model
    gc.collect()
    torch.cuda.empty_cache()

    def err(x):
        return float((x - ref32).abs().max())

    drift = {}
    for name, routes in (("kernel", kernel_routes), ("plain", plain_routes)):
        drift[name] = routing_drift(routes, fp32_routes)
        drift[name].pop("clean")
    return {"fp32_allocated_gib_before": allocated_gib,
            "fp32_logits_max_abs": float(ref32.abs().max()),
            "vs_fp32_free_max_abs_err": {"kernel": err(kernel_logits),
                                         "plain": err(plain_logits)},
            "vs_fp32_pinned_max_abs_err": {"kernel": err(out["kernel"]),
                                           "plain": err(out["plain"])},
            "routing_vs_fp32": drift}


def decisions(topi: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each token's routing in one MoE layer, comparable across runs: its
    top-k experts and its kept experts (a drop reads as -1), each sorted ->
    (G, T, 2k)."""
    kept = torch.where(keep, topi, -1)
    return torch.cat([topi.sort(-1).values, kept.sort(-1).values], -1)


def recording_routes(route_fn, into: list):
    """``MOE.route`` that also appends each layer's (topi, keep), copied to
    the host: ``topi`` is a view of the router's whole sort, which would
    keep a block of every layer, and the segment it lies in, on the card."""
    def recorded(p, xg, cfg, cap):
        r = route_fn(p, xg, cfg, cap)
        into.append((r.topi.cpu(), r.keep.cpu()))
        return r
    return recorded


def pinned_routes(route_fn, pinned: list):
    """``MOE.route`` that takes each layer's choices from another run's
    record (``pinned``: (topi, keep) a layer, in order) and weighs them by
    this run's own gates; the slots follow from the choices.  Two prefills
    pinned to one routing compute the same function up to rounding: what
    differs between them is the attention, not a discrete choice."""
    layers = iter(pinned)

    def routed(p, xg, cfg, cap):
        r = route_fn(p, xg, cfg, cap)
        topi = next(layers)[0].to(r.gates.device)
        topv = torch.gather(r.gates, -1, topi)
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
        pos, keep = MOE.slots(topi, cfg.moe.num_experts, cap)
        return MOE.Routing(r.gates, topv, topi, pos, keep)
    return routed


def routing_drift(a: list, b: list) -> dict:
    """Two runs' routing, layer by layer ((topi, keep) each): the (token,
    layer) decisions whose top-k set or kept set differ, their count and
    share, and ``clean``: a (G, T) mask of the tokens whose own routing and
    whose group's earlier tokens' routing agreed in every layer."""
    differ = torch.stack([(decisions(*x) != decisions(*y)).any(-1)
                          for x, y in zip(a, b)])
    clean = ~(differ.any(0).int().cumsum(-1) > 0)
    n = int(differ.numel())
    return {"layers": len(a), "decisions": n,
            "differ": int(differ.sum()),
            "differ_share": float(differ.sum()) / max(n, 1),
            "tokens_clean": int(clean.sum()), "tokens": int(clean.numel()),
            "clean": clean}


def phase_model_moe() -> None:
    """granite-moe-3b-a800m and deepseek-moe-16b at full width cut to 2
    layers, fp32: the full-sequence logits on the card (flash kernels, the
    index-form MoE on the card) against the port on the CPU, held on the
    tokens whose routing agreed (MOE_ROUTE_DIFF_MAX says why)."""
    for arch, prompt in MOE_MODEL_CHECKS:
        cfg = get_config(arch).replace(num_layers=2, dtype="float32")
        params = Model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0)).params
        cpu = Model(cfg, params, device="cpu")
        card = Model(cfg, params, device="cuda")
        raw = SyntheticLM(cfg.vocab_size, seed=7).sample(
            np.random.default_rng(1), MOE_MODEL_BATCH, prompt)
        toks = torch.from_numpy(batch_for(cfg, raw)["tokens"])
        route_fn, routes = MOE.route, {"card": [], "cpu": []}
        try:
            MOE.route = recording_routes(route_fn, routes["card"])
            zero_counts()
            logits, aux = card.apply({"tokens": toks.cuda()})
            torch.cuda.synchronize()
            launched = counts()
            MOE.route = recording_routes(route_fn, routes["cpu"])
            want, want_aux = cpu.apply({"tokens": toks})
        finally:
            MOE.route = route_fn
        drift = routing_drift(routes["card"], routes["cpu"])
        clean = drift.pop("clean").reshape(-1)
        got = logits.cpu().reshape(-1, cfg.vocab_size)[clean]
        ref_rows = want.reshape(-1, cfg.vocab_size)[clean]
        err = float((got - ref_rows).abs().max()) if clean.any() \
            else float("nan")
        scale = float(want.abs().max())
        aux_err = abs(float(aux) - float(want_aux))
        want_launches = {**dict.fromkeys(launched, 0), **path_launches(cfg)}
        emit("model", arch=cfg.name, layers=cfg.num_layers,
             d_model=cfg.d_model, **model_shape(cfg), dtype=cfg.dtype,
             experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
             shared_experts=cfg.moe.num_shared_experts,
             batch=MOE_MODEL_BATCH, prompt=prompt, kernel_launches=launched,
             routing_card_vs_cpu=drift, route_differ_max=MOE_ROUTE_DIFF_MAX,
             logits_rows_checked=int(clean.sum()),
             logits_max_abs_err=err, logits_max_abs=scale, aux=float(aux),
             aux_abs_err=aux_err, tol=MODEL_TOL)
        if launched != want_launches:
            raise AssertionError(f"{arch}: launches {launched}, want "
                                 f"{want_launches}")
        if drift["differ_share"] > MOE_ROUTE_DIFF_MAX or not clean.any():
            raise AssertionError(f"{arch} card vs CPU: routing {drift}")
        if not (math.isfinite(err) and err <= MODEL_TOL * (1 + scale)):
            raise AssertionError(f"{arch} card vs CPU: logits {err} on "
                                 f"{int(clean.sum())} rows")
        if drift["differ"] == 0 and aux_err > MODEL_TOL:
            raise AssertionError(f"{arch} card vs CPU: aux {aux_err}")
        del cpu, card, params, logits, want


class Forced:
    """A failure schedule of fixed events: ``{wall_step: [stages]}``."""

    def __init__(self, events: dict):
        self.events = events

    def at(self, step: int) -> list:
        return list(self.events.get(step, []))


class PlainAttention:
    """Stands in for ``FA.FlashAttention`` so that the model runs the plain
    attention (autograd through ``ref.flash_attention_ref``) on the card."""

    @staticmethod
    def apply(q, k, v, causal, window):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)[0]


def plain_ssd(xb, a, bmat, cmat, *, chunk, init_state=None):
    """Stands in for ``ops.ssd_scan`` so that the model runs the plain chunked
    scan (autograd through ``ref.ssd_chunked``) on the card."""
    return ref.ssd_chunked(xb, a, bmat, cmat, chunk, init_state)


def train_config(strategy: str, steps: int, *, stages: int, batch: int,
                 seq: int, window: int = 1, **rcfg) -> TrainConfig:
    rcfg = {"protect_edge_stages": False, **rcfg}
    return TrainConfig(
        global_batch=batch, microbatch=batch, seq_len=seq, steps=steps,
        eval_every=steps, fuse_window=window, seed=0,
        optimizer=OptimizerConfig(total_steps=steps),
        recovery=RecoveryConfig(strategy=strategy, num_stages=stages, **rcfg))


def counts() -> dict:
    return ops.launch_counts()


def zero_counts() -> None:
    FA.launches = FA.launches_dq = FA.launches_dkv = SM.launches = 0
    SSD.launches = SSD.launches_bwd = 0
    SSD.launches_bwd_path.update(bf16=0, f32=0)
    AD.launches_sumsq = AD.launches_update = 0


def phase_train_model() -> None:
    """Two Adam steps of 2 full-width fp32 layers on the card and the CPU."""
    cfg = get_config(TRAIN["arch"]).replace(num_layers=2, dtype="float32")
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tcfg = train_config("checkfree", 2, stages=2, batch=1, seq=128)
    result = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(Model(cfg, device=device, weights=False), tcfg)
        state, hist = trainer.run(make_batches(cfg, batch=1, seq=128, seed=0),
                                  params=TR.clone(params))
        result[device] = (hist.loss, TR.map(lambda t: t.detach().cpu(),
                                            state.params))
        del trainer, state
    (card_loss, card_p), (cpu_loss, cpu_p) = result["cuda"], result["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(card_loss, cpu_loss))
    ok = all(math.isfinite(x) for x in card_loss) and all(
        abs(a - b) <= TRAIN_MODEL_TOL * (1 + abs(b))
        for a, b in zip(card_loss, cpu_loss))
    param_err = 0.0
    for a, b in zip(TR.leaves(card_p), TR.leaves(cpu_p)):
        good, err = within(a, b, TRAIN_MODEL_TOL)
        ok &= good
        param_err = max(param_err, err)
    emit("train_model", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, batch=1, seq=128, steps=2,
         loss_card=card_loss, loss_cpu=cpu_loss, loss_max_abs_err=loss_err,
         params_max_abs_err=param_err, tol=TRAIN_MODEL_TOL)
    if not ok:
        raise AssertionError(f"training on the card vs the CPU: loss "
                             f"{loss_err}, parameters {param_err}")


def instrument(trainer: Trainer, record: dict) -> None:
    """Time each step (host clock ending in a synchronize) and keep its loss
    and omegas; time each recovery."""
    step = trainer.step
    time_recoveries(trainer, record)

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss, metrics = step(state, batch)
        torch.cuda.synchronize()
        record["step_ms"].append((time.perf_counter() - t0) * 1e3)
        record["omegas"].append(state.omegas.cpu())
        record.setdefault("grad_norm", []).append(float(metrics["grad_norm"]))
        record.setdefault("aux", []).append(float(metrics["aux"]))
        return state, loss, metrics

    trainer.step = timed_step


def time_recoveries(trainer: Trainer, record: dict) -> None:
    """Time each call of the strategy's failure handlers (host clock ending
    in a synchronize) into ``record["recovery_ms"]``, and into
    ``record["recovery_device"]`` its device ms (CUDA events) and the
    caching allocator's new device allocations (``num_device_alloc``)."""
    record.setdefault("recovery_device", [])
    for name in ("handle_failure", "handle_consecutive", "handle_departure"):
        handle = getattr(trainer.strategy, name)

        def timed(*args, _handle=handle, _name=name):
            torch.cuda.synchronize()
            allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = _handle(*args)
            end.record()
            torch.cuda.synchronize()
            record["recovery_ms"].append(
                (_name, args[-1].wall_step, (time.perf_counter() - t0) * 1e3))
            record["recovery_device"].append({
                "wall_step": args[-1].wall_step,
                "device_ms": start.elapsed_time(end),
                "device_allocs": torch.cuda.memory_stats().get(
                    "num_device_alloc", 0) - allocs})
            return out

        setattr(trainer.strategy, name, timed)


def check_first_merge(trainer: Trainer, wall_step: int, stage: int,
                      record: dict) -> None:
    """Around the merge at ``wall_step``: the recovered stage must equal
    ``stage_merge_ref`` of its neighbours taken before it, with the omega
    weights, its Adam moments must be zero and the lr scale boosted."""
    handle = trainer.strategy.handle_failure
    part = trainer.part

    def checked(state, event):
        if event.wall_step != wall_step or event.stage != stage:
            return handle(state, event)
        prev = TR.clone(part.get_stage(state.params, stage - 1))
        nxt = TR.clone(part.get_stage(state.params, stage + 1))
        wa = state.omegas[stage - 1].float()
        wb = state.omegas[stage + 1].float()
        denom = wa + wb + 1e-30
        ca, cb = wa / denom, wb / denom
        lr_before = state.lr_scale
        state = handle(state, event)
        err, ok = 0.0, True
        for x, y, got in zip(TR.leaves(prev), TR.leaves(nxt),
                             TR.leaves(part.get_stage(state.params, stage))):
            good, e = within(got, ref.stage_merge_ref(x, y, ca, cb),
                             MERGE_TOL[torch.float32])
            ok &= good
            err = max(err, e)
        moments = max(float(leaf.abs().max()) for tree in
                      (state.opt_state.m, state.opt_state.v)
                      for leaf in TR.leaves(part.get_stage(tree, stage)))
        record["merge_check"] = {
            "wall_step": wall_step, "stage": stage, "max_abs_err": err,
            "ca": float(ca), "cb": float(cb), "moments_max_abs": moments,
            "lr_scale_before": lr_before, "lr_scale": state.lr_scale}
        if not ok or moments != 0.0 or abs(state.lr_scale - 1.1) > 1e-6:
            raise AssertionError(f"step-{wall_step} recovery of stage {stage}: "
                                 f"{record['merge_check']}")
        return state

    trainer.strategy.handle_failure = checked


def train_model_config(spec: dict):
    """The model config of a training spec, cut to ``spec["layers"]``."""
    cfg = get_config(spec["arch"])
    return cfg.replace(num_layers=spec["layers"]) if "layers" in spec else cfg


def train_run(strategy: str, steps: int, schedule, *, spec: dict = TRAIN,
              check_merge=None, plain: bool = False, rcfg=None,
              setup=None, window: int = 1) -> tuple:
    """One full-width run from the trainer's seeded initial parameters ->
    (hist, launch counts, record, peak GiB).  ``rcfg``: more recovery
    settings; ``setup(trainer, record)`` installs a phase's own checks;
    ``window``: the fuse window (1: eager steps); ``plain``: the model's
    attention and SSD scan run their plain versions."""
    cfg = train_model_config(spec)
    model = Model(cfg, device="cuda", weights=False)
    trainer = Trainer(model, train_config(strategy, steps,
                                          stages=spec["stages"],
                                          batch=spec["batch"],
                                          seq=spec["seq"], window=window,
                                          **(rcfg or {})),
                      schedule=schedule)
    record = {"step_ms": [], "omegas": [], "recovery_ms": []}
    instrument(trainer, record)
    if check_merge is not None:
        check_first_merge(trainer, *check_merge, record)
    if setup is not None:
        setup(trainer, record)
    batches = make_batches(cfg, batch=spec["batch"], seq=spec["seq"], seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel, ssd_kernel = FA.FlashAttention, ops.ssd_scan
    if plain:
        FA.FlashAttention, ops.ssd_scan = PlainAttention, plain_ssd
    try:
        zero_counts()
        state, hist = trainer.run(batches)
        torch.cuda.synchronize()
        launched = counts()
    finally:
        FA.FlashAttention, ops.ssd_scan = kernel, ssd_kernel
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    record["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2 ** 30
    del trainer, state
    gc.collect()                     # the instrumented trainer holds a cycle
    torch.cuda.empty_cache()
    return hist, launched, record, peak


def check_run(name: str, hist, launched: dict, *, steps: int, halves: int,
              merges: int, schedule: dict, spec: dict = TRAIN) -> None:
    cfg = train_model_config(spec)
    attention, ssd = (n * halves * steps for n in pass_launches(cfg))
    want = {"flash_attention_fwd": attention,
            "flash_attention_bwd_dq": attention,
            "flash_attention_bwd_dkv": attention, "stage_merge": merges,
            "ssd_scan": ssd, "ssd_scan_bwd": ssd, "adam_sumsq": steps,
            "adam_update": steps}
    failures = [(s, st) for s in sorted(schedule) for st in schedule[s]]
    problems = []
    if len(hist.loss) != steps or not all(math.isfinite(x) for x in hist.loss):
        problems.append(f"losses {hist.loss}")
    if launched != want:
        problems.append(f"launches {launched}, want {want}")
    if SSD.launches_bwd_path["f32"]:
        problems.append(f"the SSD backward ran its fp32 kernel "
                        f"{SSD.launches_bwd_path['f32']} times")
    if [tuple(f) for f in hist.failures] != failures:
        problems.append(f"failures {hist.failures}, want {failures}")
    if len(hist.recovery_errors) != len(failures) or not all(
            math.isfinite(e) for _, e in hist.recovery_errors):
        problems.append(f"recovery errors {hist.recovery_errors}")
    if problems:
        raise AssertionError(f"{name}: " + "; ".join(problems))


def check_backward_on_path(spec: dict = TRAIN,
                           strategy: str = "checkfree_plus") -> float:
    """The backward kernels against their plain versions on the inputs that
    one full-width ``strategy`` step gives them (``checkfree_plus``: in both
    stage orders), as the serve phases check the forward on the prefill's
    own inputs: each attention application's q, k, v, out, lse and dO, and
    each SSM layer's xb, a, B, C and dy (the SSD backward, checked as it
    runs, so that no layer's inputs are kept).  Returns the SSD backward's
    largest error."""
    cfg = train_model_config(spec)
    trainer = Trainer(Model(cfg, device="cuda", weights=False),
                      train_config(strategy, 1, stages=spec["stages"],
                                   batch=spec["batch"], seq=spec["seq"]))
    seen = []
    ssd = {"calls": 0, "failures": 0, "max_abs_err": 0.0}
    kernel, ssd_kernel = FA.flash_attention_bwd, SSD.ssd_scan_bwd

    def recording(q, k, v, out, lse, do, *, causal, window):
        got = kernel(q, k, v, out, lse, do, causal=causal, window=window)
        seen.append(((q, k, v, out, lse, do, causal, window), got))
        return got

    def ssd_checking(xb, a, bmat, cmat, dy, *, chunk, init_state=None,
                     dfinal=None):
        got = ssd_kernel(xb, a, bmat, cmat, dy, chunk=chunk,
                         init_state=init_state, dfinal=dfinal)
        want = ref.ssd_chunked_bwd_ref(xb, a, bmat, cmat, chunk, init_state,
                                       dy, dfinal)
        for g, w in zip(got[:4], want[:4]):
            ok, err = within(g, w, GRAD_TOL[xb.dtype])
            ssd["failures"] += not ok
            ssd["max_abs_err"] = max(ssd["max_abs_err"], err)
        ssd["calls"] += 1
        return got

    FA.flash_attention_bwd, SSD.ssd_scan_bwd = recording, ssd_checking
    try:
        batch = next(make_batches(cfg, batch=spec["batch"], seq=spec["seq"],
                                  seed=0))
        trainer.step(trainer.init_state(), trainer.device_batch(batch))
        torch.cuda.synchronize()
    finally:
        FA.flash_attention_bwd, SSD.ssd_scan_bwd = kernel, ssd_kernel
    failures, worst = 0, 0.0
    for (q, k, v, out, lse, do, causal, window), got in seen:
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                           window)
        for g, w in zip(got, want):
            ok, err = within(g, w, GRAD_TOL[q.dtype])
            failures += not ok
            worst = max(worst, err)
    calls = len(seen)
    head_dims = sorted({q.shape[-1] for (q, *_), _ in seen})
    cross = sum(q.shape[2] != k.shape[2] for (q, k, *_), _ in seen)
    emit("train_backward_inputs", arch=cfg.name, strategy=strategy,
         calls=calls, calls_over_another_key_length=cross,
         head_dims=head_dims, failures=failures,
         max_abs_err=worst, tol=GRAD_TOL[torch.bfloat16],
         ssd_calls=ssd["calls"], ssd_failures=ssd["failures"],
         ssd_max_abs_err=ssd["max_abs_err"])
    del trainer, seen
    gc.collect()
    torch.cuda.empty_cache()
    halves = 2 if strategy == "checkfree_plus" else 1
    attention, ssd_layers = pass_launches(cfg)
    cross_want = halves * cfg.num_layers if cfg.arch_type == "encdec" else 0
    if calls != halves * attention or failures or cross != cross_want or \
            head_dims != ([cfg.resolved_head_dim] if attention else []):
        raise AssertionError(f"the backward kernels on {calls} training-path "
                             f"inputs ({cross} over another key length) at "
                             f"head dims {head_dims}: {failures} outputs "
                             "disagree with the plain version")
    if ssd["calls"] != halves * ssd_layers or ssd["failures"]:
        raise AssertionError(f"the SSD backward on {ssd['calls']} training-"
                             f"path inputs: {ssd['failures']} outputs "
                             "disagree with the plain version")
    return ssd["max_abs_err"]


def train_vs_plain(spec: dict, strategy: str, kernel_losses: list = None,
                   kernel_omegas: list = None) -> None:
    """The first two (failure-free) steps again with the plain attention
    and SSD scan, against the same steps with the kernels (run here at
    ``spec``'s shape when not given)."""
    if kernel_losses is None:
        hist, _, record, _ = train_run(strategy, 2, None, spec=spec)
        kernel_losses, kernel_omegas = hist.loss, record["omegas"]
    plain_hist, plain_launched, plain_record, _ = train_run(
        strategy, 2, None, spec=spec, plain=True)
    loss_err = [abs(a - b) / abs(b) for a, b in zip(kernel_losses,
                                                    plain_hist.loss)]
    omega_err = [float(((a - b).abs() / b.abs()).max())
                 for a, b in zip(kernel_omegas, plain_record["omegas"])]
    emit("train_vs_plain", arch=spec["arch"], strategy=strategy, steps=2,
         batch=spec["batch"],
         loss_kernel=kernel_losses, loss_plain=plain_hist.loss,
         loss_rel_err=loss_err,
         omegas_kernel=[o.tolist() for o in kernel_omegas],
         omegas_plain=[o.tolist() for o in plain_record["omegas"]],
         omega_rel_err=omega_err, loss_tol=TRAIN_LOSS_TOL,
         omega_tol=TRAIN_OMEGA_TOL, plain_launches=plain_launched)
    if any(plain_launched[k] for k in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "ssd_scan", "ssd_scan_bwd")):
        raise AssertionError(f"the plain run launched kernels: "
                             f"{plain_launched}")
    if max(loss_err) > TRAIN_LOSS_TOL or max(omega_err) > TRAIN_OMEGA_TOL:
        raise AssertionError(f"{spec['arch']}: kernels vs plain attention: "
                             f"loss {loss_err}, omegas {omega_err}")


def phase_train() -> dict:
    cfg = get_config(TRAIN["arch"])
    tokens = TRAIN["batch"] * TRAIN["seq"]

    hist, launched, record, peak = train_run(
        "checkfree_plus", PLUS_STEPS, Forced(PLUS_SCHEDULE),
        check_merge=(2, 3))
    check_run("checkfree_plus", hist, launched, steps=PLUS_STEPS, halves=2,
              merges=PLUS_MERGES, schedule=PLUS_SCHEDULE)
    free = [i for i in range(PLUS_STEPS) if i not in PLUS_SCHEDULE]
    step_ms = float(np.median([record["step_ms"][i] for i in free]))
    merge_ms = [ms for name, step, ms in record["recovery_ms"] if step == 2]
    emit("train", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         stages=TRAIN["stages"], params=cfg.param_count(), dtype=cfg.dtype,
         masters="float32", strategy="checkfree_plus", batch=TRAIN["batch"],
         seq=TRAIN["seq"], steps=PLUS_STEPS, schedule=PLUS_SCHEDULE,
         loss=hist.loss, failures=hist.failures,
         recovery_errors=hist.recovery_errors, launches=launched,
         merge_check=record["merge_check"], step_ms=record["step_ms"],
         step_ms_median_failure_free=step_ms,
         tokens_per_s=tokens / step_ms * 1e3,
         recovery_ms=record["recovery_ms"], merge_recovery_ms=merge_ms[0],
         peak_memory_gib=peak,
         timing="host clock around Trainer.step ending in "
                "torch.cuda.synchronize(); median over the failure-free "
                f"steps {free}; recovery_ms: the strategy's handler, "
                "same clock")
    total = dict(launched)
    train_vs_plain(TRAIN, "checkfree_plus", hist.loss[:2],
                   record["omegas"][:2])
    check_backward_on_path()

    hist, launched, record, peak = train_run(
        "checkfree", CHECKFREE_STEPS, Forced(CHECKFREE_SCHEDULE))
    check_run("checkfree", hist, launched, steps=CHECKFREE_STEPS, halves=1,
              merges=CHECKFREE_MERGES, schedule=CHECKFREE_SCHEDULE)
    free = [i for i in range(CHECKFREE_STEPS) if i not in CHECKFREE_SCHEDULE]
    step_ms = float(np.median([record["step_ms"][i] for i in free]))
    emit("train", arch=cfg.name, layers=cfg.num_layers, stages=TRAIN["stages"],
         strategy="checkfree", batch=TRAIN["batch"], seq=TRAIN["seq"],
         steps=CHECKFREE_STEPS, schedule=CHECKFREE_SCHEDULE, loss=hist.loss,
         failures=hist.failures, recovery_errors=hist.recovery_errors,
         launches=launched, step_ms=record["step_ms"],
         step_ms_median_failure_free=step_ms,
         tokens_per_s=tokens / step_ms * 1e3,
         recovery_ms=record["recovery_ms"], peak_memory_gib=peak)
    for k, n in launched.items():
        total[k] += n
    return total


def model_shape(cfg) -> dict:
    """The widths a phase reports: attention heads where the model has
    attention, SSD heads where it has an SSM tower."""
    attention, ssd = pass_launches(cfg)
    shape = {}
    if attention:
        shape.update(heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                     head_dim=cfg.resolved_head_dim,
                     window=cfg.sliding_window)
    if ssd:
        shape.update(ssm_heads=cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim,
                     ssm_head_dim=cfg.ssm.head_dim,
                     state_dim=cfg.ssm.state_dim, chunk=cfg.ssm.chunk_size)
    if cfg.arch_type == "hybrid":
        shape.update(attn_every=cfg.attn_every)
    if cfg.arch_type == "encdec":
        shape.update(encoder_layers=cfg.num_encoder_layers,
                     frames=cfg.encoder_seq_len)
    if cfg.arch_type == "vlm":
        shape.update(patches=cfg.num_patches)
    return shape


def check_finite_gradients(phase: str, record: dict) -> None:
    norms = record["grad_norm"] + [float(x) for o in record["omegas"]
                                   for x in o]
    if not all(math.isfinite(x) for x in norms):
        raise AssertionError(f"{phase}: gradient norms and omegas "
                             f"{record['grad_norm']}, {record['omegas']}")


def phase_train_checkfree(spec: dict, phase: str) -> dict:
    """``checkfree`` at full width on a model whose backward runs kernels at
    shapes no other path runs (gemma-2b's and h2o-danube-3-4b's head dims,
    zamba2-2.7b's SSD layers and shared attention at head dim 80, the VLM's
    64/8 x 128 over its patches and tokens): launch counts, the failure of
    ``spec["schedule"]`` (default CHECKFREE_SCHEDULE: stage 2 at step 2),
    an intermediate stage's merge against its plain version (an edge stage
    is copied from its neighbour, as JAX's CheckFree does), finite
    gradients, the first two steps against the plain attention and SSD scan
    and the backward kernels on one step's own inputs.  Returns the launch
    counts of the counted run."""
    cfg = train_model_config(spec)
    schedule = spec.get("schedule", CHECKFREE_SCHEDULE)
    stage = schedule[2][0]
    edge = stage in (0, spec["stages"] - 1)
    hist, launched, record, peak = train_run(
        "checkfree", CHECKFREE_STEPS, Forced(schedule), spec=spec,
        check_merge=None if edge else (2, stage))
    check_run(phase, hist, launched, steps=CHECKFREE_STEPS, halves=1,
              merges=0 if edge else CHECKFREE_MERGES, schedule=schedule,
              spec=spec)
    check_finite_gradients(phase, record)
    if cfg.arch_type == "moe":
        check_aux(phase, cfg, record["aux"])
    free = [i for i in range(CHECKFREE_STEPS) if i not in schedule]
    step_ms = float(np.median([record["step_ms"][i] for i in free]))
    merge_ms = [ms for name, step, ms in record["recovery_ms"] if step == 2]
    tokens = spec["batch"] * spec["seq"]
    emit(phase, arch=cfg.name, layers=cfg.num_layers,
         layers_published=get_config(spec["arch"]).num_layers,
         d_model=cfg.d_model, **model_shape(cfg),
         stages=spec["stages"], params=cfg.param_count(),
         state_gb=16 * cfg.param_count() / 1e9, dtype=cfg.dtype,
         masters="float32", strategy="checkfree", batch=spec["batch"],
         seq=spec["seq"], steps=CHECKFREE_STEPS, schedule=schedule,
         recovery="copy of the neighbour (edge stage)" if edge else "merge",
         loss=hist.loss, aux=record["aux"], failures=hist.failures,
         recovery_errors=hist.recovery_errors, launches=launched,
         merge_check=record.get("merge_check"), step_ms=record["step_ms"],
         step_ms_median_failure_free=step_ms,
         tokens_per_s=tokens / step_ms * 1e3, grad_norm=record["grad_norm"],
         recovery_ms=record["recovery_ms"], merge_recovery_ms=merge_ms[0],
         peak_memory_gib=peak, peak_reserved_gib=record["peak_reserved_gib"],
         nvidia_smi=smi(),
         timing="host clock around Trainer.step ending in "
                "torch.cuda.synchronize(); median over the failure-free "
                f"steps {free}; recovery_ms: the strategy's handler, "
                "same clock")
    train_vs_plain(spec, "checkfree", hist.loss[:2], record["omegas"][:2])
    check_backward_on_path(spec, "checkfree")
    return launched


def check_aux(phase: str, cfg, aux: list) -> None:
    """Each step's aux (the layers' load-balance losses summed) finite and
    of the order of 1 a layer (MOE_AUX_LOW, MOE_AUX_SPREAD)."""
    hi = cfg.moe.num_experts / MOE_AUX_SPREAD
    if not aux or not all(math.isfinite(a) and MOE_AUX_LOW
                          <= a / cfg.num_layers <= hi for a in aux):
        raise AssertionError(f"{phase}: aux {aux} over {cfg.num_layers} "
                             f"layers")


def phase_train_plus(spec: dict, phase: str, *, fused: dict,
                     plain_batch=None) -> dict:
    """``checkfree_plus`` at ``spec``'s full width for 6 eager steps under
    PLUS_SCHEDULE (a merge, an edge twin copy, two merges in one step) with
    train's checks: launches, failures, the step-2 merge against its plain
    version, finite gradients (MoE: aux of the order of 1 a layer); then,
    at ``plain_batch`` where given, the first two steps against the same
    steps with the plain attention and SSD scan; the backward kernels on one
    step's own inputs; then the fused windows of ``phase_train_fused``
    (``fused``: its keywords, and the ``batch`` they run at) against the
    same steps eagerly.  Returns the launch counts of both counted runs."""
    cfg = train_model_config(spec)
    tokens = spec["batch"] * spec["seq"]
    hist, launched, record, peak = train_run(
        "checkfree_plus", PLUS_STEPS, Forced(PLUS_SCHEDULE), spec=spec,
        check_merge=(2, 3))
    check_run(phase, hist, launched, steps=PLUS_STEPS, halves=2,
              merges=PLUS_MERGES, schedule=PLUS_SCHEDULE, spec=spec)
    check_finite_gradients(phase, record)
    if cfg.arch_type == "moe":
        check_aux(phase, cfg, record["aux"])
    free = [i for i in range(PLUS_STEPS) if i not in PLUS_SCHEDULE]
    step_ms = float(np.median([record["step_ms"][i] for i in free]))
    merge_ms = [ms for name, step, ms in record["recovery_ms"] if step == 2]
    moe = (dict(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                d_ff_expert=cfg.moe.d_ff_expert)
           if cfg.arch_type == "moe" else {})
    emit(phase, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, **model_shape(cfg), **moe,
         stages=spec["stages"], staged_tower=StagePartition(
             cfg, spec["stages"]).tower_key,
         params=cfg.param_count(), state_gb=16 * cfg.param_count() / 1e9,
         dtype=cfg.dtype, masters="float32", strategy="checkfree_plus",
         batch=spec["batch"], seq=spec["seq"], steps=PLUS_STEPS,
         schedule=PLUS_SCHEDULE, loss=hist.loss, aux=record["aux"],
         failures=hist.failures, recovery_errors=hist.recovery_errors,
         launches=launched, merge_check=record["merge_check"],
         step_ms=record["step_ms"], step_ms_median_failure_free=step_ms,
         tokens_per_s=tokens / step_ms * 1e3, grad_norm=record["grad_norm"],
         recovery_ms=record["recovery_ms"], merge_recovery_ms=merge_ms[0],
         peak_memory_gib=peak, peak_reserved_gib=record["peak_reserved_gib"],
         nvidia_smi=smi(),
         timing="host clock around Trainer.step ending in "
                "torch.cuda.synchronize(); median over the failure-free "
                f"steps {free}; recovery_ms: the strategy's handler, "
                "same clock")
    total = dict(launched)
    if plain_batch:
        train_vs_plain(dict(spec, batch=plain_batch), "checkfree_plus")
    check_backward_on_path(spec, "checkfree_plus")
    fused = dict(fused)
    batch = fused.pop("batch", spec["batch"])
    counted = phase_train_fused(dict(spec, batch=batch), f"{phase}_fused",
                                **fused)
    for k, n in counted.items():
        total[k] += n
    return total


def phase_train_ssm() -> dict:
    """mamba2-1.3b at full width and depth (TRAIN_SSM): phase_train_plus,
    the plain comparison at SSM_PLAIN_BATCH, then 16 steps in fused windows
    of 8 with stage 3 failing at the window boundary, bit-equal to the same
    steps eagerly (the capture empties the allocator's cache)."""
    return phase_train_plus(TRAIN_SSM, "train_ssm", plain_batch=SSM_PLAIN_BATCH,
                            fused=dict(steps=SSM_FUSED_STEPS,
                                       schedule=SSM_FUSED_SCHEDULE,
                                       sizes=SSM_FUSED_SIZES, merges=1,
                                       exact=True, kept_cache=False))


def phase_train_moe() -> dict:
    """granite-moe-3b-a800m at full width and depth (TRAIN_MOE):
    phase_train_plus (the step-2 merge of a stage holding the (4, 40, 1536,
    512) expert tensors, the backward kernels at 24/8 x 64), then 16 steps
    in fused windows of 8 at MOE_FUSED_BATCH, bit-equal to the same steps
    eagerly."""
    return phase_train_plus(TRAIN_MOE, "train_moe",
                            fused=dict(batch=MOE_FUSED_BATCH,
                                       steps=MOE_FUSED_STEPS,
                                       schedule=MOE_FUSED_SCHEDULE,
                                       sizes=MOE_FUSED_SIZES, merges=1,
                                       exact=True, kept_cache=None))


def phase_train_whisper() -> dict:
    """whisper-large-v3 at full size (TRAIN_WHISPER): phase_train_plus on
    the staged encoder tower (the encoder's 32 full attentions and the
    decoder's 32 cross-attentions run the three flash kernels at Sq != Sk or
    without a mask), the plain comparison at WHISPER_PLAIN_BATCH, then 16
    steps in fused windows of 8 at WHISPER_FUSED_BATCH against the same
    steps eagerly, at train_fused's gate (whether bit-equal is reported)."""
    return phase_train_plus(TRAIN_WHISPER, "train_whisper",
                            plain_batch=WHISPER_PLAIN_BATCH,
                            fused=dict(batch=WHISPER_FUSED_BATCH,
                                       steps=WHISPER_FUSED_STEPS,
                                       schedule=WHISPER_FUSED_SCHEDULE,
                                       sizes=WHISPER_FUSED_SIZES, merges=1,
                                       exact=False, kept_cache=None))


def phase_train_fused(spec: dict = TRAIN, phase: str = "train_fused", *,
                      steps: int = FUSED_STEPS, schedule: dict = FUSED_SCHEDULE,
                      sizes: list = FUSED_SIZES, merges: int = 2,
                      exact: bool = False, kept_cache=True) -> dict:
    """``checkfree_plus`` at ``spec``'s full width in fused windows of 8
    (CUDA graphs replayed under ``set_sync_debug_mode("error")``) against
    the same run in eager steps; TRAIN's: the merge of stage 3 at wall 13
    cutting a window short and that of stage 2 at wall 25.  ``exact``: the
    fused losses, omegas and gradient norms must equal the eager ones bit
    for bit.  ``kept_cache``: whether the capture must keep the allocator's
    cache (then merges may allocate nothing) or must have emptied it; None:
    either, as the card's free memory decides (reported).  The aux column
    of the rings is reported beside the eager run's.
    Returns the launch counts of the fused run, with the graph's replays
    counted."""
    cfg = train_model_config(spec)
    tokens = spec["batch"] * spec["seq"]
    eager_hist, eager_launched, eager_record, eager_peak = train_run(
        "checkfree_plus", steps, Forced(schedule), spec=spec)
    check_run(f"{phase} eager", eager_hist, eager_launched, steps=steps,
              halves=2, merges=merges, schedule=schedule, spec=spec)

    modes = []
    replay = torch.cuda.CUDAGraph.replay

    def recording(graph):
        modes.append(torch.cuda.get_sync_debug_mode())
        return replay(graph)

    held = {}

    def setup(trainer, record):
        # instrument() already times the recoveries
        record.update(window_ms=[], rings=[])
        runner = trainer.window
        held["runner"] = runner
        dispatch, drain = runner.dispatch, runner.drain

        def timed_dispatch(state, stacked, **kw):
            torch.cuda.synchronize()
            record["t0"] = time.perf_counter()
            return dispatch(state, stacked, **kw)

        def timed_drain(pending):
            state, ring = drain(pending)
            record["window_ms"].append(
                (pending.k, (time.perf_counter() - record["t0"]) * 1e3))
            record["rings"].append(ring)
            return state, ring

        runner.dispatch, runner.drain = timed_dispatch, timed_drain

    torch.cuda.CUDAGraph.replay = recording
    try:
        hist, launched, record, peak = train_run(
            "checkfree_plus", steps, Forced(schedule), spec=spec,
            setup=setup, window=FUSED_WINDOW)
    finally:
        torch.cuda.CUDAGraph.replay = replay
    runner = held.pop("runner")
    graph = {"captures": runner.captures, "replays": runner.replays,
             "recorded_launches": runner.recorded_launches,
             "kept_cache": runner.kept_cache}
    replayed = {name: n * runner.replays
                for name, n in runner.recorded_launches.items()}
    del runner                       # its graph's pool and the bound state
    gc.collect()
    torch.cuda.empty_cache()
    # the wrappers counted each recorded launch once, at the capture, which
    # ran nothing; each replay ran the recorded launches
    counted = dict(launched)
    launched = {name: n + replayed.get(name, 0) - graph["captures"] *
                graph["recorded_launches"].get(name, 0)
                for name, n in counted.items()}
    check_run(phase, hist, launched, steps=steps, halves=2, merges=merges,
              schedule=schedule, spec=spec)
    rows = np.concatenate(record["rings"])
    omegas = rows[:, OMEGAS:]
    grad_norm = rows[:, RECORD.index("grad_norm")]
    loss_err = [abs(a - b) for a, b in zip(hist.loss, eager_hist.loss)]
    omega_err = [float(np.max(np.abs(a - b.numpy()) / np.abs(b.numpy())))
                 for a, b in zip(omegas, eager_record["omegas"])]
    steady = [ms for i, (k, ms) in enumerate(record["window_ms"])
              if i > 0 and k == FUSED_WINDOW]
    window_ms = float(np.median(steady))
    free = [i for i in range(steps) if i not in schedule]
    eager_ms = float(np.median([eager_record["step_ms"][i] for i in free]))
    window_sizes = [k for k, _ in record["window_ms"]]
    same_bits = (hist.loss == eager_hist.loss and all(
        np.array_equal(a, b.numpy()) for a, b in zip(omegas,
                                                     eager_record["omegas"]))
        and grad_norm.tolist() == eager_record["grad_norm"]
        and rows[:, RECORD.index("aux")].tolist() == eager_record["aux"])
    emit(phase, arch=cfg.name, layers=cfg.num_layers,
         stages=spec["stages"], params=cfg.param_count(), dtype=cfg.dtype,
         masters="float32", strategy="checkfree_plus", batch=spec["batch"],
         seq=spec["seq"], steps=steps, fuse_window=FUSED_WINDOW,
         schedule=schedule, window_sizes=window_sizes,
         dispatches=hist.dispatches, loss=hist.loss, loss_eager=eager_hist.loss,
         loss_max_abs_err=max(loss_err), omega_max_rel_err=max(omega_err),
         bit_equal_to_eager=same_bits,
         loss_tol=("bit for bit" if exact
                   else f"{FUSED_LOSS_TOL} * (1 + |loss|)"),
         omega_tol="bit for bit" if exact else TRAIN_OMEGA_TOL,
         grad_norm=grad_norm.tolist(), failures=hist.failures,
         aux=rows[:, RECORD.index("aux")].tolist(),
         aux_eager=eager_record["aux"],
         recovery_errors=hist.recovery_errors,
         recovery_errors_eager=eager_hist.recovery_errors,
         launches=launched, launches_counted_by_wrappers=counted,
         graph=graph,
         sync_debug_modes=sorted(set(modes)), replays_checked=len(modes),
         window_ms=record["window_ms"], window_ms_median_full=window_ms,
         ms_per_step=window_ms / FUSED_WINDOW,
         tokens_per_s=tokens / (window_ms / FUSED_WINDOW) * 1e3,
         eager_step_ms=eager_record["step_ms"],
         eager_step_ms_median_failure_free=eager_ms,
         eager_tokens_per_s=tokens / eager_ms * 1e3,
         merge_recovery_ms=[ms for _, _, ms in record["recovery_ms"]],
         merge_device=record["recovery_device"],
         eager_merge_recovery_ms=[ms for _, step, ms in
                                  eager_record["recovery_ms"]],
         eager_merge_device=eager_record["recovery_device"],
         peak_memory_gib=peak, peak_reserved_gib=record["peak_reserved_gib"],
         eager_peak_memory_gib=eager_peak,
         eager_peak_reserved_gib=eager_record["peak_reserved_gib"],
         nvidia_smi=smi(),
         timing="window_ms: host clock from a synchronize before the "
                "window's dispatch to the end of its drain (the ring's copy "
                "to the host); the median over the full windows after the "
                "first (which runs an eager step and the capture); "
                "eager_step_ms: host clock around Trainer.step ending in a "
                "synchronize, median over the failure-free steps; "
                "merge_device: CUDA events around the handler, and the "
                "caching allocator's new device allocations in it (the "
                "capture keeps the cache of the eager step's blocks, on the "
                "stream the boundaries' work runs on)")
    problems = []
    if hist.steps != eager_hist.steps or hist.failures != eager_hist.failures:
        problems.append(f"trace {hist.steps}, failures {hist.failures}")
    if any(e > FUSED_LOSS_TOL * (1 + abs(b))
           for e, b in zip(loss_err, eager_hist.loss)) or \
            len(loss_err) != steps:
        problems.append(f"losses against the eager run: {loss_err}")
    if max(omega_err) > TRAIN_OMEGA_TOL:
        problems.append(f"omegas against the eager run: {omega_err}")
    if exact and not same_bits:
        problems.append("the fused losses, omegas and gradient norms are not "
                        "the eager run's bits")
    if not (np.isfinite(grad_norm).all() and np.isfinite(omegas).all()):
        problems.append(f"gradient norms {grad_norm.tolist()}")
    if cfg.arch_type == "moe":
        check_aux(phase, cfg, rows[:, RECORD.index("aux")].tolist())
    if window_sizes != sizes:
        problems.append(f"window sizes {window_sizes}, want {sizes}")
    if kept_cache is not None and graph["kept_cache"] != kept_cache:
        problems.append(f"the capture kept the allocator's cache: "
                        f"{graph['kept_cache']}, want {kept_cache}")
    if graph["kept_cache"] and any(m["device_allocs"]
                          for m in record["recovery_device"]):
        problems.append(f"merges that allocated device memory anew after the "
                        f"capture: {record['recovery_device']}")
    if graph["captures"] != 1 or len(modes) != graph["replays"] or \
            set(modes) != {2}:
        problems.append(f"replays {graph['replays']} under sync debug modes "
                        f"{sorted(set(modes))} (2: error)")
    if problems:
        raise AssertionError(f"{phase}: " + "; ".join(problems))
    return launched


@contextlib.contextmanager
def sync_warnings():
    """PyTorch's warnings of synchronizing CUDA calls inside, as a list
    (``set_sync_debug_mode("warn")``; a window's replays run under "error"
    all the same)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def telemetry_run(run_dir=None) -> dict:
    """train_fused's fused run (TRAIN, ``checkfree_plus``, FUSED_SCHEDULE,
    windows of 8), with a recorder streaming into ``run_dir`` installed
    (lit) or none (dark): its history, omegas, window times, synchronizing
    calls, launches (the graph's replays counted) and, lit, the recorder."""
    cfg = train_model_config(TRAIN)
    trainer = Trainer(Model(cfg, device="cuda", weights=False),
                      train_config("checkfree_plus", FUSED_STEPS,
                                   stages=TRAIN["stages"],
                                   batch=TRAIN["batch"], seq=TRAIN["seq"],
                                   window=FUSED_WINDOW),
                      schedule=Forced(FUSED_SCHEDULE))
    out = {"window_ms": [], "rings": []}
    runner = trainer.window
    dispatch, drain = runner.dispatch, runner.drain

    def timed_dispatch(state, stacked, **kw):
        torch.cuda.synchronize()
        out["t0"] = time.perf_counter()
        return dispatch(state, stacked, **kw)

    def timed_drain(pending):
        state, ring = drain(pending)
        out["window_ms"].append(
            (pending.k, (time.perf_counter() - out["t0"]) * 1e3))
        out["rings"].append(ring)
        return state, ring

    runner.dispatch, runner.drain = timed_dispatch, timed_drain
    batches = make_batches(cfg, batch=TRAIN["batch"], seq=TRAIN["seq"],
                           seed=0)
    rec = telemetry.configure(run_dir=run_dir) if run_dir else None
    try:
        torch.cuda.synchronize()
        zero_counts()
        with sync_warnings() as seen:
            state, hist = trainer.run(batches)
        torch.cuda.synchronize()
        counted = counts()
    finally:
        if rec is not None:
            rec.close()
            telemetry.set_recorder(None)
    out.update(hist=hist, recorder=rec,
               syncs=sum("synchroniz" in str(w.message) for w in seen),
               omegas=np.concatenate(out.pop("rings"))[:, OMEGAS:])
    # each replay ran the launches that the capture recorded (and counted)
    out["launched"] = {
        name: n + (runner.replays - runner.captures)
        * runner.recorded_launches.get(name, 0)
        for name, n in counted.items()}
    out["ms_per_step"] = float(np.median(
        [ms for i, (k, ms) in enumerate(out["window_ms"])
         if i > 0 and k == FUSED_WINDOW])) / FUSED_WINDOW
    del trainer, state, runner, dispatch, drain
    gc.collect()                     # a trainer and its window form a cycle
    torch.cuda.empty_cache()
    return out


def phase_train_telemetry() -> dict:
    """train_fused's fused run dark, lit and dark again: the sites change no
    bit, no dispatch and no synchronizing call, cost the lit run under 2% a
    step, and give a stream that passes the schema and the report's strict
    contract, and a Chrome trace that loads."""
    work = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        run_dir = os.path.join(work, "run")
        dark = telemetry_run()
        lit = telemetry_run(run_dir)
        dark2 = telemetry_run()
        rec, hist = lit["recorder"], lit["hist"]
        check_run("train_telemetry", hist, lit["launched"], steps=FUSED_STEPS,
                  halves=2, merges=2, schedule=FUSED_SCHEDULE)
        events, spans = rec.events, rec.spans
        problems = [f"schema: {p}" for p in telemetry.validate_events(events)]
        names = [sp["name"] for sp in spans]
        windows = [e for e in events if e["kind"] == "step_window"]
        end = [e for e in events if e["kind"] == "run_end"]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            strict = tel_report.main([run_dir, "--strict"])
        trace_path = rec.write_chrome_trace()
        trace = telemetry.load_chrome_trace(trace_path)
        metrics = telemetry.compute_metrics(events)
        dark_ms = (dark["ms_per_step"] + dark2["ms_per_step"]) / 2
        overhead = lit["ms_per_step"] / dark_ms - 1
        emit("train_telemetry", arch=TRAIN["arch"], stages=TRAIN["stages"],
             batch=TRAIN["batch"], seq=TRAIN["seq"], steps=FUSED_STEPS,
             fuse_window=FUSED_WINDOW, strategy="checkfree_plus",
             schedule=FUSED_SCHEDULE,
             ms_per_step={"dark": dark["ms_per_step"], "lit": lit["ms_per_step"],
                          "dark_again": dark2["ms_per_step"]},
             lit_over_dark=overhead, tol=TELEMETRY_MS_TOL,
             window_ms={"dark": dark["window_ms"], "lit": lit["window_ms"],
                        "dark_again": dark2["window_ms"]},
             syncs={"dark": dark["syncs"], "lit": lit["syncs"],
                    "dark_again": dark2["syncs"]},
             dispatches=hist.dispatches, wall_iters=hist.wall_iters,
             events=len(events), spans=len(spans),
             event_kinds=metrics["counts"],
             span_names={n: names.count(n) for n in sorted(set(names))},
             goodput=metrics["goodput"], recovery=metrics["recovery"],
             report_strict_rc=strict, report=text.getvalue().splitlines(),
             events_bytes=os.path.getsize(os.path.join(run_dir,
                                                       "events.jsonl")),
             trace_bytes=os.path.getsize(trace_path),
             trace_events=len(trace["traceEvents"]), launches=lit["launched"],
             nvidia_smi=smi(),
             timing="ms_per_step: host clock from a synchronize before a "
                    "window's dispatch to the end of its drain, the median "
                    "over the full windows after the first, over 8; syncs: "
                    "warnings of synchronizing CUDA calls under "
                    "set_sync_debug_mode('warn') over Trainer.run")
        for name, run in (("dark", dark), ("dark again", dark2)):
            other = run["hist"]
            if other.loss != hist.loss or not np.array_equal(
                    run["omegas"], lit["omegas"]):
                problems.append(f"the lit run's losses or omegas are not the "
                                f"{name} run's bits")
            if (other.dispatches, other.wall_iters, other.steps,
                    other.failures) != (hist.dispatches, hist.wall_iters,
                                        hist.steps, hist.failures):
                problems.append(f"dispatches, walls, trace or failures differ "
                                f"from the {name} run")
            if run["syncs"] != lit["syncs"]:
                problems.append(f"synchronizing calls: lit {lit['syncs']}, "
                                f"{name} {run['syncs']}")
        if len(end) != 1 or end[0]["effective_steps"] != FUSED_STEPS:
            problems.append(f"run_end {end}")
        if not (names.count("window_dispatch") == names.count("window_drain")
                == hist.dispatches) or names.count("recovery") != 2:
            problems.append(f"spans {sorted(set(names))}: dispatch "
                            f"{names.count('window_dispatch')}, drain "
                            f"{names.count('window_drain')}, recovery "
                            f"{names.count('recovery')}")
        if sum(e["k"] for e in windows) != hist.wall_iters:
            problems.append(f"step_window k sum {[e['k'] for e in windows]}")
        if strict != 0:
            problems.append(f"report --strict returned {strict}")
        if overhead > TELEMETRY_MS_TOL:
            problems.append(f"the lit run takes {overhead:.2%} more a step "
                            f"than the dark runs' mean")
        if problems:
            raise AssertionError("train_telemetry: " + "; ".join(problems))
        return lit["launched"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def elastic_schedule() -> tuple:
    """The phase's simulated spot_shrink schedule and its story within
    ELASTIC_STEPS walls: [(wall, "fail" | "depart" | "regrow", slot)]."""
    sched = simulate(get_scenario("spot_shrink", **ELASTIC_SCENARIO),
                     steps=ELASTIC_STEPS * 10, seed=ELASTIC_SEED,
                     num_stages=TRAIN["stages"],
                     protect_edges=default_protect_edges("elastic"))
    story = []
    for w in range(ELASTIC_STEPS):
        story += [(w, "regrow", s) for s in sched.regrown_at(w)]
        story += [(w, "depart" if s in sched.departed_at(w) else "fail", s)
                  for s in sorted(sched.at(w))]
    return sched, story


def implied_relayouts(story: list) -> list:
    """(wall, direction, from_k, to_k) that the story's departures and
    regrows imply for a strategy that takes every re-layout."""
    k, out = TRAIN["stages"], []
    for wall, kind, _ in story:
        if kind != "fail":
            to = k - 1 if kind == "depart" else k + 1
            out.append((wall, "shrink" if kind == "depart" else "grow", k, to))
            k = to
    return out


def peaks() -> dict:
    return {"allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}


def elastic_setup(trainer: Trainer, record: dict) -> None:
    """The phase's instruments: each ``_repartition``'s host ms (ending in a
    synchronize), the memory peaks of the layout epoch it closes (the peaks
    start anew after it) and the window it makes, and the merge at
    ELASTIC_UNEVEN against ``stage_merge_ref`` of the neighbours' layers
    gathered before it."""
    record.update(repartition_ms=[], epoch_peaks=[],
                  log=trainer.repartition_log, layout_windows=[trainer.window])
    repartition = trainer._repartition

    def timed(state, new_slots, **kw):
        torch.cuda.synchronize()
        record["epoch_peaks"].append(peaks())
        t0 = time.perf_counter()
        out = repartition(state, new_slots, **kw)
        torch.cuda.synchronize()
        record["repartition_ms"].append(
            (kw["wall_step"], kw["direction"],
             (time.perf_counter() - t0) * 1e3))
        record["layout_windows"].append(trainer.window)
        torch.cuda.reset_peak_memory_stats()
        return out

    trainer._repartition = timed
    handle = trainer.strategy.handle_failure

    def checked(state, event):
        if (event.wall_step, event.stage) != ELASTIC_UNEVEN:
            return handle(state, event)
        part, stage = trainer.part, event.stage
        counts = list(part.layer_counts)
        n = counts[stage]
        lo = sum(counts[:stage])
        hi = lo + n
        # the neighbours' layers nearest the shared bounds, by plain indexing
        # of the tower: the last n before lo (from the previous stage's
        # first on) and the first n from hi (the next stage's last repeated)
        prev_idx = [max(lo - n + j, lo - counts[stage - 1]) for j in range(n)]
        next_idx = [min(hi + j, hi + counts[stage + 1] - 1) for j in range(n)]
        prev = [x[prev_idx] for x in TR.leaves(state.params[part.tower_key])]
        nxt = [x[next_idx] for x in TR.leaves(state.params[part.tower_key])]
        wa = state.omegas[stage - 1].float()
        wb = state.omegas[stage + 1].float()
        ca, cb = wa / (wa + wb + 1e-30), wb / (wa + wb + 1e-30)
        state = handle(state, event)
        err, ok = 0.0, True
        for x, y, got in zip(prev, nxt, [
                t[lo:hi] for t in TR.leaves(state.params[part.tower_key])]):
            good, e = within(got, ref.stage_merge_ref(x, y, ca, cb),
                             MERGE_TOL[torch.float32])
            ok &= good
            err = max(err, e)
        record["uneven_merge"] = {
            "wall_step": event.wall_step, "stage": stage,
            "layer_counts": list(part.layer_counts),
            "neighbour_layers": [part.layer_counts[stage - 1],
                                 part.layer_counts[stage + 1]],
            "max_abs_err": err, "tol": MERGE_TOL[torch.float32]}
        if not ok or part.layer_counts[stage + 1] == n:
            raise AssertionError(f"the merge on the uneven layout: "
                                 f"{record['uneven_merge']}")
        return state

    trainer.strategy.handle_failure = checked


def layout_graphs(record: dict) -> list:
    """Each layout epoch's window as numbers; the windows themselves (their
    pools and the bound state) are let go."""
    graphs = [{"stages": w.part.num_stages, "captures": w.captures,
               "replays": w.replays, "recorded_launches": w.recorded_launches}
              for w in record.pop("layout_windows")]
    gc.collect()
    torch.cuda.empty_cache()
    return graphs


def phase_train_elastic() -> dict:
    """``elastic`` at TRAIN's full width and depth under the port's simulated
    ``spot_shrink`` (ELASTIC_SCENARIO): a transient failure on 6 stages, a
    departure that shrinks 6 -> 5, a merge on the uneven 5-stage layout and
    a regrow back to 6, in fused windows of 8 (a new window and capture per
    layout epoch) against the same walls eagerly.  Returns the launch
    counts of the fused run, with the graphs' replays counted."""
    cfg = get_config(TRAIN["arch"])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    sched, story = elastic_schedule()
    if story != ELASTIC_STORY:
        raise AssertionError(f"train_elastic: the simulated story {story}, "
                             f"want {ELASTIC_STORY}")
    implied = implied_relayouts(story)
    failures = [(w, s) for w, kind, s in story if kind != "regrow"]
    rcfg = dict(protect_edge_stages=default_protect_edges("elastic"))

    eager_hist, eager_launched, eager_record, eager_peak = train_run(
        "elastic", ELASTIC_STEPS, sched, rcfg=rcfg, setup=elastic_setup)
    layout_graphs(eager_record)

    modes, fused = [], {"windows": [], "captures": []}
    replay, dispatch, drain, capture = (torch.cuda.CUDAGraph.replay,
                                        FusedWindow.dispatch,
                                        FusedWindow.drain,
                                        FusedWindow._capture)

    def recording(graph):
        modes.append(torch.cuda.get_sync_debug_mode())
        return replay(graph)

    def timed_dispatch(self, state, stacked, **kw):
        torch.cuda.synchronize()
        fused["t0"] = time.perf_counter()
        return dispatch(self, state, stacked, **kw)

    def timed_drain(self, pending):
        state, ring = drain(self, pending)
        fused["windows"].append({
            "k": pending.k, "stages": self.part.num_stages,
            "ms": (time.perf_counter() - fused["t0"]) * 1e3,
            "runner": id(self), "ring": ring})
        return state, ring

    def measured_capture(self, batch):
        capture(self, batch)
        torch.cuda.synchronize()
        fused["captures"].append({
            "stages": self.part.num_stages,
            "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
            "max_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30})

    torch.cuda.CUDAGraph.replay = recording
    FusedWindow.dispatch, FusedWindow.drain = timed_dispatch, timed_drain
    FusedWindow._capture = measured_capture
    try:
        hist, launched, record, peak = train_run(
            "elastic", ELASTIC_STEPS, sched, rcfg=rcfg, setup=elastic_setup,
            window=ELASTIC_WINDOW)
    finally:
        torch.cuda.CUDAGraph.replay = replay
        FusedWindow.dispatch, FusedWindow.drain = dispatch, drain
        FusedWindow._capture = capture
    graphs = layout_graphs(record)
    # the wrappers counted each recorded launch once, at its capture, which
    # ran nothing; each replay ran the recorded launches
    counted = dict(launched)
    launched = {name: n + sum((g["replays"] - g["captures"]) *
                              g["recorded_launches"].get(name, 0)
                              for g in graphs)
                for name, n in counted.items()}

    # the rows of the fused run against the eager steps' omegas, and each
    # window's rows (a window after a re-layout: its new K entries)
    loss_err = [abs(a - b) for a, b in zip(hist.loss, eager_hist.loss)]
    omega_err, start = [], 0
    for w in fused["windows"]:
        w["omega_err"] = []
        for row, want in zip(w["ring"], eager_record["omegas"][start:]):
            got, want = row[OMEGAS:], want.numpy()
            w["omega_err"].append(float(np.max(np.abs(got - want) /
                                               np.abs(want)))
                                  if got.shape == want.shape else math.inf)
        omega_err += w["omega_err"]
        start += w["k"]
    # per layout epoch: its windows, ms a step over the windows after its
    # first (which runs an eager step and the capture), memory peaks
    epoch_windows = []
    for w in fused["windows"]:
        if not epoch_windows or epoch_windows[-1][-1]["runner"] != w["runner"]:
            epoch_windows.append([])
        epoch_windows[-1].append(w)
    for w in fused["windows"]:
        del w["runner"]
    epoch_peaks = record["epoch_peaks"] + [
        {"allocated_gib": peak, "reserved_gib": record["peak_reserved_gib"]}]
    epochs = []
    for g, wins, p in zip(graphs, epoch_windows, epoch_peaks):
        steady = wins[1:]
        epochs.append({
            "stages": g["stages"], "captures": g["captures"],
            "replays": g["replays"], "window_sizes": [w["k"] for w in wins],
            "first_window": {"k": wins[0]["k"], "ms": wins[0]["ms"]},
            "ms_per_step": (sum(w["ms"] for w in steady) /
                            sum(w["k"] for w in steady)) if steady else None,
            "peak_allocated_gib": p["allocated_gib"],
            "peak_reserved_gib": p["reserved_gib"]})
    first_after = [{"wall_step": log_row[0], "stages": log_row[3],
                    "k": wins[0]["k"], "ring_width": wins[0]["ring"].shape[1],
                    "omegas": wins[0]["ring"][-1, OMEGAS:].tolist(),
                    "omega_max_rel_err": max(wins[0]["omega_err"])}
                   for log_row, wins in zip(record["log"], epoch_windows[1:])]
    eager_epoch_ms = []
    for lo, hi in zip([0] + [r[0] for r in implied],
                      [r[0] for r in implied] + [ELASTIC_STEPS]):
        free = [i for i in range(lo, hi) if i not in dict(failures)
                and i not in [r[0] for r in implied]]
        eager_epoch_ms.append(float(np.median(
            [eager_record["step_ms"][i] for i in free])))
    uneven_ms = [(name, step, ms) for name, step, ms in record["recovery_ms"]
                 if step == ELASTIC_UNEVEN[0]]
    uneven_device = [m for m in record["recovery_device"]
                     if m["wall_step"] == ELASTIC_UNEVEN[0]]
    emit("train_elastic", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=cfg.num_heads, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, stages=TRAIN["stages"],
         params=cfg.param_count(), dtype=cfg.dtype, masters="float32",
         strategy="elastic", protect_edges=rcfg["protect_edge_stages"],
         batch=TRAIN["batch"], seq=TRAIN["seq"], steps=ELASTIC_STEPS,
         fuse_window=ELASTIC_WINDOW, scenario="spot_shrink",
         overrides=ELASTIC_SCENARIO, seed=ELASTIC_SEED, story=story,
         repartition_log=record["log"],
         repartition_log_eager=eager_record["log"],
         repartition_host_ms=record["repartition_ms"],
         repartition_host_ms_eager=eager_record["repartition_ms"],
         failures=hist.failures, recovery_errors=hist.recovery_errors,
         recovery_errors_eager=eager_hist.recovery_errors,
         loss=hist.loss, loss_eager=eager_hist.loss,
         loss_max_abs_err=max(loss_err), omega_max_rel_err=max(omega_err),
         loss_tol=f"{FUSED_LOSS_TOL} * (1 + |loss|)",
         omega_tol=TRAIN_OMEGA_TOL, epochs=epochs,
         first_window_after_relayout=first_after,
         captures=fused["captures"], dispatches=hist.dispatches,
         launches=launched, launches_counted_by_wrappers=counted,
         launches_eager=eager_launched,
         sync_debug_modes=sorted(set(modes)), replays_checked=len(modes),
         eager_ms_per_step_by_epoch=eager_epoch_ms,
         eager_peak_memory_gib=eager_peak,
         uneven_merge=record.get("uneven_merge"),
         uneven_merge_host_ms=uneven_ms, uneven_merge_device=uneven_device,
         merge_recovery_ms=record["recovery_ms"],
         merge_device=record["recovery_device"],
         tokens_per_s_by_epoch=[tokens / e["ms_per_step"] * 1e3
                                if e["ms_per_step"] else None
                                for e in epochs],
         nvidia_smi=smi(),
         timing="window ms: host clock from a synchronize before a window's "
                "dispatch to the end of its drain; ms_per_step: an epoch's "
                "windows after its first (which runs an eager step and the "
                "capture) over their steps; repartition_host_ms: host clock "
                "around Trainer._repartition ending in a synchronize (the "
                "old graph's reset and the allocator's cache emptied); eager "
                "ms: host clock around Trainer.step ending in a synchronize, "
                "median over an epoch's walls without failures or "
                "re-layouts; merge device ms: CUDA events around the "
                "handler")
    problems = []
    want = {"flash_attention_fwd": cfg.num_layers * ELASTIC_STEPS,
            "flash_attention_bwd_dq": cfg.num_layers * ELASTIC_STEPS,
            "flash_attention_bwd_dkv": cfg.num_layers * ELASTIC_STEPS,
            "stage_merge": len(failures), "ssd_scan": 0, "ssd_scan_bwd": 0,
            "adam_sumsq": ELASTIC_STEPS, "adam_update": ELASTIC_STEPS}
    for name, got in (("fused", launched), ("eager", eager_launched)):
        if got != want:
            problems.append(f"{name} launches {got}, want {want}")
    for name, log in (("fused", record["log"]),
                      ("eager", eager_record["log"])):
        if [r[:4] for r in log] != implied:
            problems.append(f"{name} repartition log {log}, the schedule "
                            f"implies {implied}")
    if record["log"] != eager_record["log"]:
        problems.append(f"repartition logs {record['log']} fused, "
                        f"{eager_record['log']} eager")
    for name, h in (("fused", hist), ("eager", eager_hist)):
        if [tuple(f) for f in h.failures] != failures or \
                h.steps != list(range(1, ELASTIC_STEPS + 1)) or \
                len(h.recovery_errors) != len(failures) or not all(
                    math.isfinite(e) for _, e in h.recovery_errors):
            problems.append(f"{name} failures {h.failures}, steps {h.steps}, "
                            f"recovery errors {h.recovery_errors}")
    if len(loss_err) != ELASTIC_STEPS or any(
            e > FUSED_LOSS_TOL * (1 + abs(b))
            for e, b in zip(loss_err, eager_hist.loss)) or \
            not all(math.isfinite(x) for x in hist.loss):
        problems.append(f"losses against the eager run: {loss_err}")
    if len(omega_err) != ELASTIC_STEPS or max(omega_err) > TRAIN_OMEGA_TOL:
        problems.append(f"omegas against the eager run: {omega_err}")
    if [f["stages"] for f in first_after] != [r[3] for r in implied] or any(
            f["ring_width"] != OMEGAS + f["stages"] or
            f["omega_max_rel_err"] > TRAIN_OMEGA_TOL for f in first_after):
        problems.append(f"the first windows after the re-layouts: "
                        f"{first_after}")
    if [g["captures"] for g in graphs] != [1] * (len(implied) + 1) or \
            [g["stages"] for g in graphs] != \
            [TRAIN["stages"]] + [r[3] for r in implied]:
        problems.append(f"captures per layout epoch: {graphs}")
    if len(modes) != sum(g["replays"] for g in graphs) or set(modes) != {2}:
        problems.append(f"replays {len(modes)} under sync debug modes "
                        f"{sorted(set(modes))} (2: error)")
    first_gib = fused["captures"][0]["max_reserved_gib"] \
        if fused["captures"] else math.inf
    last_gib = fused["captures"][-1]["max_reserved_gib"] \
        if fused["captures"] else math.inf
    if last_gib > first_gib + ELASTIC_RESERVED_GIB or \
            max(p["reserved_gib"] for p in epoch_peaks) > \
            first_gib + ELASTIC_RESERVED_GIB or \
            max(p["reserved_gib"] for p in epoch_peaks) * 2 ** 30 >= \
            CARD_BYTES:
        problems.append(f"reserved memory: {first_gib} GiB after the first "
                        f"capture, {last_gib} after the last, epoch peaks "
                        f"{epoch_peaks}")
    if "uneven_merge" not in record:
        problems.append("no merge ran on the uneven layout")
    if problems:
        raise AssertionError("train_elastic: " + "; ".join(problems))
    return launched


def mem_available() -> int:
    """The host's available memory in bytes (``MemAvailable``)."""
    with open("/proc/meminfo") as f:
        meminfo = dict(line.split(":", 1) for line in f)
    return int(meminfo["MemAvailable"].split()[0]) * 1024


def host_report(phase: str, directory: str, need: dict) -> dict:
    """The card, the host's free memory and the free space of ``directory``
    before a phase that keeps the training state on the host or the disk;
    ``need`` is the phase's need in bytes ("ram", "disk")."""
    ram = mem_available()
    disk = shutil.disk_usage(directory).free
    fits = need.get("ram", 0) <= ram / 2 and need.get("disk", 0) <= disk / 2
    report = dict(nvidia_smi=smi(), mem_available_gb=ram / 1e9,
                  dir=directory, disk_free_gb=disk / 1e9,
                  need_gb={k: v / 1e9 for k, v in need.items()},
                  fits_in_half=fits)
    emit(phase + "_host", **report)
    return report


def pinned_stats() -> dict:
    """The pinned host allocator's bytes (blocks rounded to powers of two,
    active + cached), allocations and microseconds spent allocating since
    the process started, when this PyTorch reports them."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return {}
    got = stats()
    keys = ("allocated_bytes.current", "allocated_bytes.peak",
            "num_host_alloc", "host_alloc_time.total")
    return {k: got.get(k) for k in keys}


def empty_host_cache() -> None:
    """Give the cached pinned blocks back, so that the next phase starts
    with none (a private call; skipped where this PyTorch lacks it)."""
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            return


def state_bytes(cfg) -> int:
    """fp32 masters and both Adam moments: 12 bytes a parameter."""
    return 12 * cfg.param_count()


def cut_if_needed(phase: str, spec: dict, directory: str, ram: float,
                  disk: float) -> dict:
    """``spec`` as it is when the phase's need (``ram`` and ``disk`` times
    the training state) fits half of the host's free memory and of
    ``directory``'s free space, else cut to CKPT_CUT_LAYERS layers (said
    so, with the readings that forced it)."""
    need = state_bytes(train_model_config(spec))
    report = host_report(phase, directory, {"ram": ram * need,
                                            "disk": disk * need})
    if report["fits_in_half"]:
        return spec
    emit(phase + "_cut", layers=CKPT_CUT_LAYERS,
         reason="the phase's need does not fit half of the host's free "
                "memory or disk", need_gb=report["need_gb"],
         mem_available_gb=report["mem_available_gb"],
         disk_free_gb=report["disk_free_gb"])
    return dict(spec, layers=CKPT_CUT_LAYERS)


class HostMemoryLow:
    """The host's lowest available memory while the ``with`` block runs,
    sampled every ``every_s`` seconds on a thread (``low_gb``, beside
    ``start_gb`` at entry)."""

    def __init__(self, every_s: float = 0.25):
        import threading
        self.every_s, self.done = every_s, threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self) -> None:
        while not self.done.wait(self.every_s):
            self.low = min(self.low, mem_available())

    def __enter__(self) -> "HostMemoryLow":
        self.start = self.low = mem_available()
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.done.set()
        self.thread.join()
        self.low = min(self.low, mem_available())

    def report(self) -> dict:
        return dict(mem_available_start_gb=self.start / 1e9,
                    mem_available_low_gb=self.low / 1e9,
                    host_used_peak_gb=(self.start - self.low) / 1e9)


def timed_snapshots(record: dict) -> None:
    """Time every device-to-host snapshot of the store (host clock; the
    snapshot ends in a synchronize) and keep its size."""
    snapshot = store_mod.host_snapshot

    def timed(tree, *, step, shard_id):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = snapshot(tree, step=step, shard_id=shard_id)
        record["snapshot"].append(((time.perf_counter() - t0) * 1e3,
                                   snap.nbytes, step))
        return snap

    store_mod.host_snapshot = timed
    ss_strategies.host_snapshot = timed


def untimed_snapshots() -> None:
    store_mod.host_snapshot = ss_strategies.host_snapshot = \
        ss_codec.host_snapshot


def live_equal(live, saved) -> bool:
    """Every leaf of the live tree on the card bit-equal to ``saved`` (host
    tensors, or ints)."""
    live_leaves, _ = TR.flatten(live)
    saved_leaves, _ = TR.flatten(saved)
    return len(live_leaves) == len(saved_leaves) and all(
        (a == int(b)) if isinstance(a, int) else
        bool(torch.equal(a.detach(), b.to(a.device)))
        for a, b in zip(live_leaves, saved_leaves))


def phase_train_ckpt() -> dict:
    """``checkpoint`` at full width: a restart before the first save, a
    rollback, two saves of the whole state; the ``torch.save`` yardstick."""
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        spec = cut_if_needed("train_ckpt", TRAIN, work, ram=1, disk=2)
        return train_ckpt(spec, work)
    finally:
        untimed_snapshots()
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        empty_host_cache()


def train_ckpt(spec: dict, work: str) -> dict:
    cfg = train_model_config(spec)
    ckpt_dir = os.path.join(work, "ckpt")
    checks = []

    start = {}

    def setup(trainer, record):
        record.update(snapshot=[], save_ms=[], yardstick=None)
        timed_snapshots(record)
        strategy = trainer.strategy
        after_step, handle = strategy.after_step, strategy.handle_failure
        init_state = trainer.init_state

        def recorded_init_state(params=None):
            # a host copy of the parameters the run really starts from,
            # which the restart at wall 1 must give back
            state = init_state(params)
            start["params"] = TR.map(
                lambda t: t.detach().to("cpu", copy=True), state.params)
            return state

        def timed_after_step(state, hist):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            after_step(state, hist)
            torch.cuda.synchronize()
            if state.effective_step % CKPT_EVERY == 0:
                record["save_ms"].append((time.perf_counter() - t0) * 1e3)
                if record["yardstick"] is None:
                    record["yardstick"] = torch_save_ms(state, work)

        def checked(state, event):
            state = handle(state, event)
            live = (state.params, state.opt_state)
            if state.effective_step == 0:
                opt = state.opt_state
                moments = TR.leaves(opt.m) + TR.leaves(opt.v)
                equal = (live_equal(state.params, start["params"])
                         and opt.step == 0
                         and not any(bool(t.any()) for t in moments))
                what = "restart: the parameters the run started from (a " \
                       "host copy taken at step 0), zero moments"
            else:
                want = load_checkpoint(ckpt_dir, live,
                                       state.effective_step)[1]
                equal = live_equal(live, want)
                del want
                what = f"rollback: the checkpoint of step " \
                       f"{state.effective_step} read back"
            checks.append({"wall_step": event.wall_step,
                           "effective_step": state.effective_step,
                           "against": what, "bit_equal": equal})
            return state

        trainer.init_state = recorded_init_state
        strategy.after_step = timed_after_step
        strategy.handle_failure = checked

    hist, launched, record, peak = train_run(
        "checkpoint", CKPT_STEPS, Forced(CKPT_SCHEDULE), spec=spec,
        rcfg=dict(checkpoint_every=CKPT_EVERY, checkpoint_dir=ckpt_dir),
        setup=setup)
    walls = len(hist.loss)
    free = [i for i in range(walls) if i not in CKPT_SCHEDULE]
    step_ms = float(np.median([record["step_ms"][i] for i in free]))
    replays = [(w, w - 1) for w in sorted(CKPT_SCHEDULE)]
    replay_err = [abs(hist.loss[a] - hist.loss[b]) / abs(hist.loss[b])
                  for a, b in replays]
    nbytes = record["snapshot"][0][1]
    save_ms = record["save_ms"]
    rollback_ms = [[w, ms] for _, w, ms in record["recovery_ms"]]
    emit("train_ckpt", arch=cfg.name, layers=cfg.num_layers,
         layers_published=get_config(spec["arch"]).num_layers,
         stages=spec["stages"], batch=spec["batch"], seq=spec["seq"],
         strategy="checkpoint", checkpoint_every=CKPT_EVERY,
         steps=CKPT_STEPS, schedule=CKPT_SCHEDULE, trace=hist.steps,
         loss=hist.loss, failures=hist.failures,
         recovery_errors=hist.recovery_errors, launches=launched,
         replayed_loss_rel_err=replay_err,
         replayed_loss_bit_equal=[hist.loss[a] == hist.loss[b]
                                  for a, b in replays],
         restores=checks, state_gb=nbytes / 1e9, save_ms=save_ms,
         save_gb_per_s=[nbytes / ms / 1e6 for ms in save_ms],
         save_d2h_ms=[ms for ms, _, _ in record["snapshot"]],
         torch_save_ms=record["yardstick"],
         torch_save_gb_per_s=nbytes / record["yardstick"] / 1e6,
         rollback_ms=rollback_ms, step_ms=record["step_ms"],
         step_ms_median_failure_free=step_ms, peak_memory_gib=peak,
         pinned=pinned_stats(), dir=work, nvidia_smi=smi(),
         timing="host clock ending in torch.cuda.synchronize(): save_ms "
                "around the strategy's after_step at each save (the "
                "snapshot's device-to-host copy, save_d2h_ms, then the "
                "file), rollback_ms around its failure handler (wall 1 a "
                "restart from init, wall 5 a read of the checkpoint), "
                "torch_save_ms around torch.save of the same parameters "
                "and moments to the same directory (a yardstick, never on "
                "the path)")
    problems = []
    if hist.steps != CKPT_TRACE:
        problems.append(f"trace {hist.steps}, want {CKPT_TRACE}")
    if max(replay_err) > CKPT_REPLAY_TOL or not all(
            math.isfinite(x) for x in hist.loss):
        problems.append(f"replayed losses {replay_err}")
    if len(checks) != len(CKPT_SCHEDULE) or not all(
            c["bit_equal"] for c in checks):
        problems.append(f"restored state {checks}")
    per_kernel = cfg.num_layers * walls
    want = {"flash_attention_fwd": per_kernel,
            "flash_attention_bwd_dq": per_kernel,
            "flash_attention_bwd_dkv": per_kernel, "stage_merge": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0, "adam_sumsq": walls,
            "adam_update": walls}
    if launched != want or len(save_ms) != 2:
        problems.append(f"launches {launched}, saves {save_ms}")
    if problems:
        raise AssertionError("train_ckpt: " + "; ".join(problems))
    return launched


def torch_save_ms(state, work: str) -> float:
    """``torch.save`` of the parameters and both moments to ``work``, host
    clock; the file is removed again."""
    path = os.path.join(work, "torch_save.pt")
    tree = {"params": state.params, "m": state.opt_state.m,
            "v": state.opt_state.v}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.save(tree, path)
    ms = (time.perf_counter() - t0) * 1e3
    os.remove(path)
    return ms


def phase_train_neighbor() -> dict:
    """``neighbor`` (no disk safety net) at full width: six stage shards
    snapshotted to host memory every step, stage 3 restored from its
    neighbour's replica."""
    work = tempfile.mkdtemp(prefix="chip_smoke_neighbor_")
    try:
        spec = cut_if_needed("train_neighbor", TRAIN, work, ram=1, disk=0)
        return train_neighbor(spec, work)
    finally:
        untimed_snapshots()
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        empty_host_cache()


def train_neighbor(spec: dict, work: str) -> dict:
    cfg = train_model_config(spec)
    (wall, (stage,)), = NEIGHBOR_SCHEDULE.items()
    saved_step = NEIGHBOR_RESTORE[2]
    result = {}

    def setup(trainer, record):
        record.update(snapshot=[], after_step_ms=[])
        timed_snapshots(record)
        strategy = trainer.strategy
        after_step, handle = strategy.after_step, strategy.handle_failure

        def timed_after_step(state, hist):
            if state.effective_step == saved_step:
                # an independent copy of the shard this step saves
                result["saved"] = TR.clone(strategy._shard_tree(state, stage))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            after_step(state, hist)
            torch.cuda.synchronize()
            record["after_step_ms"].append((time.perf_counter() - t0) * 1e3)

        def checked(state, event):
            state = handle(state, event)
            live = strategy._shard_tree(state, stage)
            result["bit_equal"] = all(
                bool(torch.equal(a, b)) for a, b in
                zip(TR.leaves(live), TR.leaves(result.pop("saved"))))
            result["restore_log"] = list(strategy.restore_log)
            result["shard_gb"] = sum(
                t.numel() * t.element_size() for t in TR.leaves(live)) / 1e9
            # the device's copy time alone: one shard into pinned buffers
            # allocated beforehand, CUDA events
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in TR.leaves(live)]

            def copy():
                for buf, t in zip(bufs, TR.leaves(live)):
                    buf.copy_(t, non_blocking=True)

            result["shard_d2h_device_ms"] = time_ms(copy, groups=5,
                                                    per_group=1, warmup=1)
            del bufs
            return state

        strategy.after_step = timed_after_step
        strategy.handle_failure = checked

    # the store's events on the card: a recorder of the run's own
    rec = telemetry.Recorder(stream=False)
    prev = telemetry.set_recorder(rec)
    try:
        hist, launched, record, peak = train_run(
            "neighbor", NEIGHBOR_STEPS, Forced(NEIGHBOR_SCHEDULE), spec=spec,
            rcfg=dict(neighbor_cold=False, store_dir=work), setup=setup)
    finally:
        telemetry.set_recorder(prev)
    saves = [e for e in rec.events if e["kind"] == "snapshot_save"]
    restores = [e for e in rec.events if e["kind"] == "snapshot_restore"]
    store_events = saves + restores
    per_step = {}
    for ms, nbytes, step in record["snapshot"]:
        per_step.setdefault(step, [0.0, 0])
        per_step[step][0] += ms
        per_step[step][1] += nbytes
    snap_ms = [v[0] for _, v in sorted(per_step.items())]
    snap_bytes = [v[1] for _, v in sorted(per_step.items())]
    bound_ms = snap_bytes[0] / HOST_LINK_BYTES_PER_S * 1e3
    walls = len(hist.loss)
    free = [i for i in range(walls) if i not in NEIGHBOR_SCHEDULE]
    step_ms = float(np.median([record["step_ms"][i] for i in free]))
    emit("train_neighbor", arch=cfg.name, layers=cfg.num_layers,
         layers_published=get_config(spec["arch"]).num_layers,
         stages=spec["stages"], batch=spec["batch"], seq=spec["seq"],
         strategy="neighbor", neighbor_cold=False, steps=NEIGHBOR_STEPS,
         schedule=NEIGHBOR_SCHEDULE, trace=hist.steps, loss=hist.loss,
         failures=hist.failures, recovery_errors=hist.recovery_errors,
         restore_log=result.get("restore_log"),
         restored_stage_bit_equal=result.get("bit_equal"),
         shard_gb=result.get("shard_gb"), launches=launched,
         snapshot_ms_per_step=snap_ms,
         snapshot_gb_per_step=[b / 1e9 for b in snap_bytes],
         snapshot_gb_per_s=[b / ms / 1e6 for b, ms in
                            zip(snap_bytes, snap_ms)],
         snapshot_bound_ms=bound_ms,
         shard_d2h_device_ms=result.get("shard_d2h_device_ms"),
         shard_d2h_bound_ms=(result.get("shard_gb", 0) * 1e9
                             / HOST_LINK_BYTES_PER_S * 1e3),
         host_link="PCIe 5.0 x16, 64 GB/s a direction (H100 SXM data "
                   "sheet: 128 GB/s both ways)",
         after_step_ms=record["after_step_ms"],
         recovery_ms=record["recovery_ms"], step_ms=record["step_ms"],
         step_ms_median_failure_free=step_ms, peak_memory_gib=peak,
         pinned=pinned_stats(), dir=work,
         store_events={"snapshot_save": len(saves),
                       "snapshot_restore": restores,
                       "schema_problems": telemetry.validate_events(
                           store_events)},
         nvidia_smi=smi(),
         timing="host clock ending in torch.cuda.synchronize(): "
                "snapshot_ms_per_step sums the six shards' device-to-host "
                "snapshots of a step (pinned buffers, one synchronize "
                "each); after_step_ms adds placing them in the memory tier; "
                "shard_d2h_device_ms: CUDA events around the copies of one "
                "shard into pinned buffers allocated beforehand (median of "
                "5)")
    problems = []
    if result.get("restore_log") != [NEIGHBOR_RESTORE]:
        problems.append(f"restore log {result.get('restore_log')}, want "
                        f"{[NEIGHBOR_RESTORE]}")
    if not result.get("bit_equal"):
        problems.append("the restored stage differs from the shard saved")
    if hist.steps != list(range(1, NEIGHBOR_STEPS + 1)) or not all(
            math.isfinite(x) for x in hist.loss) or \
            hist.recovery_errors != [(wall, 0.0)]:
        problems.append(f"trace {hist.steps}, loss {hist.loss}, recovery "
                        f"errors {hist.recovery_errors}")
    per_kernel = cfg.num_layers * walls
    want = {"flash_attention_fwd": per_kernel,
            "flash_attention_bwd_dq": per_kernel,
            "flash_attention_bwd_dkv": per_kernel, "stage_merge": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0, "adam_sumsq": walls,
            "adam_update": walls}
    if launched != want:
        problems.append(f"launches {launched}, want {want}")
    # one snapshot_save for each snapshot taken, with its bytes, and the
    # restore of stage 3 with the bytes of the shard saved at its step
    saved = {(e["shard_id"], e["step"]): e["nbytes"] for e in saves}
    if telemetry.validate_events(store_events) or sorted(
            (e["step"], e["nbytes"]) for e in saves) != sorted(
            (step, nbytes) for _, nbytes, step in record["snapshot"]) or \
            len(restores) != 1 or restores[0]["nbytes"] != saved.get(
                (restores[0]["shard_id"], restores[0]["step"])) or \
            (restores[0]["step"], restores[0]["tier"]) != (
                saved_step, NEIGHBOR_RESTORE[3]):
        problems.append(f"store events: {len(saves)} saves, restores "
                        f"{restores}, schema "
                        f"{telemetry.validate_events(store_events)}")
    if problems:
        raise AssertionError("train_neighbor: " + "; ".join(problems))
    return launched


# train_spmd: TRAIN on the pipeline backend, six ranks on the one card;
# checkfree_plus (edges unprotected) for 12 steps in windows of up to 4, batch
# 8 in microbatches of 4 (M 2 a half), a merge at wall 5 and an edge copy at
# 9.  Against the host backend's run of the same steps: both compute in bf16
# and sum each weight's gradient over other splits of the batch (one matmul
# a half on the host, one a microbatch here), so the losses are held as the
# fused run's (FUSED_LOSS_TOL), the omegas as TRAIN_OMEGA_TOL, and the
# recovery errors, squared distances between stages that differ by O(1)
# elementwise, at 1e-3 relative
SPMD = dict(TRAIN, microbatch=4, steps=12, window=4)
SPMD_SCHEDULE = {5: [2], 9: [0]}
SPMD_RECOVERY_TOL = 1e-3
SPMD_RANK_TIMEOUT_S = 600.0
# the plain versions that ops would call for CPU tensors: none may run on a
# rank on the card
PLAIN_FUNCTIONS = ("flash_attention_ref", "stage_merge_ref", "ssd_chunked",
                   "adam_sumsq_ref", "adam_update_ref")


def record_windows(trainer: Trainer, record: dict) -> None:
    """Each window's size, host ms from its dispatch (after a synchronize)
    to the end of its drain, and its ring, into ``record``; on the pipeline
    backend also the transport's host seconds by kind up to each drain."""
    record.update(window_ms=[], rings=[], transfer_s=[])
    runner = trainer.window
    transport = getattr(trainer, "transport", None)
    dispatch, drain = runner.dispatch, runner.drain

    def timed_dispatch(state, stacked, **kw):
        torch.cuda.synchronize()
        record["t0"] = time.perf_counter()
        return dispatch(state, stacked, **kw)

    def timed_drain(pending):
        state, ring = drain(pending)
        record["window_ms"].append(
            (pending.k, (time.perf_counter() - record["t0"]) * 1e3))
        record["rings"].append(ring)
        if transport is not None:
            record["transfer_s"].append(dict(transport.seconds))
        return state, ring

    runner.dispatch, runner.drain = timed_dispatch, timed_drain


def full_window_step_ms(record: dict, k: int) -> float:
    """ms a step: the median over the full windows after the first (whose
    first step warms every process up) of their ms / k."""
    return float(np.median([ms / n for n, ms in record["window_ms"][1:]
                            if n == k]))


def transfer_ms_per_step(record: dict, skip: int = 1) -> dict:
    """The transport's host ms a step by kind over the windows after the
    first ``skip`` (waiting for a peer included)."""
    if len(record["transfer_s"]) <= skip:
        return {}
    before = record["transfer_s"][skip - 1]
    after = record["transfer_s"][-1]
    steps = sum(n for n, _ in record["window_ms"][skip:])
    return {kind: (after.get(kind, 0.0) - before.get(kind, 0.0)) / steps * 1e3
            for kind in after}


def spmd_rank(rank: int, spec: dict) -> dict:
    """One rank of train_spmd (a spawned process): the run, its launch
    counts, plain-version calls, rings, window times, transfers, memory and
    the merge's device ms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plain = dict.fromkeys(PLAIN_FUNCTIONS, 0)
    for name in PLAIN_FUNCTIONS:
        def counted(*a, _fn=getattr(ref, name), _name=name, **k):
            plain[_name] += 1
            return _fn(*a, **k)
        setattr(ref, name, counted)
    cfg = train_model_config(spec)
    tcfg = dataclasses.replace(
        train_config("checkfree_plus", spec["steps"], stages=spec["stages"],
                     batch=spec["batch"], seq=spec["seq"],
                     window=spec["window"]),
        microbatch=spec["microbatch"])
    trainer = Trainer(Model(cfg, device="cuda", weights=False), tcfg,
                      schedule=Forced(SPMD_SCHEDULE), backend="spmd")
    record = {"recovery_ms": [], "merge_ms": []}
    time_recoveries(trainer, record)
    record_windows(trainer, record)
    merge = ops.stage_merge

    def timed_merge(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = merge(*a, **k)
        end.record()
        end.synchronize()
        record["merge_ms"].append(start.elapsed_time(end))
        return out

    ops.stage_merge = timed_merge
    batches = make_batches(cfg, batch=spec["batch"], seq=spec["seq"], seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    trainer.transport.reset_counts()
    t0 = time.perf_counter()
    state, hist = trainer.run(batches)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    return {"hist": hist, "launched": counts(), "plain": plain,
            "rings": record["rings"], "window_ms": record["window_ms"],
            "transfer_ms_per_step": transfer_ms_per_step(record),
            "recovery_ms": record["recovery_ms"],
            "recovery_device": record["recovery_device"],
            "merge_ms": record["merge_ms"], "run_s": run_s,
            "sent": dict(trainer.transport.sent),
            "transfer_s": dict(trainer.transport.seconds),
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
            "effective_step": state.effective_step}


def phase_train_spmd() -> dict:
    """TRAIN on the pipeline backend: six ranks on the card against the
    host backend's run of the same steps.  Returns the launches of every
    rank, summed."""
    spec = SPMD
    cfg = train_model_config(spec)
    steps, k = spec["steps"], spec["window"]
    tokens = spec["batch"] * spec["seq"]
    host_hist, host_launched, host_record, host_peak = train_run(
        "checkfree_plus", steps, Forced(SPMD_SCHEDULE), spec=spec,
        setup=record_windows, window=k)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_stages(spmd_rank, spec["stages"], spec, cuda=True,
                         timeout_s=SPMD_RANK_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    hist = ranks[0]["hist"]
    host_omegas = np.concatenate(host_record["rings"])[:, OMEGAS:]
    omegas = np.concatenate(ranks[0]["rings"])[:, OMEGAS:]
    omega_err = float(np.max(np.abs(omegas - host_omegas) /
                             np.abs(host_omegas)))
    loss_err = max(abs(a - b) / (1 + abs(b))
                   for a, b in zip(hist.loss, host_hist.loss))
    rec_err = [abs(a - b) / abs(b) for (_, a), (_, b) in
               zip(hist.recovery_errors, host_hist.recovery_errors)]
    layers = cfg.num_layers // spec["stages"]
    # a flash launch a local layer and microbatch: two halves of M each
    per_step = layers * 2 * (spec["batch"] // spec["microbatch"])
    want = {"flash_attention_fwd": per_step * steps,
            "flash_attention_bwd_dq": per_step * steps,
            "flash_attention_bwd_dkv": per_step * steps, "stage_merge": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0, "adam_sumsq": steps,
            "adam_update": steps}
    problems = []
    for r, res in enumerate(ranks):
        need = dict(want, stage_merge=1 if r == 2 else 0)
        if res["launched"] != need:
            problems.append(f"rank {r} launches {res['launched']}, want "
                            f"{need}")
        if any(res["plain"].values()):
            problems.append(f"rank {r} called plain versions {res['plain']}")
        if res["hist"] != hist or res["effective_step"] != steps:
            problems.append(f"rank {r}'s history differs from rank 0's")
    failures = [(s, st) for s in sorted(SPMD_SCHEDULE)
                for st in SPMD_SCHEDULE[s]]
    if [tuple(f) for f in hist.failures] != failures or \
            hist.failures != host_hist.failures:
        problems.append(f"failures {hist.failures}, host "
                        f"{host_hist.failures}, want {failures}")
    if len(hist.loss) != steps or not all(math.isfinite(x)
                                          for x in hist.loss) or \
            loss_err > FUSED_LOSS_TOL:
        problems.append(f"losses {hist.loss} against the host's "
                        f"{host_hist.loss}: {loss_err}")
    if omega_err > TRAIN_OMEGA_TOL:
        problems.append(f"omegas off the host's by {omega_err}")
    if len(rec_err) != len(failures) or max(rec_err) > SPMD_RECOVERY_TOL:
        problems.append(f"recovery errors {hist.recovery_errors}, host "
                        f"{host_hist.recovery_errors}")
    step_ms = [full_window_step_ms(res, k) for res in ranks]
    host_step_ms = full_window_step_ms(host_record, k)
    sent = {kind: [res["sent"].get(kind, 0) / steps for res in ranks]
            for kind in ("activation", "gradient", "allreduce", "scalars")}
    transfer_ms = [res["transfer_ms_per_step"] for res in ranks]
    emit("train_spmd", arch=cfg.name, layers=cfg.num_layers,
         stages=spec["stages"], ranks=len(ranks), batch=spec["batch"],
         seq=spec["seq"], microbatch=spec["microbatch"],
         num_microbatches=spec["batch"] // spec["microbatch"],
         microbatch_rows=spec["microbatch"] // 2,
         strategy="checkfree_plus", steps=steps, window=k,
         schedule=SPMD_SCHEDULE, loss=hist.loss, loss_host=host_hist.loss,
         loss_max_rel_err=loss_err, loss_tol=FUSED_LOSS_TOL,
         omega_max_rel_err=omega_err, omega_tol=TRAIN_OMEGA_TOL,
         failures=hist.failures, recovery_errors=hist.recovery_errors,
         recovery_errors_host=host_hist.recovery_errors,
         recovery_rel_err=rec_err,
         launches_by_rank=[res["launched"] for res in ranks],
         plain_calls_by_rank=[res["plain"] for res in ranks],
         window_ms_rank0=ranks[0]["window_ms"],
         step_ms_by_rank=step_ms, step_ms=step_ms[0],
         tokens_per_s=tokens / step_ms[0] * 1e3,
         host_window_ms=host_record["window_ms"], host_step_ms=host_step_ms,
         host_tokens_per_s=tokens / host_step_ms * 1e3,
         host_peak_allocated_gib=host_peak,
         bytes_sent_per_step_by_rank=sent,
         transfer_host_ms_per_step_by_rank=transfer_ms,
         transfer_host_s_whole_run_by_rank=[res["transfer_s"]
                                            for res in ranks],
         recovery_bytes_by_rank=[res["sent"].get("recovery", 0)
                                 for res in ranks],
         peak_allocated_gib_by_rank=[res["peak_allocated_gib"]
                                     for res in ranks],
         peak_reserved_gib_by_rank=[res["peak_reserved_gib"]
                                    for res in ranks],
         merge_device_ms_rank2=ranks[2]["merge_ms"],
         recovery_ms_by_rank=[res["recovery_ms"] for res in ranks],
         run_s_by_rank=[res["run_s"] for res in ranks], spawn_s=spawn_s,
         nvidia_smi=smi(),
         timing="host clock from each window's dispatch (after a "
                "synchronize) to the end of its drain, a step's ms the "
                f"median over the windows of {k} after the first of their "
                f"ms / {k}; bytes: what the rank sent a step by kind "
                "(allreduce: the payload reduced, the replicated leaves' "
                "fp32 gradients); transfer ms: host time in the "
                "transport's calls a step over the windows after the "
                "first, staging and waiting for the peer included; merge: "
                "CUDA events around ops.stage_merge, the kernel's first "
                "launch in that process")
    if problems:
        raise AssertionError("train_spmd: " + "; ".join(problems))
    total = dict.fromkeys(want, 0)
    for res in ranks:
        for name, n in res["launched"].items():
            total[name] += n
    return total


# train_spmd_store: the strategies that snapshot or restore state on the
# pipeline backend, SPMD's six ranks on the one card (batch 8 in
# microbatches of 4, windows of up to 4), every run of the phase inside one
# spawn so that six processes warm up once; each schedule also runs on the
# host backend, eagerly (the JAX trainer's fuse_window=1 order of
# decisions).  The dense runs take paper-llama-1.5b at full width, cut in
# depth to SPMD_STORE_LAYERS.  Runs:
# name -> (strategy, steps, schedule, RecoveryConfig fields, walls whose
# observed failure rate is SPMD_STORMY_RATE)
SPMD_STORE_RUNS = {
    # stage 2 rolled back from step 5 to the save at 4 (wall 5), then the
    # edge stage 0 from step 6 to 4 (wall 7)
    "checkpoint": ("checkpoint", 7, {5: [2], 7: [0]},
                   dict(checkpoint_every=4), ()),
    # stage 3 served by its neighbour's memory at wall 2; stages 1 and 2
    # together at wall 4: stage 1's replica lived on stage 2's host, so the
    # disk copy of step 3 serves it
    "neighbor": ("neighbor", 6, {2: [3], 4: [1, 2]},
                 dict(checkpoint_every=3), ()),
    "tiered_ckpt": ("tiered_ckpt", 4, {2: [4]}, {}, ()),
    # checkfree merges stage 2 at wall 1; the observed rate on walls 3-5
    # switches to checkpoint (shadow-saving at 4 all along), which rolls
    # the failure at wall 5 back from step 5 to 4; calm again at wall 6
    "adaptive": ("adaptive", 7, {1: [2], 5: [3]},
                 dict(checkpoint_every=4), (3, 4, 5)),
}
SPMD_STORE_TRACES = {"checkpoint": [1, 2, 3, 4, 5, 5, 6, 5, 6, 7],
                     "neighbor": [1, 2, 3, 4, 5, 6],
                     "tiered_ckpt": [1, 2, 3, 4],
                     "adaptive": [1, 2, 3, 4, 5, 5, 6, 7]}
SPMD_STORE_LOGS = {"neighbor": [(2, 3, 2, "mem"), (4, 1, 3, "disk"),
                                (4, 2, 4, "mem")],
                   "tiered_ckpt": [(2, 4, 2, "mem")]}
SPMD_STORE_SWITCHES = [(4, "checkfree", "checkpoint"),
                       (6, "checkpoint", "checkfree")]
SPMD_STORMY_RATE = 0.5
# the dense runs' depth: 12 of paper-llama-1.5b's 24 layers.  At 24 (on an
# NVIDIA H100 80GB HBM3, 700 W, with a host of 96 GiB) the phase had run
# 485 s of the script's 1,108 without ending when the host's memory ran
# out: the six ranks share one host, where each stage of a deployment has
# its own, and keep their snapshots and stage every transfer through its
# pinned memory; and the script must end within 1,200 s.  Beside the cut,
# cut_if_needed still checks that half the host's free memory and disk
# hold the most saves of the whole state (fp32 masters and moments) that
# the runs keep at once, one run at a time (each removes its files when it
# ends): in memory, ``neighbor``'s and ``tiered_ckpt``'s tiers keep_hot = 2
# snapshots of every stage while they take the next a stage at a time (3
# bounds it); on disk, ``neighbor``'s saves at steps 3 and 6 (``checkpoint``
# and ``adaptive`` save once, at 4 of 7 steps; ``tiered_ckpt``'s disk
# cadence, checkpoint_every 100, never fires)
SPMD_STORE_LAYERS = 12
SPMD_STORE_HELD = dict(ram=3, disk=2)
# the gathered path (InMeshRecover.gathered: host math on the tower
# gathered from every rank) at the store runs' depth: a consecutive run
# merged by recover_consecutive, and a random reinit
SPMD_GATHERED_RUNS = {
    "checkfree-consecutive": ("checkfree", 3, {1: [2, 3]}, {}, ()),
    "random": ("random", 3, {1: [3]}, {}, ()),
}
# the MoE pipeline: granite-moe-3b-a800m cut to 24 of 32 layers (six ranks
# of 4: 7.65 GB of fp32 state and gradients a rank), batch 4 in one
# microbatch a half, so that routing and capacity are the host run's
SPMD_MOE = dict(arch="granite-moe-3b-a800m", stages=6, layers=24, batch=4,
                seq=512, microbatch=4, window=4)
SPMD_MOE_RUNS = {"granite-checkfree_plus": ("checkfree_plus", 4, {2: [2]},
                                            {}, ())}
SPMD_STORE_TIMEOUT_S = 1000.0


class Stormy(Forced):
    """Fixed events, and an observed failure rate of SPMD_STORMY_RATE on
    the walls ``stormy`` (0 elsewhere)."""

    def __init__(self, events: dict, stormy=()):
        super().__init__(events)
        self.stormy = set(stormy)

    def observed_rate(self, step: int) -> float:
        return SPMD_STORMY_RATE if step in self.stormy else 0.0


def store_config(spec: dict, run: tuple, directory: str) -> TrainConfig:
    """The training config of one run of the phase: ``spec``'s shape, the
    run's strategy and settings, its checkpoints and stores under
    ``directory``."""
    strategy, steps, _, rcfg, _ = run
    return dataclasses.replace(
        train_config(strategy, steps, stages=spec["stages"],
                     batch=spec["batch"], seq=spec["seq"],
                     window=spec.get("window", 1),
                     checkpoint_dir=os.path.join(directory, "ckpt"),
                     store_dir=os.path.join(directory, "store"), **rcfg),
        microbatch=spec.get("microbatch", spec["batch"]))


def record_store(trainer: Trainer, record: dict) -> None:
    """The strategy's after_step host ms by effective step (a save, where
    one fires; host clock ending in a synchronize), and at the run's end
    its restore log and switches (the trainer itself is not kept)."""
    strategy = trainer.strategy
    after_step, run_end = strategy.after_step, strategy.on_run_end
    record.update(after_step_ms=[])

    def timed(state, hist):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        after_step(state, hist)
        torch.cuda.synchronize()
        record["after_step_ms"].append(
            (state.effective_step, (time.perf_counter() - t0) * 1e3))

    def ended():
        run_end()
        record["restore_log"] = list(getattr(strategy, "restore_log", []))
        record["switches"] = list(getattr(strategy, "switches", []))

    strategy.after_step, strategy.on_run_end = timed, ended


def spmd_store_rank(rank: int, runs: list) -> dict:
    """One rank of train_spmd_store (a spawned process): each run of
    ``runs`` ((name, spec, run, directory)) in turn, with its launch counts,
    plain-version calls, window, save and restore times and peak memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plain = dict.fromkeys(PLAIN_FUNCTIONS, 0)
    for name in PLAIN_FUNCTIONS:
        def counted(*a, _fn=getattr(ref, name), _name=name, **k):
            plain[_name] += 1
            return _fn(*a, **k)
        setattr(ref, name, counted)
    out = {}
    for name, spec, run, directory in runs:
        cfg = train_model_config(spec)
        trainer = Trainer(Model(cfg, device="cuda", weights=False),
                          store_config(spec, run, directory),
                          schedule=Stormy(run[2], run[4]), backend="spmd")
        record = {"recovery_ms": []}
        time_recoveries(trainer, record)
        record_windows(trainer, record)
        record_store(trainer, record)
        batches = make_batches(cfg, batch=spec["batch"], seq=spec["seq"],
                               seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        plain.update(dict.fromkeys(plain, 0))
        trainer.transport.reset_counts()
        t0 = time.perf_counter()
        state, hist = trainer.run(batches)
        torch.cuda.synchronize()
        out[name] = {
            "hist": hist, "launched": counts(), "plain": dict(plain),
            "effective_step": state.effective_step,
            "omegas": [row[OMEGAS:].tolist()
                       for ring in record["rings"] for row in ring],
            "window_ms": record["window_ms"],
            "recovery_ms": record["recovery_ms"],
            "after_step_ms": record["after_step_ms"],
            "restore_log": record["restore_log"],
            "switches": record["switches"],
            "sent": dict(trainer.transport.sent),
            "run_s": time.perf_counter() - t0,
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
        del trainer, state
        gc.collect()                 # the instrumented trainer holds a cycle
        torch.cuda.empty_cache()
        remove_rank_files(directory, rank)
    return out


def store_host_run(spec: dict, run: tuple, directory: str) -> dict:
    """A run of the phase on the host backend, eagerly."""
    strategy, steps, events, rcfg, stormy = run
    try:
        hist, launched, record, peak = train_run(
            strategy, steps, Stormy(events, stormy), spec=spec,
            rcfg=dict(rcfg, checkpoint_dir=os.path.join(directory, "ckpt"),
                      store_dir=os.path.join(directory, "store")),
            setup=record_store)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        empty_host_cache()
    return {"hist": hist, "launched": launched, "record": record,
            "peak_allocated_gib": peak}


def remove_rank_files(directory: str, rank: int) -> None:
    """A rank's checkpoints and stores under a run's ``directory`` (rank 0
    also the replicated shards): each rank removes its own, so that none
    removes a file another rank still writes."""
    mine = set(store_mod.rank_dirs(rank))
    for root, dirs, _ in os.walk(directory):
        for d in [d for d in dirs if d in mine]:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
            dirs.remove(d)


def spmd_merges(name: str, rank=None) -> int:
    """Merge launches of a run of the phase on rank ``rank`` (None: the
    host run): the in-mesh merges on the failed rank (stage 2), every rank
    merging a consecutive run on its gathered tower."""
    if name == "checkfree-consecutive":
        return 2
    if name in ("adaptive", "granite-checkfree_plus"):
        return int(rank in (None, 2))
    return 0


def check_store_run(name: str, spec: dict, run: tuple, host: dict,
                    ranks: list) -> tuple:
    """The gates of one run of the phase -> (problems, its report)."""
    strategy, steps, events, _, _ = run
    cfg = train_model_config(spec)
    got = [r[name] for r in ranks]
    hist, hhist = got[0]["hist"], host["hist"]
    walls = len(hhist.loss)
    problems = []
    for r, res in enumerate(got):
        if res["hist"].to_json() != hist.to_json() or \
                res["effective_step"] != steps or \
                res["restore_log"] != got[0]["restore_log"] or \
                res["switches"] != got[0]["switches"]:
            problems.append(f"rank {r}'s history differs from rank 0's")
        if any(res["plain"].values()):
            problems.append(f"rank {r} called plain versions {res['plain']}")
        halves = 2 if strategy == "checkfree_plus" else 1
        per_wall = (cfg.num_layers // spec["stages"] * halves
                    * (spec["batch"] // spec["microbatch"]))
        want = {"flash_attention_fwd": per_wall * walls,
                "flash_attention_bwd_dq": per_wall * walls,
                "flash_attention_bwd_dkv": per_wall * walls,
                "stage_merge": spmd_merges(name, r), "ssd_scan": 0,
                "ssd_scan_bwd": 0, "adam_sumsq": walls, "adam_update": walls}
        if res["launched"] != want:
            problems.append(f"rank {r} launches {res['launched']}, want "
                            f"{want}")
    halves = 2 if strategy == "checkfree_plus" else 1
    host_want = {"flash_attention_fwd": cfg.num_layers * halves * walls,
                 "flash_attention_bwd_dq": cfg.num_layers * halves * walls,
                 "flash_attention_bwd_dkv": cfg.num_layers * halves * walls,
                 "stage_merge": spmd_merges(name), "ssd_scan": 0,
                 "ssd_scan_bwd": 0, "adam_sumsq": walls, "adam_update": walls}
    if host["launched"] != host_want:
        problems.append(f"host launches {host['launched']}, want "
                        f"{host_want}")
    failures = [(s, st) for s in sorted(events) for st in events[s]]
    if [tuple(f) for f in hist.failures] != failures or \
            hist.failures != hhist.failures:
        problems.append(f"failures {hist.failures}, host {hhist.failures}, "
                        f"want {failures}")
    if hist.steps != hhist.steps or hist.wall_iters != walls or \
            hist.steps != SPMD_STORE_TRACES.get(name, hhist.steps):
        problems.append(f"trace {hist.steps}, host {hhist.steps}")
    log, host_log = got[0]["restore_log"], host["record"]["restore_log"]
    if log != host_log or log != SPMD_STORE_LOGS.get(name, log):
        problems.append(f"restore log {log}, host {host_log}")
    switches = got[0]["switches"]
    if switches != host["record"]["switches"] or (
            strategy == "adaptive" and switches != SPMD_STORE_SWITCHES):
        problems.append(f"switches {switches}, host "
                        f"{host['record']['switches']}")
    loss_err = max(abs(a - b) / (1 + abs(b))
                   for a, b in zip(hist.loss, hhist.loss))
    if len(hist.loss) != walls or not all(math.isfinite(x)
                                          for x in hist.loss) or \
            loss_err > FUSED_LOSS_TOL:
        problems.append(f"losses {hist.loss} against the host's "
                        f"{hhist.loss}: {loss_err}")
    host_omegas = np.stack([o.numpy() for o in host["record"]["omegas"]])
    omegas = np.asarray(got[0]["omegas"])
    omega_err = (float(np.max(np.abs(omegas - host_omegas) /
                              np.abs(host_omegas)))
                 if omegas.shape == host_omegas.shape else math.inf)
    if omega_err > TRAIN_OMEGA_TOL:
        problems.append(f"omegas off the host's by {omega_err}")
    hot = {i for i, row in enumerate(log) if row[3] == "mem"}
    rec_err = []
    for i, ((w, a), (hw, b)) in enumerate(zip(hist.recovery_errors,
                                              hhist.recovery_errors)):
        if strategy in ("checkpoint", "adaptive") and w in events and \
                math.isnan(b):
            ok = math.isnan(a)               # a rollback: NaN on both sides
        elif i in hot:
            ok = a == 0.0 and b == 0.0       # a hot restore loses nothing
        else:
            ok = math.isfinite(a) and abs(a - b) <= SPMD_RECOVERY_TOL * abs(b)
        rec_err.append(None if math.isnan(b) else
                       (abs(a - b) / abs(b) if b else abs(a)))
        if not ok or w != hw:
            problems.append(f"recovery error {i}: {a} at wall {w}, host {b} "
                            f"at {hw}")
    if len(hist.recovery_errors) != len(failures) or \
            len(hhist.recovery_errors) != len(failures):
        problems.append(f"recovery errors {hist.recovery_errors}, host "
                        f"{hhist.recovery_errors}")
    if strategy in ("checkpoint", "adaptive"):
        nans = [math.isnan(e) for _, e in hist.recovery_errors]
        if not any(nans) or nans != [math.isnan(e) for _, e in
                                     hhist.recovery_errors]:
            problems.append(f"rollbacks {hist.recovery_errors}, host "
                            f"{hhist.recovery_errors}")
    steady = [ms / k for k, ms in got[0]["window_ms"][1:]]
    report = dict(
        strategy=strategy, steps=steps, schedule=events, trace=hist.steps,
        failures=hist.failures, loss=hist.loss, loss_host=hhist.loss,
        loss_max_rel_err=loss_err, omega_max_rel_err=omega_err,
        recovery_errors=hist.recovery_errors,
        recovery_errors_host=hhist.recovery_errors,
        recovery_rel_err=rec_err, restore_log=log, switches=switches,
        launches_by_rank=[res["launched"] for res in got],
        host_launches=host["launched"],
        step_ms_rank0=float(np.median(steady)) if steady else None,
        window_ms_rank0=got[0]["window_ms"],
        host_step_ms=float(np.median(host["record"]["step_ms"])),
        after_step_ms_by_rank=[res["after_step_ms"] for res in got],
        host_after_step_ms=host["record"]["after_step_ms"],
        recovery_ms_by_rank=[res["recovery_ms"] for res in got],
        host_recovery_ms=host["record"]["recovery_ms"],
        decisions_bytes_by_rank=[res["sent"].get("decisions", 0)
                                 for res in got],
        recovery_bytes_by_rank=[res["sent"].get("recovery", 0)
                                for res in got],
        peak_allocated_gib_by_rank=[res["peak_allocated_gib"] for res in got],
        peak_reserved_gib_by_rank=[res["peak_reserved_gib"] for res in got],
        host_peak_allocated_gib=host["peak_allocated_gib"],
        run_s_by_rank=[res["run_s"] for res in got])
    return problems, report


def phase_train_spmd_store() -> dict:
    """The strategies that snapshot or restore state, the gathered path and
    the MoE pipeline on the pipeline backend: one spawn of six ranks on the
    card against the host backend's runs of the same schedules.  Returns
    each path's launches, summed over the ranks."""
    work = tempfile.mkdtemp(prefix="chip_smoke_spmd_store_")
    try:
        dense = dict(SPMD, layers=SPMD_STORE_LAYERS)
        emit("train_spmd_store_cut", layers=SPMD_STORE_LAYERS,
             layers_published=get_config(SPMD["arch"]).num_layers,
             reason="at full depth the phase outgrew the host's memory and "
                    "the script's time (SPMD_STORE_LAYERS)")
        dense = cut_if_needed("train_spmd_store", dense, work,
                              **SPMD_STORE_HELD)
        moe_cfg = train_model_config(SPMD_MOE)
        emit("train_spmd_moe_cut", arch=moe_cfg.name,
             layers=moe_cfg.num_layers,
             layers_published=get_config(SPMD_MOE["arch"]).num_layers,
             reason="six ranks of its fp32 state, gradients and "
                    "activations share the one card")
        groups = {"train_spmd_store": (dense, SPMD_STORE_RUNS),
                  "train_spmd_gathered": (dense, SPMD_GATHERED_RUNS),
                  "train_spmd_moe": (SPMD_MOE, SPMD_MOE_RUNS)}
        host, runs = {}, []
        t0 = time.perf_counter()
        with HostMemoryLow() as host_mem:
            for spec, table in groups.values():
                for name, run in table.items():
                    host[name] = store_host_run(
                        spec, run, os.path.join(work, "host", name))
                    runs.append((name, spec, run,
                                 os.path.join(work, "spmd", name)))
        host_runs_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with HostMemoryLow() as spawn_mem:
            ranks = spawn_stages(spmd_store_rank, SPMD["stages"], runs,
                                 cuda=True, timeout_s=SPMD_STORE_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        problems, totals = [], {}
        for group, (spec, table) in groups.items():
            cfg = train_model_config(spec)
            reports = {}
            for name, run in table.items():
                bad, reports[name] = check_store_run(name, spec, run,
                                                     host[name], ranks)
                problems += [f"{name}: {p}" for p in bad]
            emit(group, arch=cfg.name, layers=cfg.num_layers,
                 layers_published=get_config(spec["arch"]).num_layers,
                 stages=spec["stages"], ranks=len(ranks),
                 batch=spec["batch"], seq=spec["seq"],
                 microbatch=spec["microbatch"], window=spec["window"],
                 runs=reports, spawn_s=spawn_s, host_runs_s=host_runs_s,
                 host_memory={"host_runs": host_mem.report(),
                              "spawn": spawn_mem.report()},
                 nvidia_smi=smi(),
                 timing="host clock: a step's ms the median over the "
                        "windows after the first of their ms (from the "
                        "dispatch, after a synchronize, to the end of the "
                        "drain) over their steps; after_step_ms around the "
                        "strategy's after_step (a save, where one fires: "
                        "the snapshot's device-to-host copy, then the "
                        "file or the memory tier) and recovery_ms around "
                        "its failure handler, each ending in a "
                        "synchronize; the host runs eager, host_step_ms "
                        "their median step")
            totals[group] = {}
            for name in table:
                for res in ranks:
                    for kernel, n in res[name]["launched"].items():
                        totals[group][kernel] = \
                            totals[group].get(kernel, 0) + n
        if problems:
            raise AssertionError("train_spmd_store: " + "; ".join(problems))
        return totals
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        empty_host_cache()


def remat_config(spec: dict):
    """The config of a train_remat run: cut to ``spec["layers"]`` (and as
    many encoder layers), a hybrid to one segment."""
    cfg = get_config(spec["arch"])
    layers = spec.get("layers") or cfg.attn_every
    kw = dict(num_layers=layers)
    if cfg.arch_type == "encdec":
        kw["num_encoder_layers"] = layers
    return cfg.replace(**kw)


def remat_expected(cfg, policy) -> dict:
    """The launches of one dry-run train_step: each flash and SSD kernel
    once a pass, the forwards of the checkpointed blocks again in the
    backward (all of them under "nothing"; under "dots" the flash forward's
    outputs are kept, and the encoder-decoder's decoder keeps nothing under
    either policy, as the JAX family), Adam's two kernels once."""
    attention, ssd = pass_launches(cfg)
    again_attn = again_ssd = 0
    if policy is not None:
        again_ssd = ssd
        if cfg.arch_type == "encdec":
            again_attn = 2 * cfg.num_layers
        elif policy == "nothing":
            again_attn = attention
    return {"flash_attention_fwd": attention + again_attn,
            "flash_attention_bwd_dq": attention,
            "flash_attention_bwd_dkv": attention, "stage_merge": 0,
            "ssd_scan": ssd + again_ssd, "ssd_scan_bwd": ssd,
            "adam_sumsq": 1, "adam_update": 1}


def remat_inputs(cfg, batch: int, seq: int) -> tuple:
    """(fp32 parameters drawn on the card from seed 0, Adam's state, one
    batch on the card: int32 tokens and labels, frames and patches in
    ``cfg.dtype``, as the dry-run's inputs)."""
    model = Model(cfg, device="cuda", weights=False)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    for p in TR.leaves(params):
        p.requires_grad_(True)
    plan = DR.plan_for(cfg, DR.INPUT_SHAPES["train_4k"], batch=batch, seq=seq)
    raw = next(make_batches(cfg, batch=batch, seq=plan["text"], seed=0))
    data = {k: torch.as_tensor(v).cuda() for k, v in raw.items()}
    for k in ("frames", "patches"):
        if k in data:
            data[k] = data[k].to(getattr(torch, cfg.dtype))
    return model, params, DR.init_state(params), data, plan


def finite(grads) -> bool:
    """Every gradient finite, read through one sum a leaf (a NaN or an
    infinity carries into the sum; ``isfinite`` of a whole leaf would
    allocate its absolute value and masks, GBs at full depth)."""
    return bool(torch.isfinite(torch.stack([g.sum() for g in grads])).all())


def remat_step(model, plan, ocfg, params, state, data, policy) -> dict:
    """One dry-run train_step under ``policy`` (None: remat off): loss,
    gradients, launches, host ms (ending in a synchronize), the step's
    ``max_memory_allocated()`` (bytes, and GiB)."""
    os.environ["REPRO_REMAT"] = policy or "nothing"
    step = DR.make_step_fn(model, plan, ocfg, remat=policy is not None)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = step(params, state, data)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    return {"loss": float(loss), "grads": grads, "launches": counts(),
            "ms": ms, "peak_b": peak, "peak_gib": peak / 2**30}


def remat_on_off(spec: dict, total: dict) -> None:
    """Remat off, then on under "nothing" and "dots", on one family."""
    cfg = remat_config(spec)
    model, params, state, data, plan = remat_inputs(cfg, spec["batch"],
                                                    spec["seq"])
    ocfg = OptimizerConfig(lr=0.0)
    want = None
    for policy in REMAT_POLICIES:
        run = remat_step(model, plan, ocfg, params, state, data, policy)
        for k, n in run["launches"].items():
            total[k] = total.get(k, 0) + n
        expected = remat_expected(cfg, policy)
        if run["launches"] != expected:
            raise AssertionError(f"train_remat {cfg.name} {policy}: "
                                 f"launches {run['launches']}, expected "
                                 f"{expected}")
        if not (math.isfinite(run["loss"]) and finite(run["grads"])):
            raise AssertionError(f"train_remat {cfg.name} {policy}: a loss "
                                 "or gradient is not finite")
        if want is None:
            want = (run["loss"], [g.cpu() for g in run["grads"]])
            err, equal, ok = 0.0, True, True
        else:
            loss_err = abs(run["loss"] - want[0])
            ok = loss_err <= REMAT_TOL * (1 + abs(want[0]))
            equal, err = run["loss"] == want[0], loss_err
            for g, w in zip(run["grads"], want[1]):
                w = w.to(g.device)
                good, e = within(g, w, REMAT_TOL)
                ok &= good
                equal &= bool(torch.equal(g, w))
                err = max(err, e)
                del w
        del run["grads"]
        emit("train_remat", part="remat_on_off", arch=cfg.name,
             layers=cfg.num_layers, d_model=cfg.d_model, **model_shape(cfg),
             batch=spec["batch"], seq=spec["seq"],
             remat=policy is not None, policy=policy, loss=run["loss"],
             max_abs_diff_vs_off=err, bit_equal_to_off=equal,
             tol=f"{REMAT_TOL} * (1 + |w|)", launches=run["launches"],
             peak_memory_gib=run["peak_gib"], step_ms=run["ms"])
        if not ok:
            raise AssertionError(f"train_remat {cfg.name} {policy}: remat "
                                 f"on against off differs by {err}")
    del model, params, state, data, want
    gc.collect()
    torch.cuda.empty_cache()


def remat_estimate(cfg, batch: int, seq: int) -> dict:
    """The dry-run's record at ``--mesh 1x1`` (meta tensors, "nothing")."""
    os.environ["REPRO_REMAT"] = "nothing"
    rec = DR.run_one(cfg.name, "train_4k", mesh="1x1", cfg=cfg, batch=batch,
                     seq=seq, verbose=False)
    if rec["status"] != "ok":
        raise AssertionError(f"train_remat: the dry-run of {cfg.name} "
                             f"failed: {rec.get('traceback', rec)}")
    return rec


def remat_depth(arch: str, free: int) -> tuple:
    """(config, its estimate): the published depth when its estimate, grown
    by REMAT_PEAK_TOL, fits ``free`` bytes, else the largest depth that
    does."""
    cfg = get_config(arch)
    for layers in range(cfg.num_layers, 0, -1):
        cut = cfg.replace(num_layers=layers)
        rec = remat_estimate(cut, REMAT_FULL_BATCH, REMAT_FULL_SEQ)
        if rec["memory"]["peak_est_B"] * (1 + REMAT_PEAK_TOL) <= free:
            return cut, rec
    raise AssertionError(f"train_remat: no depth of {arch} fits "
                         f"{free / 1e9:.1f} GB")


def remat_full_depth(cfg, rec: dict, total: dict) -> None:
    """REMAT_STEPS dry-run train_steps on the card ("nothing"), held
    against the estimate ``rec``."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model, params, state, data, plan = remat_inputs(cfg, REMAT_FULL_BATCH,
                                                    REMAT_FULL_SEQ)
    held = sum(t.untyped_storage().nbytes() for t in
               [*TR.leaves(params), *state.m, *state.v, state.step,
                *data.values()])
    other = torch.cuda.memory_allocated() - before - held
    ocfg = OptimizerConfig(warmup_steps=1, schedule="constant")
    losses, ms, launches, peaks = [], [], [], []
    for _ in range(REMAT_STEPS):
        run = remat_step(model, plan, ocfg, params, state, data, "nothing")
        if not finite(run["grads"]):
            raise AssertionError(f"train_remat {cfg.name}: a gradient is "
                                 "not finite")
        del run["grads"]
        losses.append(run["loss"])
        ms.append(run["ms"])
        launches.append(run["launches"])
        peaks.append(run["peak_b"])
        for k, n in run["launches"].items():
            total[k] = total.get(k, 0) + n
    # the steps' own peaks, from a reset before each step to its end
    peak = max(peaks) - before - other
    reserved = torch.cuda.max_memory_reserved()
    est = rec["memory"]["peak_est_B"]
    step_ms = float(np.median(ms[1:]))
    tokens = REMAT_FULL_BATCH * REMAT_FULL_SEQ
    predicted = dict(rec["kernels"])
    emit("train_remat", part="full_depth", arch=cfg.name,
         layers=cfg.num_layers,
         layers_published=get_config(cfg.name).num_layers,
         cut=cfg.num_layers != get_config(cfg.name).num_layers,
         d_model=cfg.d_model, **model_shape(cfg), params=cfg.param_count(),
         batch=REMAT_FULL_BATCH, seq=REMAT_FULL_SEQ, policy="nothing",
         loss=losses, step_ms=ms, step_ms_median_after_first=step_ms,
         tokens_per_s=tokens / step_ms * 1e3, launches=launches,
         max_memory_allocated_gib=peak / 2**30,
         max_memory_reserved_gib=reserved / 2**30,
         other_allocated_b=other, estimate_peak_gib=est / 2**30,
         estimate_over_measured=est / peak, tol=REMAT_PEAK_TOL,
         estimate_flops=rec["cost"]["flops_per_dev"],
         flops_bound_ms=rec["roofline"]["compute_s"] * 1e3,
         bytes_bound_ms=rec["roofline"]["memory_s"] * 1e3,
         nvidia_smi=smi(),
         timing="host clock around the dry-run's train_step ending in "
                "torch.cuda.synchronize(); median of the steps after the "
                "first")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train_remat {cfg.name}: the loss does not "
                             f"fall over {REMAT_STEPS} steps: {losses}")
    if abs(est / peak - 1) > REMAT_PEAK_TOL:
        raise AssertionError(f"train_remat {cfg.name}: the estimate's peak "
                             f"{est / 2**30:.2f} GiB against "
                             f"max_memory_allocated {peak / 2**30:.2f} GiB")
    for n in launches:
        got = {k: v for k, v in n.items() if v}
        if got != predicted:
            raise AssertionError(f"train_remat {cfg.name}: launches {got}, "
                                 f"the dry-run's {predicted}")
    del model, params, state, data
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_remat() -> dict:
    """Remat on against off in every family, then the dry-run's estimate
    and the same step at full depth on the card.  Returns the launches of
    all the phase's steps."""
    total: dict = {}
    prev = os.environ.get("REPRO_REMAT")
    try:
        for spec in REMAT_RUNS:
            remat_on_off(spec, total)
        cut = REMAT_ESTIMATE_CUT
        cfg = get_config(cut["arch"]).replace(num_layers=cut["layers"])
        rec = remat_estimate(cfg, cut["batch"], cut["seq"])
        emit("train_remat", part="estimate", arch=cfg.name,
             layers=cfg.num_layers, batch=cut["batch"], seq=cut["seq"],
             memory=rec["memory"], flops=rec["cost"]["flops_per_dev"],
             kernels=rec["kernels"], trace_s=rec["trace_s"])
        gc.collect()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        for arch in REMAT_FULL:
            cfg, rec = remat_depth(arch, free)
            emit("train_remat", part="estimate", arch=arch,
                 layers=cfg.num_layers,
                 layers_published=get_config(arch).num_layers,
                 fits_at_full_depth=(cfg.num_layers
                                     == get_config(arch).num_layers),
                 card_free_b=free, batch=REMAT_FULL_BATCH,
                 seq=REMAT_FULL_SEQ, memory=rec["memory"],
                 flops=rec["cost"]["flops_per_dev"], kernels=rec["kernels"],
                 trace_s=rec["trace_s"])
            remat_full_depth(cfg, rec, total)
    finally:
        if prev is None:
            os.environ.pop("REPRO_REMAT", None)
        else:
            os.environ["REPRO_REMAT"] = prev
    return total


def replayed_launches(windows: list, counted: dict) -> dict:
    """The launches that ran: the wrappers count each launch a capture
    recorded once (the capture ran nothing), and each replay ran them all
    again."""
    out = dict(counted)
    for w in windows:
        for name, n in w.recorded_launches.items():
            out[name] += (w.replays - w.captures) * n
    return out


@contextlib.contextmanager
def windows_made(into: list):
    """Every ``FusedWindow`` built inside, appended to ``into``."""
    init = FusedWindow.__init__

    def recording(self, *args, **kw):
        init(self, *args, **kw)
        into.append(self)

    FusedWindow.__init__ = recording
    try:
        yield into
    finally:
        FusedWindow.__init__ = init


def guarded_run(guarded: bool) -> dict:
    """One GUARDED run (under ``guard.guarded()`` or not), each window
    timed on the host clock from its dispatch to the end of its drain with
    no synchronize of its own (the drain waits for the window)."""
    spec = GUARDED
    cfg = get_config(spec["arch"])
    tcfg = train_config("checkfree", spec["steps"], stages=spec["stages"],
                        batch=spec["batch"], seq=spec["seq"],
                        window=spec["window"])
    trainer = Trainer(Model(cfg, device="cuda", weights=False), tcfg,
                      schedule=Forced(spec["schedule"]))
    runner = trainer.window
    dispatch, drain = runner.dispatch, runner.drain
    window_ms, t0 = [], [0.0]

    def timed_dispatch(state, stacked, **kw):
        t0[0] = time.perf_counter()
        return dispatch(state, stacked, **kw)

    def timed_drain(pending):
        out = drain(pending)
        window_ms.append((pending.k, (time.perf_counter() - t0[0]) * 1e3))
        return out

    runner.dispatch, runner.drain = timed_dispatch, timed_drain
    batches = make_batches(cfg, batch=spec["batch"], seq=spec["seq"], seed=0)
    torch.cuda.synchronize()
    before = dict(TR.explicit_counts)
    zero_counts()
    t_run = time.perf_counter()
    with (guard.guarded() if guarded else contextlib.nullcontext()):
        mode = torch.cuda.get_sync_debug_mode()
        state, hist = trainer.run(batches)
    run_s = time.perf_counter() - t_run
    launched = replayed_launches([runner], counts())
    sections = {k: n - before.get(k, 0) for k, n in TR.explicit_counts.items()
                if n != before.get(k, 0)}
    steady = [ms / k for i, (k, ms) in enumerate(window_ms)
              if i > 0 and k == spec["window"]]
    out = {"hist": hist, "launched": launched, "sections": sections,
           "mode": mode, "captures": guard.captured_graph_count(trainer),
           "window_ms": window_ms, "ms_per_step": float(np.median(steady)),
           "run_s": run_s, "kept_cache": runner.kept_cache}
    guard.assert_capture_bound(trainer, 1, what=f"train_guarded "
                               f"({'guarded' if guarded else 'unguarded'})")
    del trainer, state, runner
    gc.collect()                     # the timed window holds a cycle
    torch.cuda.empty_cache()
    return out


def phase_train_guarded() -> dict:
    """GUARDED under the guard and without it: no implicit sync (the
    guarded run raises on one), one capture, the merge, the same losses bit
    for bit.  Returns the guarded run's launches."""
    spec = GUARDED
    cfg = get_config(spec["arch"])
    card = smi()
    runs = {"guarded": guarded_run(True), "unguarded": guarded_run(False)}
    g, u = runs["guarded"], runs["unguarded"]
    failures = [(s, st) for s in sorted(spec["schedule"])
                for st in spec["schedule"][s]]
    tokens = spec["batch"] * spec["seq"]
    emit("train_guarded", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=cfg.num_heads,
         head_dim=cfg.resolved_head_dim,
         stages=spec["stages"], params=cfg.param_count(), dtype=cfg.dtype,
         masters="float32", strategy="checkfree", batch=spec["batch"],
         seq=spec["seq"], steps=spec["steps"], fuse_window=spec["window"],
         schedule=spec["schedule"], implicit_syncs=0,
         sync_debug_mode_guarded=g["mode"],
         sync_debug_mode_unguarded=u["mode"],
         explicit_sections=g["sections"],
         explicit_sections_unguarded=u["sections"],
         dispatches=g["hist"].dispatches, captures=g["captures"],
         captures_unguarded=u["captures"], kept_cache=g["kept_cache"],
         failures=g["hist"].failures,
         recovery_errors=g["hist"].recovery_errors,
         merge_launches=g["launched"]["stage_merge"], launches=g["launched"],
         loss=g["hist"].loss, loss_bit_equal=g["hist"].loss == u["hist"].loss,
         window_ms=g["window_ms"], window_ms_unguarded=u["window_ms"],
         ms_per_step=g["ms_per_step"],
         ms_per_step_unguarded=u["ms_per_step"],
         tokens_per_s=tokens / g["ms_per_step"] * 1e3,
         tokens_per_s_unguarded=tokens / u["ms_per_step"] * 1e3,
         run_s=g["run_s"], run_s_unguarded=u["run_s"], nvidia_smi=card,
         timing="window_ms: host clock from the window's dispatch to the "
                "end of its drain (no synchronize of its own: the drain "
                "waits for the window); ms_per_step: the median over the "
                "full windows after the first (which runs the eager step "
                "and the capture) of ms / 8")
    problems = []
    for name, run in runs.items():
        h = run["hist"]
        if len(h.loss) != spec["steps"] or                 not all(math.isfinite(x) for x in h.loss):
            problems.append(f"{name}: losses {h.loss}")
        if [tuple(f) for f in h.failures] != failures or                 len(h.recovery_errors) != 1:
            problems.append(f"{name}: failures {h.failures}, recovery "
                            f"errors {h.recovery_errors}")
        if run["launched"]["stage_merge"] != 1:
            problems.append(f"{name}: merge launches "
                            f"{run['launched']['stage_merge']}")
        if run["captures"] != 1:
            problems.append(f"{name}: {run['captures']} captures")
    if g["mode"] != 2:
        problems.append(f"the guarded run's sync debug mode {g['mode']}")
    if g["hist"].loss != u["hist"].loss:
        problems.append("the guarded and unguarded losses differ")
    if g["sections"].get("drain") !=             g["hist"].dispatches + len(g["hist"].recovery_errors):
        problems.append(f"drains {g['sections']} against "
                        f"{g['hist'].dispatches} dispatches")
    if g["sections"].get("capture") != 1:
        problems.append(f"capture sections {g['sections']}")
    if problems:
        raise AssertionError("train_guarded: " + "; ".join(problems))
    return g["launched"]


def load_example(name: str):
    """``examples/<name>.py`` as a module (``examples`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples() -> dict:
    """Each port example's ``main`` on the card, its output captured.
    Returns the launches of all of them (the windows' replays counted)."""
    card = smi()
    windows: list = []
    zero_counts()
    results, problems = {}, []
    with windows_made(windows):
        for name, argv in EXAMPLES:
            out = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                got = load_example(name).main([*argv, "--device", "cuda"])
            torch.cuda.synchronize()
            results[name] = (got, time.perf_counter() - t0,
                             len(out.getvalue().splitlines()))
    launched = replayed_launches(windows, counts())
    graphs = {"windows": len(windows),
              "captures": sum(w.captures for w in windows),
              "replays": sum(w.replays for w in windows)}
    del windows
    gc.collect()
    torch.cuda.empty_cache()

    losses = {}
    quick, rec = results["torch_quickstart"][0],         results["torch_recovery_demo"][0]
    losses["torch_quickstart"] = quick["loss"]
    losses["torch_recovery_demo"] = [rec["trained_loss"], rec["base_loss"]] + [
        x for r in rec["rows"] for x in (r["loss_at_reinit"],
                                         r["loss_after_20"])]
    failures = {}
    for name in ("torch_spot_trace_demo", "torch_train_with_failures"):
        got = results[name][0]
        for strategy, h in got["hists"].items():
            losses[f"{name}:{strategy}"] = h.loss + [
                e for _, _, e in h.eval_loss]
            if name == "torch_train_with_failures":
                sched = got["schedules"][strategy]
                want = [(w, s) for w in range(h.wall_iters)
                        for s in sorted(sched.at(w))]
                failures[strategy] = {"got": [list(f) for f in h.failures],
                                      "schedule": [list(f) for f in want]}
                if [tuple(f) for f in h.failures] != want:
                    problems.append(f"train_with_failures {strategy}: "
                                    f"failures {h.failures}, its schedule "
                                    f"{want}")
    serve = results["torch_serve_batched"][0]["rows"]
    shapes = {r["arch"]: list(r["tokens"].shape) for r in serve}
    for key, xs in losses.items():
        if not xs or not all(math.isfinite(x) for x in xs):
            problems.append(f"{key}: losses {xs}")
    if any(s != [4, 12] for s in shapes.values()):
        problems.append(f"serve_batched token shapes {shapes}")
    if launched["stage_merge"] < 1:
        problems.append("no merge ran")
    full = results["torch_train_with_failures"][0]["cfg"]
    emit("examples", nvidia_smi=card,
         wall_s={name: r[1] for name, r in results.items()},
         printed_lines={name: r[2] for name, r in results.items()},
         argv={name: argv for name, argv in EXAMPLES},
         train_with_failures_model=dict(
             arch=full.name, layers=full.num_layers, d_model=full.d_model,
             params=full.param_count(), dtype=full.dtype),
         train_with_failures_rows=results["torch_train_with_failures"][0][
             "rows"],
         spot_trace_rows=results["torch_spot_trace_demo"][0]["rows"],
         quickstart_recovery_errors=quick["recovery_errors"],
         recovery_demo_rows=rec["rows"],
         serve_rows=[{k: v for k, v in r.items() if k != "tokens"}
                     for r in serve],
         serve_token_shapes=shapes, failures=failures,
         graphs=graphs, launches=launched,
         timing="wall_s: host clock around each example's main, between two "
                "synchronizes (the examples' own set-up, kernels already "
                "built)")
    if problems:
        raise AssertionError("examples: " + "; ".join(problems))
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs the "
              "card", file=sys.stderr)
        return 1
    card = phase_env()
    phase_build()
    fwd = phase_kernel()
    dq, dkv = phase_kernel_bwd()
    merge = phase_kernel_merge()
    adam_rows = phase_kernel_adam()
    ssd = phase_kernel_ssd()
    ssd_bwd = phase_kernel_ssd_bwd()
    phase_model()
    serve = phase_serve(SERVE, "serve")
    ssm = phase_serve(SERVE_SSM, "serve_ssm")
    hybrid = phase_serve(SERVE_HYBRID, "serve_hybrid")
    gemma = phase_serve(SERVE_GEMMA, "serve_gemma")
    danube = phase_serve(SERVE_DANUBE, "serve_danube")
    phase_model_moe()
    moe = phase_serve(SERVE_MOE, "serve_moe")
    deepseek = phase_serve(SERVE_DEEPSEEK, "serve_deepseek")
    whisper = phase_serve(SERVE_WHISPER, "serve_whisper")
    vlm = phase_serve(SERVE_VLM, "serve_vlm")
    ssd["max_abs_err"] = max(ssd["max_abs_err"], ssm["ssd_err"],
                             hybrid["ssd_err"])
    fwd["max_abs_err"] = max(fwd["max_abs_err"], serve["attn_err"],
                             hybrid["attn_err"], gemma["attn_err"],
                             danube["attn_err"], moe["attn_err"],
                             deepseek["attn_err"], whisper["attn_err"],
                             vlm["attn_err"])
    phase_train_model()
    trained = {"train": phase_train(),
               "train_fused": phase_train_fused(),
               "train_telemetry": phase_train_telemetry(),
               "train_elastic": phase_train_elastic(),
               "train_gemma": phase_train_checkfree(TRAIN_GEMMA,
                                                    "train_gemma"),
               "train_danube": phase_train_checkfree(TRAIN_DANUBE,
                                                     "train_danube"),
               "train_ssm": phase_train_ssm(),
               "train_hybrid": phase_train_checkfree(TRAIN_HYBRID,
                                                     "train_hybrid"),
               "train_moe": phase_train_moe(),
               "train_deepseek": phase_train_checkfree(TRAIN_DEEPSEEK,
                                                       "train_deepseek"),
               "train_whisper": phase_train_whisper(),
               "train_vlm": phase_train_checkfree(TRAIN_VLM, "train_vlm"),
               "train_ckpt": phase_train_ckpt(),
               "train_neighbor": phase_train_neighbor(),
               "train_spmd": phase_train_spmd(),
               **phase_train_spmd_store(),
               "train_remat": phase_train_remat(),
               "train_guarded": phase_train_guarded(),
               "examples": phase_examples()}
    # launches: the training paths; by path: every path that ran it
    for row in (fwd, dq, dkv, merge, ssd, ssd_bwd, *adam_rows):
        by_path = {path: n[row["name"]] for path, n in trained.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    fwd["launches_by_path"] = {
        "serve": serve["launches"]["flash_attention_fwd"],
        "serve_hybrid": hybrid["launches"]["flash_attention_fwd"],
        "serve_gemma": gemma["launches"]["flash_attention_fwd"],
        "serve_danube": danube["launches"]["flash_attention_fwd"],
        "serve_moe": moe["launches"]["flash_attention_fwd"],
        "serve_deepseek": deepseek["launches"]["flash_attention_fwd"],
        "serve_whisper": whisper["launches"]["flash_attention_fwd"],
        "serve_vlm": vlm["launches"]["flash_attention_fwd"],
        **fwd["launches_by_path"]}
    ssd["launches_by_path"] = {"serve_ssm": ssm["launches"]["ssd_scan"],
                               "serve_hybrid": hybrid["launches"]["ssd_scan"],
                               **ssd["launches_by_path"]}
    ssd["launches"] = sum(ssd["launches_by_path"].values())
    rows = [fwd, dq, dkv, merge, ssd, ssd_bwd, *adam_rows]
    if any(row["launches"] <= 0 for row in rows):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{[(r['name'], r['launches']) for r in rows]}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
