"""The stage group of the pipeline-parallel backend: one process per stage.

The counterpart of ``repro.launch.mesh.make_host_pipeline_mesh``.  JAX runs
one controller over a 1-D ``("stage",)`` mesh of K devices; here each stage
is a process, a rank of a ``torch.distributed`` group whose rank is its
stage, and every rank runs the same training loop (multi-controller).

The group is gloo's, on the CPU and on the card alike: gloo moves host
memory, so on the card every transfer is staged through pinned host buffers
(``pipeline/transport.py``).  NCCL would need one card per rank: it refuses
two ranks on one GPU.

:func:`spawn_stages` starts the K ranks with the ``spawn`` start method
(never ``fork``: a parent that has touched CUDA cannot fork a child that
uses it), each joining the group over a ``FileStore`` in a directory of the
run's own.  A rank that raises fails the whole run with its traceback; a
run that outlasts its timeout is killed, every rank of it.  There is no way
to go on without a rank.  ``force_host_devices`` of the JAX module has no
counterpart: it is an XLA flag.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.telemetry import log

#: the default time for the whole run
DEFAULT_TIMEOUT_S = 1800.0
#: the longest a rank waits in one transfer or collective before it raises
COLLECTIVE_TIMEOUT_S = 600.0
#: after a rank fails, how long the others may take to fail too
GRACE_S = 5.0


@dataclasses.dataclass(frozen=True)
class StageGroup:
    """This process's place in the stage group: ``rank`` is its stage."""
    rank: int
    size: int
    group: Any = None              # the process group (None: the default)


def make_stage_group(num_stages: int, group=None) -> StageGroup:
    """The stage group of ``num_stages`` ranks: ``group`` or the default
    process group.  Raises, as the JAX mesh does, when there are fewer ranks
    than stages (a process without a group is one rank)."""
    joined = dist.is_available() and dist.is_initialized()
    size = dist.get_world_size(group) if joined else 1
    if size < num_stages:
        raise RuntimeError(
            f"spmd backend needs one device per stage: num_stages="
            f"{num_stages} but only {size} rank(s) are in the stage group. "
            "Start one rank per stage (repro_torch.launch.mesh.spawn_stages), "
            "or reduce num_stages.")
    if size > num_stages:
        raise RuntimeError(
            f"spmd backend runs one rank per stage: num_stages={num_stages} "
            f"but the stage group has {size} ranks")
    return StageGroup(dist.get_rank(group) if joined else 0, size, group)


def _rank_main(fn: Callable, rank: int, num_stages: int, workdir: str,
               args: tuple, cuda: bool, timeout_s: Optional[float]) -> None:
    """One rank: join the group, run ``fn(rank, *args)``, leave its result
    (or its traceback) in ``workdir`` and exit non-zero on an error."""
    try:
        if cuda:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            # the ranks share the cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_stages))
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(workdir, "store"),
            rank=rank, world_size=num_stages,
            timeout=datetime.timedelta(seconds=min(
                timeout_s or COLLECTIVE_TIMEOUT_S, COLLECTIVE_TIMEOUT_S)))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        path = os.path.join(workdir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    except BaseException:
        text = traceback.format_exc()
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(text)
        log(f"stage rank {rank}:\n{text}")
        sys.exit(1)


def _failure(workdir: str, rank: int, code: int, num_stages: int) -> str:
    err = os.path.join(workdir, f"rank{rank}.err")
    text = (open(err).read() if os.path.exists(err) else
            "(no traceback: the rank was killed)")
    return f"stage rank {rank} of {num_stages} exited with code {code}:\n{text}"


def spawn_stages(fn: Callable, num_stages: int, *args: Any,
                 cuda: bool = False,
                 timeout_s: Optional[float] = DEFAULT_TIMEOUT_S,
                 workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``num_stages`` spawned ranks of one gloo
    group -> each rank's return value, by rank.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).  With
    ``cuda`` every kernel is built here first, so that the ranks do not all
    build at once, and rank r computes on card ``r % device_count``;
    without it the ranks share the cores' intra-op threads.
    Raises RuntimeError with the rank's traceback when a rank fails, and
    TimeoutError after ``timeout_s`` (None: no deadline for the run; a rank
    still raises after COLLECTIVE_TIMEOUT_S in one transfer, so a hung peer
    fails the run); every rank still running is killed.
    The store and results go in ``workdir`` (default: a directory of the
    run's own under ``TMPDIR``, removed at the end).
    """
    if cuda:
        from repro_torch.kernels import build
        build.build()
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="repro_torch_stages_") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, num_stages, workdir, args, cuda,
                               timeout_s))
             for r in range(num_stages)]
    try:
        for p in procs:
            p.start()
        deadline = (math.inf if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                # the others fail soon after (their peer is gone): give them
                # a moment, so that every traceback, the first cause's too,
                # is in the error
                grace = time.monotonic() + GRACE_S
                while any(p.exitcode is None for p in procs) and \
                        time.monotonic() < grace:
                    mpc.wait([p.sentinel for p in procs if p.exitcode is None],
                             timeout=max(grace - time.monotonic(), 0.0))
                raise RuntimeError("\n".join(
                    _failure(workdir, r, p.exitcode, num_stages)
                    for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0)))
            if all(c == 0 for c in codes):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"stage ranks {[r for r, c in enumerate(codes) if c is None]}"
                    f" of {num_stages} still running after {timeout_s:.0f} s")
            mpc.wait([p.sentinel for p in procs if p.exitcode is None],
                     timeout=min(left, 1.0))
        results = []
        for r in range(num_stages):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
