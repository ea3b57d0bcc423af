"""The stage group's transfers over gloo, staged through host memory.

Gloo moves host memory.  On the card each transfer is staged: the CUDA
tensors are copied into pinned host buffers (one synchronize before the
sends), gloo sends, receives or reduces the host buffers, and the results
are copied back to the card with ``non_blocking=True`` and one synchronize
(after which the buffers may be reused).  Buffers are kept by role and
shape and reused from one tick to the next.  This host staging is the price
of running several ranks on one card, where NCCL refuses to; on the CPU the
tensors go as they are.

:class:`Transport` counts the bytes this rank sends by kind (``activation``,
``gradient``, ``allreduce``, ...) and the host seconds its calls take,
staging and waiting for the peer included.  For a reduction the count is
the payload reduced.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import StageGroup

# one op of an exchange: ("send", peer, tensor) or ("recv", peer, shape, dtype)
Op = Tuple

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


class Transport:
    """Point-to-point exchanges and collectives of one rank of ``sg``, for
    tensors on ``device``."""

    def __init__(self, sg: StageGroup, device: torch.device):
        self.rank, self.size, self.group = sg.rank, sg.size, sg.group
        self.device = device
        self.cuda = device.type == "cuda"
        self._buffers: Dict[tuple, torch.Tensor] = {}
        #: bytes this rank sent (or reduced), and host seconds, by kind
        self.sent: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()

    def reset_counts(self) -> None:
        self.sent.clear()
        self.seconds.clear()

    # ---- host staging (the card only) --------------------------------------
    def _buffer(self, key: tuple, shape, dtype, keep: bool) -> torch.Tensor:
        if not keep:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        full = (*key, tuple(shape), dtype)
        buf = self._buffers.get(full)
        if buf is None:
            buf = self._buffers[full] = torch.empty(shape, dtype=dtype,
                                                    pin_memory=True)
        return buf

    def _sync(self) -> None:
        torch.cuda.current_stream(self.device).synchronize()

    # ---- point to point -------------------------------------------------
    def exchange(self, ops: Sequence[Op], kind: str, *,
                 keep: bool = True) -> List[torch.Tensor]:
        """One ``dist.batch_isend_irecv`` of ``ops``, in the order given
        (every rank lists its part of one global order) -> the received
        tensors on the device, in order.  ``keep``: reuse this exchange's
        host buffers next time (False for one-off transfers)."""
        if not ops:
            return []
        t0 = time.perf_counter()
        staged, p2p, recvs = [], [], []
        for i, op in enumerate(ops):
            if op[0] == "send":
                _, peer, t = op
                if self.cuda:
                    buf = self._buffer(("send", i), t.shape, t.dtype, keep)
                    buf.copy_(t, non_blocking=True)
                    t = buf
                else:
                    t = t.detach().contiguous()
                staged.append((peer, t))
                self.sent[kind] += t.numel() * t.element_size()
            else:
                _, peer, shape, dtype = op
                buf = (self._buffer(("recv", i), shape, dtype, keep)
                       if self.cuda else torch.empty(shape, dtype=dtype))
                recvs.append(buf)
                staged.append((peer, buf))
        if self.cuda:
            self._sync()                    # the sends' host copies landed
        for op, (peer, t) in zip(ops, staged):
            fn = dist.isend if op[0] == "send" else dist.irecv
            p2p.append(dist.P2POp(fn, t, peer, self.group))
        for work in dist.batch_isend_irecv(p2p):
            work.wait()
        out = recvs
        if self.cuda and recvs:
            out = [b.to(self.device, non_blocking=True) for b in recvs]
            self._sync()                    # the buffers may be reused
        self.seconds[kind] += time.perf_counter() - t0
        return out

    # ---- collectives ------------------------------------------------------
    def all_reduce_(self, tensors: Sequence[torch.Tensor], kind: str) -> None:
        """Sum ``tensors`` over the group, in place: one all-reduce of one
        flat buffer per dtype (nothing to do in a group of one)."""
        if self.size == 1:
            return
        t0 = time.perf_counter()
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for dtype, group in by_dtype.items():
            n = sum(t.numel() for t in group)
            if self.cuda:
                flat = self._buffer(("allreduce",), (n,), dtype, True)
            else:
                flat = torch.empty((n,), dtype=dtype)
            off = 0
            for t in group:
                flat[off:off + t.numel()].view_as(t).copy_(
                    t, non_blocking=self.cuda)
                off += t.numel()
            if self.cuda:
                self._sync()
            dist.all_reduce(flat, group=self.group)
            off = 0
            for t in group:
                t.copy_(flat[off:off + t.numel()].view_as(t),
                        non_blocking=self.cuda)
                off += t.numel()
            if self.cuda:
                self._sync()
            self.sent[kind] += n * flat.element_size()
        self.seconds[kind] += time.perf_counter() - t0

    def reduce_numbers(self, values: Sequence[float], op: str,
                       kind: str) -> List[float]:
        """Host numbers combined over the group element-wise by ``op``
        ("sum" or "min") in float64 -> the same list on every rank.
        They never touch the card, so the reduction runs on the host on
        both devices."""
        vec = torch.tensor([float(v) for v in values], dtype=torch.float64)
        if self.size > 1:
            t0 = time.perf_counter()
            dist.all_reduce(vec, op=_REDUCE_OPS[op], group=self.group)
            self.sent[kind] += vec.numel() * vec.element_size()
            self.seconds[kind] += time.perf_counter() - t0
        return vec.tolist()

    def all_gather(self, t: torch.Tensor, kind: str) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on all ranks), by rank, on the
        device."""
        if self.size == 1:
            return [t]
        t0 = time.perf_counter()
        src = t.detach().contiguous()
        if self.cuda:
            src = src.to("cpu")             # a one-off copy, synchronizing
        outs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(outs, src, group=self.group)
        if self.cuda:
            outs = [o.to(self.device) for o in outs]
        self.sent[kind] += src.numel() * src.element_size()
        self.seconds[kind] += time.perf_counter() - t0
        return outs
