"""The mesh's two collectives: on lists of per-shard tensors within one
process, and between the processes of a cluster.

The single-process mesh is one process driving a list of devices
(``make_mesh``), so a collective is a set of device-to-device copies,
each issued on the current streams.  PyTorch's copy between two CUDA
devices is ordered both ways by events: it runs on the source's current
stream after an event of the destination's current stream, and the
destination's current stream waits for the copy's end.  So a shard's
tensor may be sent while its producer is still queued, and the receiver
may use the copy at once.  Where the devices are the same, a copy is no
copy at all.

A cluster (``parallel.multihost``) runs one process per host, each
holding a contiguous run of the mesh's shards; ``CrossProcess`` moves a
tensor between the processes over a ``torch.distributed`` group: NCCL
where no two processes share a card, else gloo, which takes CUDA tensors
through pinned host buffers (``staged``).
"""

from __future__ import annotations

import time

import torch


def ring_permute(tails: list[torch.Tensor]) -> list[torch.Tensor]:
    """Shard i receives the tail of shard i-1 (shard 0 that of the last
    shard), on shard i's device."""
    n = len(tails)
    return [tails[(i - 1) % n].to(tails[i].device, non_blocking=True)
            for i in range(n)]


def all_gather(parts: list[torch.Tensor],
               devices: list[torch.device]) -> list[torch.Tensor]:
    """The concatenation (along dim 0) of every shard's part, on each
    shard's device.  It is formed once per distinct device: shards that
    share a device share one tensor."""
    out: dict[torch.device, torch.Tensor] = {}
    for d in devices:
        if d not in out:
            out[d] = torch.cat([p.to(d, non_blocking=True) for p in parts])
    return [out[d] for d in devices]


class CrossProcess:
    """The ring and the all-gather between the processes of ``group``
    (every process of the cluster, one rank each).

    ``staged``: the group is gloo and the tensors are on a card, so each
    call copies its input to a pinned host buffer, waits for the copy,
    exchanges host buffers, and copies the result back to the card
    without blocking.  A pinned buffer is written again only after a
    later call's wait on the same stream, which the copy back from it
    precedes, so one buffer per name and shape serves every step.

    ``seconds`` adds up the host's wall time of the staged calls by
    part: ``wait`` for the work queued before the call (the producers),
    ``d2h`` the copy to the host, ``exchange`` the gloo call, ``h2d``
    the issue of the copy back (its device time is the card's)."""

    def __init__(self, group, rank: int, size: int, backend: str,
                 staged: bool):
        self.group = group
        self.rank = rank
        self.size = size
        self.backend = backend
        self.staged = staged
        self._host: dict[tuple, torch.Tensor] = {}
        self.seconds = {"wait": 0.0, "d2h": 0.0, "exchange": 0.0,
                        "h2d": 0.0}

    # ---------------------------------------------------------------- wire
    def _pinned(self, name: str, like: torch.Tensor,
                shape: tuple | None = None) -> torch.Tensor:
        shape = tuple(like.shape) if shape is None else shape
        key = (name, shape, like.dtype)
        buf = self._host.get(key)
        if buf is None:
            buf = self._host[key] = torch.empty(shape, dtype=like.dtype,
                                                pin_memory=True)
        return buf

    def _down(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """``t`` as the group's backend takes it: itself, or (staged) a
        pinned host copy whose copy has ended."""
        if not (self.staged and t.is_cuda):
            return t
        stream = torch.cuda.current_stream(t.device)
        t0 = time.perf_counter()
        stream.synchronize()
        t1 = time.perf_counter()
        h = self._pinned(name, t)
        h.copy_(t, non_blocking=True)
        stream.synchronize()
        self.seconds["wait"] += t1 - t0
        self.seconds["d2h"] += time.perf_counter() - t1
        return h

    def _up(self, h: torch.Tensor, device: torch.device) -> torch.Tensor:
        if h.device == device:
            return h
        t0 = time.perf_counter()
        out = h.to(device, non_blocking=True)
        self.seconds["h2d"] += time.perf_counter() - t0
        return out

    def _recv_buffer(self, name: str, like: torch.Tensor,
                     shape: tuple) -> torch.Tensor:
        if self.staged and like.is_cuda:
            return self._pinned(name, like, shape)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _timed(self, fn):
        if not self.staged:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        self.seconds["exchange"] += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------- collectives
    def ring(self, tail: torch.Tensor) -> torch.Tensor:
        """Send ``tail`` to the next rank; return the previous rank's
        (rank 0 receives the last rank's), on ``tail``'s device."""
        import torch.distributed as dist

        # as bytes: NCCL has no int16 (the s16 wire format's samples)
        raw = tail.contiguous().view(-1).view(torch.uint8)
        send = self._down(raw, "ring_send")
        recv = self._recv_buffer("ring_recv", raw, tuple(raw.shape))
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size

        def exchange():
            ops = [dist.P2POp(dist.isend, send, nxt, self.group),
                   dist.P2POp(dist.irecv, recv, prv, self.group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        self._timed(exchange)
        return self._up(recv, tail.device).view(tail.dtype).view(tail.shape)

    def all_gather(self, part: torch.Tensor) -> torch.Tensor:
        """Every rank's ``part`` ([k, ...], the same shape on every
        rank) concatenated along dim 0 in rank order, on ``part``'s
        device."""
        import torch.distributed as dist

        cplx = part.is_complex()
        x = torch.view_as_real(part) if cplx else part
        send = self._down(x.contiguous(), "gather_send")
        shape = (self.size * x.shape[0],) + tuple(x.shape[1:])
        out = self._recv_buffer("gather_recv", x, shape)

        def exchange():
            if self.backend == "nccl":
                dist.all_gather_into_tensor(out, send, group=self.group)
            else:
                dist.all_gather(list(out.view((self.size,) + tuple(
                    x.shape)).unbind(0)), send, group=self.group)
        self._timed(exchange)
        out = self._up(out, part.device)
        return torch.view_as_complex(out) if cplx else out
