"""The mesh's two collectives, on lists of per-shard tensors.

The mesh is one process driving a list of devices (``make_mesh``), so a
collective is a set of device-to-device copies, each issued on the
current streams.  PyTorch's copy between two CUDA devices is ordered
both ways by events: it runs on the source's current stream after an
event of the destination's current stream, and the destination's
current stream waits for the copy's end.  So a shard's tensor may be
sent while its producer is still queued, and the receiver may use the
copy at once.  Where the devices are the same, a copy is no copy at
all.
"""

from __future__ import annotations

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
