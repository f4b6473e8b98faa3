"""Carry state between this package and the JAX package as numpy trees.

The server has no weights; what it carries from step to step is its
per-channel DSP state, the channel table and the waterfall view table.
``state_from_numpy`` takes the JAX package's ``HopState``,
``ChannelTable`` or ``WaterfallViews`` with numpy leaves (for example
``jax.tree.map(np.asarray, state)``) and returns this package's type on
a device; ``state_to_numpy`` returns this package's state with numpy
leaves, fields named as in the JAX package.  Nothing here imports JAX:
the JAX types are read by their field names (the noise processor's
carries by theirs: ``NRState``, ``ANRState`` or ``NBState``).
``sharded_state_from_numpy`` and ``sharded_state_to_numpy`` do the same
for the mesh's ``ShardedHopState``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops import convert
from .ops.agc import AGCState, DCBlockerState
from .ops.anr import ANRState
from .ops.channelizer import ChannelState
from .ops.nb import NBState
from .ops.nr import NRState
from .ops.polyphase import DecimatorState
from .ops.rds import RDSState
from .ops.stereo import StereoState
from .parallel.sharded import ShardedHopState
from .pipeline import (
    AudioState, HopState, WaterfallViews, channels_from_numpy, map_rows,
    to_device,
)


def _tensor(a, device) -> torch.Tensor:
    return to_device(np.asarray(a), None, device)


def _part(cls, src, device):
    return cls(*(_tensor(getattr(src, f), device) for f in cls._fields))


def _nr_part(src, device):
    """The noise processor's carries, by their field names."""
    fields = set(src._fields)
    for cls in (NRState, ANRState, NBState):
        if fields == set(cls._fields):
            return _part(cls, src, device)
    raise TypeError(f"not a noise-processor state: {type(src).__name__}")


def state_from_numpy(tree, device="cpu"):
    """JAX HopState / ChannelTable / WaterfallViews (numpy leaves) ->
    this package's HopState / ChannelTable / WaterfallViews."""
    fields = getattr(tree, "_fields", ())
    if "frame" in fields and "audio" in fields:
        a = tree.audio
        return HopState(
            frame=int(np.asarray(tree.frame)),
            audio=AudioState(chan=_part(ChannelState, a.chan, device),
                             dc=_part(DCBlockerState, a.dc, device),
                             agc=_part(AGCState, a.agc, device),
                             dec=_part(DecimatorState, a.dec, device),
                             st=_part(StereoState, a.st, device),
                             nr=_nr_part(a.nr, device),
                             rds=_part(RDSState, a.rds, device),
                             de=_tensor(a.de, device)))
    if "m_idx" in fields:
        return channels_from_numpy(tree.l, tree.r, tree.m_idx, tree.mode,
                                   tree.active, am_env=tree.am_env,
                                   rds=tree.rds, nr=tree.nr, device=device)
    if "start" in fields and "length" in fields:
        return _part(WaterfallViews, tree, device)
    raise TypeError(f"not a HopState, ChannelTable or WaterfallViews: "
                    f"{type(tree).__name__}")


def state_to_numpy(state):
    """This package's HopState / ChannelTable / WaterfallViews with
    every leaf as a numpy array (the same NamedTuple types)."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(state_to_numpy(v) for v in state))
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, bool):
        return np.bool_(state)
    return np.int32(state)



class ShardedCarries(NamedTuple):
    """The JAX package's ShardedHopState layout with numpy leaves:
    ``inner`` a HopState whose channel carries are in global row order,
    ``halo`` [n, wire_per_hop] (row 0 the carried tail; the JAX mesh
    never reads the other rows)."""

    inner: HopState
    halo: np.ndarray


def _split_rows(audio: AudioState, n: int) -> list[AudioState]:
    """Global channel carries -> n row blocks (the per-stream rows are
    channel-major, so equal blocks split them by channel too)."""
    return [map_rows(lambda x, _g, i=i: x[i * (x.shape[0] // n):
                                          (i + 1) * (x.shape[0] // n)],
                     audio) for i in range(n)]


def sharded_state_from_numpy(tree, pipe) -> ShardedHopState:
    """JAX ShardedHopState (numpy leaves) -> the state of ``pipe`` (a
    ShardedHopPipeline), each shard's carries on its device."""
    inner = state_from_numpy(tree.inner)
    blocks = _split_rows(inner.audio, pipe.n)
    audio = tuple(map_rows(lambda x, _g, d=d: x.to(d), blk)
                  for blk, d in zip(blocks, pipe.devices))
    halo = np.ascontiguousarray(np.asarray(tree.halo)[0])
    halo = halo.view(convert.device_dtype(pipe.cfg.input_format))
    return ShardedHopState(frame=inner.frame, audio=audio,
                           halo=_tensor(halo, pipe.device))


def sharded_state_to_numpy(state: ShardedHopState) -> ShardedCarries:
    """A ShardedHopState -> ShardedCarries: the shards' carries joined
    in global row order and the halo as row 0 of an [n, wire_per_hop]
    array whose other rows are zero."""
    joined = [state_to_numpy(a) for a in state.audio]
    audio = type(joined[0])(*(
        type(part)(*(np.concatenate(x) for x in zip(*parts)))
        if isinstance(part, tuple) else np.concatenate(parts)
        for part, parts in zip(joined[0], zip(*joined))))
    halo = np.zeros((len(state.audio),) + tuple(state.halo.shape),
                    state_to_numpy(state.halo).dtype)
    halo[0] = state_to_numpy(state.halo)
    return ShardedCarries(inner=HopState(frame=np.int32(state.frame),
                                         audio=audio), halo=halo)
