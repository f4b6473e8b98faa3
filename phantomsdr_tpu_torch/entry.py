"""One-call entry points: the small-config hop step and a sharded dryrun.

The counterparts of the JAX package's ``__graft_entry__.entry`` and
``__graft_entry__.dryrun_multichip``.  ``entry()`` returns the
single-device ``views`` step at a small config (FFT 4096, 16 channels,
4 hops a step) and its example arguments; ``dryrun_multichip(n)`` runs
two sharded steps on an n-shard mesh at tiny shapes (the halo carried
across a step, the spectra gathered, the channels sharded).

Both run on the card unless the caller asks for the CPU
(``device="cpu"``, the plain PyTorch versions of the kernels).  A mesh
of n needs n cards, or an explicit device list such as
``devices=["cuda:0"] * n`` to place several shards on one card.

    python -c "from phantomsdr_tpu_torch.entry import entry; \\
        fn, args = entry(); print(fn(*args)[1].audio.shape)"
    python -c "from phantomsdr_tpu_torch.entry import dryrun_multichip; \\
        dryrun_multichip(4, devices=['cuda:0'] * 4)"
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import ServerConfig, config_from_dict
from .parallel.sharded import ShardedHopPipeline, make_mesh
from .pipeline import HopPipeline, channels_from_numpy


def small_cfg(hop_batch: int = 4, max_channels: int = 16,
              fft_size: int = 4096) -> ServerConfig:
    """The small config: IQ s16 at 192 kS/s, 12 kHz audio, a 512-bin
    waterfall."""
    return config_from_dict({
        "input": {
            "sps": 192000,
            "frequency": 7000000,
            "fft_size": fft_size,
            "signal": "iq",
            "audio_sps": 12000,
            "waterfall_size": 512,
            "driver": {"format": "s16"},
        },
        "tpu": {"hop_batch": hop_batch, "max_channels": max_channels},
    })


def entry(device="cuda"):
    """(fn, example_args): ``fn(state, raw, chans, views, reset,
    due_idx)`` is the single-device hop step in ``views`` mode (window,
    FFT, waterfall, channelizer, demod, AGC) at ``small_cfg()``, and
    returns (state, HopOutputs).  The example arguments: fresh carries,
    a block of zeros, a channel table cycling USB/LSB/AM/FM, one empty
    waterfall view, no resets and the frame-0 due rows."""
    cfg = small_cfg()
    pipe = HopPipeline(cfg, device=device)
    state = pipe.init_state()
    c = cfg.max_channels
    l = np.linspace(10, cfg.fft_result_size - 300, c).astype(np.int32)
    table = channels_from_numpy(l=l, r=l + 100, m_idx=l + 50,
                                mode=np.arange(c) % 4,
                                active=np.ones(c, bool), device=pipe.device)
    raw = torch.zeros((cfg.hop_batch + 1) * pipe.wire_per_hop,
                      dtype=torch.int16, device=pipe.device)
    views = pipe.empty_views()
    reset = torch.zeros((c,), dtype=torch.int32, device=pipe.device)
    due_idx = pipe.default_due_idx()

    def fn(state, raw, chans, views, reset, due_idx):
        return pipe.step(state, raw, chans, views, "views", reset, due_idx)

    return fn, (state, raw, table, views, reset, due_idx)


class Dryrun(NamedTuple):
    """What ``dryrun_multichip`` ran: its config, the channel table's
    numpy columns, the raw block fed to both steps (no halo) and the
    two steps' outputs."""

    cfg: ServerConfig
    table: dict
    raw: np.ndarray
    outputs: list


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> Dryrun:
    """Make an n-shard mesh (``parallel.sharded.make_mesh``: n cards, n
    CPU shards with ``device="cpu"``, or the explicit ``devices`` list)
    and run two sharded hop steps on tiny shapes, 'full' then 'views',
    so that the halo ring carries across a step; checks the output
    shapes.  Raises where there are fewer cards than asked for."""
    cfg = small_cfg(hop_batch=max(4, n_devices),
                    max_channels=max(8, 2 * n_devices), fft_size=2048)
    mesh = make_mesh(n_devices, device, devices)
    sp = ShardedHopPipeline(cfg, mesh)
    state = sp.init_state()

    c = cfg.max_channels
    l = np.linspace(10, cfg.fft_result_size - 200, c).astype(np.int32)
    columns = dict(l=l, r=l + 64, m_idx=l + 32, mode=np.arange(c) % 4,
                   active=np.ones(c, bool))
    table = sp.channels_from_numpy(**columns)
    rng = np.random.default_rng(0)
    raw = rng.integers(-1000, 1000, size=cfg.hop_batch * sp.wire_per_hop,
                       dtype=np.int16)
    shards = sp.shard_raw(raw)
    state, full = sp.step(state, shards, table, waterfall="full")
    state, out = sp.step(state, shards, table, waterfall="views")
    audio = torch.cat([a.cpu() for a in out.audio], dim=1)
    if audio.shape != (cfg.hop_batch, c, cfg.audio_fft_size // 2):
        raise AssertionError(f"dryrun audio shape {tuple(audio.shape)}")
    rows = sum(w.shape[0] for w in out.wf)
    if rows != n_devices * sp.due_cap_local:
        raise AssertionError(f"dryrun waterfall rows {rows}, want "
                             f"{n_devices * sp.due_cap_local}")
    return Dryrun(cfg=cfg, table=columns, raw=raw, outputs=[full, out])
