"""Mesh-sharded hop pipeline: time-sharded FFT + channel-sharded demod,
with the 50%-overlap halo passed between shards.

The JAX package runs this as one ``shard_map`` over a device mesh; here
the mesh is a list of ``torch.device`` s driven by one process
(``make_mesh``), and its two collectives are device-to-device copies
(``collectives``).  A device may appear more than once: its shards then
run one after another on its stream, which is how one card runs the
whole mesh path (and the CPU N shards, as the JAX tests' virtual
devices do).

- **Time sharding** for the front half: shard i receives ``hop_batch /
  n`` contiguous hops of raw wire samples and runs the window, the FFT
  and the waterfall pyramid (kernel K-WF) of its own due hops.
- The **halo** (one hop of wire samples) moves one shard along the ring
  each step: shard i frames its first hop with the last hop of shard
  i-1; shard 0 with the previous step's global tail, carried in the
  state.
- An **all-gather** of the (unextended) spectra puts every hop on every
  device, once per distinct device.
- **Channel sharding** for the back half: shard i demodulates its
  ``max_channels / n`` rows across all hops of the step (kernels K-PLL
  and K-AGC, and the opt-in stages' kernels), keeping its carries on
  its device.  The stages a shard skips are decided from its own rows.

Each shard writes audio, power, its waterfall view rows and RDS into
its own segment; the segments of consecutive shards on one device form
one packed buffer, and the host concatenation of the buffers is the
JAX package's per-shard layout -- parse it with
``unpack_outputs_sharded``, not ``pipeline.unpack_outputs``.

In a cluster (``parallel.multihost``) each process holds a contiguous
run of the mesh's shards: its pipeline is given its own devices and
the cross-process collectives (``group``), and holds the rank's run of
global shard indices.  It steps only those shards; the halo's hop
between processes and both gathers go over the group.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ServerConfig
from ..ops import convert
from ..ops.channelizer import ChannelTable
from ..pipeline import (
    WATERFALL_MODES, AudioState, HopPipeline, WaterfallViews, alloc_packed,
    audio_from_spectra, channels_from_numpy, gather_waterfall_views,
    init_audio_state, spectra_from_raw, to_device, waterfall_due_positions,
    waterfall_from_spectra,
)
from .collectives import CrossProcess, all_gather, ring_permute


class ShardedHopState(NamedTuple):
    frame: int                     # global hop counter (only its parity
    #                                is read)
    audio: tuple[AudioState, ...]  # shard i's channel carries, on its
    #                                device (this process's shards)
    halo: torch.Tensor             # [wire_per_hop] the previous step's
    #                                last hop, on shard 0's device (read
    #                                only by the process holding shard 0)


class ShardedHopOutputs(NamedTuple):
    """Per-shard outputs (lists in shard order, each on its shard's
    device; in a cluster this process's shards).  audio, avg_power and
    rds are the shard's channel rows over all hops; wf its due rows'
    client views (with ``gather_wf`` every shard's, gathered); pyramid
    its hops' pyramids ('full' mode)."""

    audio: list[torch.Tensor]      # [B, C/n, nch*half] or [C/n, la]
    avg_power: list[torch.Tensor]  # [B, C/n] f32
    wf: list[torch.Tensor]         # [due_cap_local, W, view_cap] int8
    pyramid: list[torch.Tensor]    # [B/n, P] int8
    rds: list[torch.Tensor]        # [C/n, 2, rds_t] int8
    packed: list[torch.Tensor]     # one int8 buffer per run of shards on
    #                                one device (empty with gather_wf)


def make_mesh(n: int | None = None, device="cuda",
              devices=None) -> list[torch.device]:
    """The mesh's device list.  An explicit ``devices`` list wins (a
    device may repeat: ``[cuda:0] * 4`` runs four shards on one card).
    Otherwise ``cuda`` takes the first ``n`` cards and raises where
    there are fewer, and ``cpu`` gives ``n`` CPU shards."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if n is not None and len(out) != n:
            raise ValueError(f"make_mesh: {len(out)} devices given for a "
                             f"mesh of {n}")
        return [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in out]
    if n is None or n < 1:
        raise ValueError("make_mesh: give the mesh size or a device list")
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n
    if device.type != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"make_mesh: a mesh of {n} needs {n} CUDA devices, found "
            f"{have}; pass devices= to place several shards on one")
    return [torch.device("cuda", i) for i in range(n)]


def _runs(devices: list[torch.device]) -> list[tuple[torch.device, int, int]]:
    """(device, first shard, shard count) of each run of consecutive
    shards on one device."""
    runs: list[tuple[torch.device, int, int]] = []
    for i, d in enumerate(devices):
        if runs and runs[-1][0] == d:
            runs[-1] = (d, runs[-1][1], runs[-1][2] + 1)
        else:
            runs.append((d, i, 1))
    return runs


class ShardedHopPipeline:
    """Hop pipeline over a 1-D device mesh (``make_mesh``).

    gather_wf=True all-gathers the waterfall view rows, so every device
    holds every shard's due rows, and emits no packed buffer (the rows,
    audio and power are read from their own tensors).

    In a cluster, ``mesh`` is this process's devices and ``group`` a
    ``CrossProcess``; the devices hold the global shards ``[rank *
    len(mesh), (rank + 1) * len(mesh))`` and ``n`` is the global shard
    count.  ``step`` then takes raw rows, channel tables
    and resets for the local shards only, while ``due_layout``,
    ``due_row_selector`` and ``channels_from_numpy`` take the global
    ones."""

    def __init__(self, cfg: ServerConfig, mesh: list, gather_wf: bool = False,
                 group: CrossProcess | None = None):
        self.cfg = cfg
        self.devices = [torch.device(d) for d in mesh]
        self.gather_wf = gather_wf
        self.group = group
        self.n = len(self.devices) * (group.size if group else 1)
        first = group.rank * len(self.devices) if group else 0
        self.shards = range(first, first + len(self.devices))
        if cfg.hop_batch % self.n:
            raise ValueError("hop_batch must divide evenly over the mesh")
        if cfg.max_channels % self.n:
            raise ValueError("max_channels must divide evenly over the mesh")
        self.device = self.devices[0]
        self.runs = _runs(self.devices)
        # the window, the stages' constants and the config's checks are
        # the single-device pipeline's, one per distinct device
        self.local = {d: HopPipeline(cfg, device=d) for d in self.devices}
        one = self.local[self.device]
        self.agc_params, self.dc_delay = one.agc_params, one.dc_delay
        self.wire_per_hop, self.view_cap = one.wire_per_hop, one.view_cap
        self.decim_taps, self.decim = one.decim_taps, one.decim
        self.stereo_params, self.rds_params = one.stereo_params, one.rds_params
        self.nr_params, self.deemph_a = one.nr_params, one.deemph_a
        self.rds_t = one.rds_t
        self.hops_per_shard = cfg.hop_batch // self.n
        self.chans_per_shard = cfg.max_channels // self.n
        # per-shard waterfall view gather rows: max cadence-due hops any
        # single time shard can hold (the host maps global due positions
        # to (shard, local) and pads; see due_layout)
        self.due_cap_local = max(1, -(-self.hops_per_shard // cfg.skip_num))
        self.raw_shard_len = self.hops_per_shard * self.wire_per_hop
        self.halo_dtype = torch.from_numpy(
            np.zeros(0, convert.device_dtype(cfg.input_format))).dtype

    # ------------------------------------------------------------------
    def init_state(self, frame0: int = 0) -> ShardedHopState:
        """Fresh carries and a zero halo.  frame0 seeds the hop counter
        when the driver rebuilds the state mid-stream: only its parity
        is read (see HopPipeline.init_state)."""
        audio = tuple(init_audio_state(self.cfg, self.chans_per_shard,
                                       self.agc_params.window, self.dc_delay,
                                       d) for d in self.devices)
        halo = torch.zeros(self.wire_per_hop, dtype=self.halo_dtype,
                           device=self.device)
        return ShardedHopState(frame=frame0 & 1, audio=audio, halo=halo)

    def channels_from_numpy(self, l, r, m_idx, mode, active, am_env=None,
                            rds=None, nr=None) -> list[ChannelTable]:
        """Each (local) shard's ChannelTable on its device, from the
        global numpy columns.  Each shard decides from its own rows
        whether its AM PLL, RDS and noise-reduction stages run, as the
        JAX package's lax.cond does inside shard_map."""
        c = np.shape(l)[0]
        z = np.zeros(c, bool)
        cols = [np.asarray(x) for x in (l, r, m_idx, mode, active,
                                        z if am_env is None else am_env,
                                        z if rds is None else rds,
                                        z if nr is None else nr)]
        cl = c // self.n
        return [channels_from_numpy(*(x[i * cl:(i + 1) * cl]
                                      for x in cols[:5]),
                                    am_env=cols[5][i * cl:(i + 1) * cl],
                                    rds=cols[6][i * cl:(i + 1) * cl],
                                    nr=cols[7][i * cl:(i + 1) * cl], device=d)
                for i, d in zip(self.shards, self.devices)]

    def empty_views(self, num: int = 0) -> WaterfallViews:
        c = num or self.n
        z = torch.zeros((c,), dtype=torch.int32, device=self.device)
        return WaterfallViews(start=z, length=z)

    def _split(self, x, dtype=None) -> list[torch.Tensor]:
        """A flat [n_local * k] host array or tensor -> local shard i's
        k entries on its device (one copy per run of shards on one
        device)."""
        k = x.shape[0] // len(self.devices)
        out = []
        for d, first, count in self.runs:
            part = x[first * k:(first + count) * k]
            if isinstance(part, torch.Tensor):
                t = part.to(d, dtype=dtype, non_blocking=True)
            else:
                t = to_device(part, dtype, d)
            out += [t[j * k:(j + 1) * k] for j in range(count)]
        return out

    def shard_raw(self, raw_block) -> list[torch.Tensor]:
        """[B * wire_per_hop] contiguous wire samples (NO halo, in
        ``convert.host_preconvert``'s dtype; a host array or a tensor)
        -> shard i's [(B/n) * wire_per_hop] on its device.  In a cluster
        the block is the local shards' rows, [n_local, raw_shard_len]
        or flat."""
        if not isinstance(raw_block, torch.Tensor):
            raw_block = np.asarray(raw_block)
        return self._split(raw_block.reshape(-1))

    def due_layout(self, frame0: int = 0, cap: int | None = None
                   ) -> tuple[np.ndarray, list[int]]:
        """Map the batch's global cadence-due hop positions onto the
        time shards.

        Returns (due_idx [n, cap] int32 local positions padded with 0,
        counts [n] real entries per shard).  Row i*cap + j of the
        'views' wf output is global hop i*hops_per_shard + due_idx[i, j]
        for j < counts[i]; rows beyond counts[i] are padding."""
        cap = cap or self.due_cap_local
        bl = self.hops_per_shard
        per: list[list[int]] = [[] for _ in range(self.n)]
        for h in waterfall_due_positions(self.cfg, frame0):
            per[h // bl].append(h % bl)
        idx = np.zeros((self.n, cap), np.int32)
        counts = []
        for i, lst in enumerate(per):
            counts.append(len(lst))
            idx[i, : len(lst)] = lst
        return idx, counts

    def due_row_selector(self, counts: list[int]) -> list[int]:
        """Row indices mapping the padded per-shard 'views' wf output
        (due_cap_local rows per shard; see due_layout) back to global
        due-list order."""
        cl = self.due_cap_local
        return [i * cl + j for i in range(self.n)
                for j in range(counts[i])]

    # ------------------------------------------------------------------
    def step(self, state: ShardedHopState, raw_shards: list[torch.Tensor],
             chans: list[ChannelTable], views: WaterfallViews | None = None,
             waterfall: str = "full", reset=None, due_idx=None,
             ) -> tuple[ShardedHopState, ShardedHopOutputs]:
        """raw_shards: ``shard_raw``'s per-shard tensors; chans:
        ``channels_from_numpy``'s per-shard tables; views: the global
        view table (replicated to each device); reset: [C] int32
        RESET_* mask (in a cluster: the local shards' channels) or
        None; due_idx: [n, due_cap_local] int32 local due positions of
        every shard (``due_layout``; defaults to frame0 = 0's)."""
        if waterfall not in WATERFALL_MODES:
            raise ValueError(f"waterfall must be one of {WATERFALL_MODES}")
        m = len(self.devices)
        if len(raw_shards) != m or len(chans) != m:
            raise ValueError(f"step: {m} raw shards and channel "
                             f"tables expected")
        cfg, devs = self.cfg, self.devices
        bl, half = self.hops_per_shard, cfg.audio_fft_size // 2
        if views is None:
            views = self.empty_views()
        views_on = {d: WaterfallViews(start=views.start.to(d),
                                      length=views.length.to(d))
                    for d in devs}
        w = views.start.shape[0]
        resets = (self._split(reset.reshape(-1) if isinstance(
            reset, torch.Tensor) else np.asarray(reset), torch.int32)
            if reset is not None else [None] * m)

        # ---- front half: each shard's hops, framed with the hop before
        # them (shard 0: the carried global tail of the previous step)
        recv = self._ring([r[-self.wire_per_hop:] for r in raw_shards])
        if self.shards[0] == 0:
            halos, new_halo = [state.halo] + recv[1:], recv[0].clone()
        else:
            halos, new_halo = recv, state.halo
        spec = [spectra_from_raw(cfg, self.local[d].window,
                                 torch.cat([halos[i], raw_shards[i]]), bl)
                for i, d in enumerate(devs)]

        pyr = [torch.zeros((bl, 0), dtype=torch.int8, device=d)
               for d in devs]
        wf = [None] * m
        if waterfall == "full":
            pyr = [waterfall_from_spectra(
                cfg, s, torch.arange(bl, dtype=torch.int32, device=d))
                for s, d in zip(spec, devs)]
        elif waterfall == "views":
            # the pyramid of each shard's cadence-due hops only
            if due_idx is None:
                due_idx = self.due_layout()[0]
            if not isinstance(due_idx, torch.Tensor):
                due_idx = np.asarray(due_idx, np.int32)
            due = self._split(due_idx[self.shards[0]:self.shards[-1] + 1]
                              .reshape(-1), torch.int32)
            wf = [gather_waterfall_views(
                waterfall_from_spectra(cfg, s, di), views_on[d],
                self.view_cap) for s, di, d in zip(spec, due, devs)]
            if self.gather_wf:
                wf = self._gather(wf)

        # ---- every hop's spectrum on every device; each shard
        # demodulates its channel rows into its own packed segment
        all_spec = self._gather(spec)
        rows = self.due_cap_local if waterfall == "views" else 0
        seg_rows = 0 if self.gather_wf else rows
        audio_st, segs = [], []
        audio16, pwr, wf_out, rds8 = [], [], [], []
        for i, d in enumerate(devs):
            seg, a16, p, wv, r8 = alloc_packed(
                cfg.hop_batch, self.chans_per_shard, half, seg_rows, w,
                self.view_cap, d, self.decim, cfg.audio_channels, self.rds_t)
            if seg_rows:
                wv.copy_(wf[i])
            st, pw = audio_from_spectra(
                cfg, self.agc_params, self.dc_delay, state.audio[i],
                all_spec[i], chans[i], state.frame, resets[i], a16, r8,
                decim_taps=self.decim_taps,
                stereo_params=self.stereo_params,
                rds_params=self.rds_params, deemph_a=self.deemph_a,
                nr_params=self.nr_params)
            p.copy_(pw)
            audio_st.append(st)
            segs.append(seg)
            audio16.append(a16)
            pwr.append(p)
            rds8.append(r8)
            wf_out.append(wf[i] if self.gather_wf else wv)
        if self.gather_wf:
            packed = [torch.zeros((0,), dtype=torch.int8, device=d)
                      for d, _, _ in self.runs]
        else:
            packed = [segs[first] if count == 1
                      else torch.cat(segs[first:first + count])
                      for _, first, count in self.runs]
        return (ShardedHopState(frame=state.frame + cfg.hop_batch,
                                audio=tuple(audio_st), halo=new_halo),
                ShardedHopOutputs(audio=audio16, avg_power=pwr, wf=wf_out,
                                  pyramid=pyr, rds=rds8, packed=packed))

    def _ring(self, tails: list[torch.Tensor]) -> list[torch.Tensor]:
        """Local shard i's received tail: local shard i-1's, and for the
        first the tail of the shard before it, over the group in a
        cluster (the last local shard's tail goes to the next
        process)."""
        if self.group is None:
            return ring_permute(tails)
        first = self.group.ring(tails[-1])
        return [first] + [t.to(d, non_blocking=True)
                          for t, d in zip(tails[:-1], self.devices[1:])]

    def _gather(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard's part, concatenated in global shard order, on each
        local shard's device (one tensor per distinct device)."""
        if self.group is None:
            return all_gather(parts, self.devices)
        home = self.device
        mine = (parts[0] if len(parts) == 1
                else torch.cat([p.to(home, non_blocking=True)
                                for p in parts]))
        whole = {home: self.group.all_gather(mine)}
        for d in self.devices:
            if d not in whole:
                whole[d] = whole[home].to(d, non_blocking=True)
        return [whole[d] for d in self.devices]


def unpack_outputs_sharded(packed: np.ndarray, n: int, b: int, c: int,
                           half: int, w: int, cap: int,
                           wf_rows_per_shard: int, decim: int = 1,
                           nch: int = 1, rds_t: int = 0):
    """Host-side inverse of the sharded packed buffers (concatenated).

    The sharded packed output is NOT pipeline.unpack_outputs-compatible:
    it is a per-shard concatenation, shard i holding audio [B, C/n,
    half] | pwr [B, C/n] | wf [rows, W, cap] | rds [C/n, 2, rds_t] for
    ITS channel shard / time shard.  Returns global (audio [B, C, half],
    pwr [B, C], wf [n*rows, W, cap] or None, rds [C, 2, rds_t] or None);
    map wf rows to hops with ShardedHopPipeline.due_layout.  With device
    Opus decimation (decim > 1) audio is [C, B*half/decim] continuous
    streams."""
    cl = c // n
    rows = wf_rows_per_shard
    if decim > 1:
        la = nch * b * half // decim
        na = cl * la * 2
        audio = np.empty((c, la), np.int16)
    else:
        na = b * cl * nch * half * 2
        audio = np.empty((b, c, nch * half), np.int16)
    npw = b * cl * 4
    nwf = rows * w * cap
    nrds = cl * 2 * rds_t
    seg = na + npw + nwf + nrds
    assert packed.size == n * seg, (packed.size, n, seg)
    pwr = np.empty((b, c), np.float32)
    wf = np.empty((n * rows, w, cap), np.int8) if rows else None
    rds = np.empty((c, 2, rds_t), np.int8) if rds_t else None
    for i in range(n):
        s = packed[i * seg:(i + 1) * seg]
        if decim > 1:
            audio[i * cl:(i + 1) * cl] = (
                s[:na].view(np.int16).reshape(cl, la))
        else:
            audio[:, i * cl:(i + 1) * cl] = (
                s[:na].view(np.int16).reshape(b, cl, nch * half))
        pwr[:, i * cl:(i + 1) * cl] = (
            s[na:na + npw].view(np.float32).reshape(b, cl))
        if rows:
            wf[i * rows:(i + 1) * rows] = (
                s[na + npw:na + npw + nwf].view(np.int8)
                .reshape(rows, w, cap))
        if rds_t:
            rds[i * cl:(i + 1) * cl] = (
                s[na + npw + nwf:].view(np.int8).reshape(cl, 2, rds_t))
    return audio, pwr, wf, rds
