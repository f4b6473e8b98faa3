"""Host driver: sample reader thread + device step loop + metrics.

Replaces the reference's fft_task thread and its async stdin
triple-buffering (reference: src/fft.cpp:10-119): a reader thread
fills raw blocks from the input stream (keeping the 50%-overlap halo),
a device thread runs the hop pipeline, and finished outputs are
handed to a consumer callback (the websocket server) on its event loop.

On a CUDA device raw blocks go up through pinned host memory with a
non-blocking copy, and each step's packed outputs come back the same
way, fenced by a CUDA event: one step stays in flight while the host
hands the previous one to the consumer.

With ``[tpu] mesh_devices = N`` the same loops run over the time- and
channel-sharded engine (``parallel.sharded``) on a list of N devices:
N cards, the N CPU shards of ``device="cpu"``, or the list passed as
``mesh`` (``[cuda:0] * N`` runs the mesh on one card).

Also the home of the perf counters: hop counter, sustained MSPS,
per-step device latency.
"""

from __future__ import annotations

import collections
import io
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..config import ServerConfig
from ..ops.convert import wire_dtype, host_preconvert
from ..ops.cuda import all_kernels
from ..ops.cuda.build import build_all
from ..parallel.sharded import (
    ShardedHopPipeline, make_mesh, unpack_outputs_sharded,
)
from ..pipeline import (
    HopPipeline, WaterfallViews, channels_from_numpy, pad_due_positions,
    to_device, unpack_outputs, waterfall_due_positions,
)


@dataclass
class Metrics:
    frames: int = 0
    samples: int = 0
    start_time: float = field(default_factory=time.monotonic)
    step_seconds: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=120))
    idle_frames: int = 0
    eof: bool = False
    device_errors: int = 0
    last_device_error: str = ""
    channel_rows: int = 0   # table width of the latest step (bucketing)

    def snapshot(self, cfg: ServerConfig) -> dict:
        el = max(time.monotonic() - self.start_time, 1e-9)
        steps = list(self.step_seconds)
        hop = cfg.hop_size
        return {
            "frames": self.frames,
            "samples_in": self.samples,
            "elapsed_s": el,
            "msps_sustained": self.samples / el / 1e6,
            "msps_device": (
                (len(steps) * cfg.hop_batch * hop) / max(sum(steps), 1e-9) / 1e6
                if steps else 0.0
            ),
            "step_ms_p50": (
                sorted(steps)[len(steps) // 2] * 1e3 if steps else 0.0
            ),
            "idle_frames": self.idle_frames,
            "eof": self.eof,
            "device_errors": self.device_errors,
            "last_device_error": self.last_device_error,
            "channel_rows": self.channel_rows,
        }


class SampleSource:
    """Blocking block reader over a binary stream (stdin or file),
    maintaining the halo so every block is (B+1)*hop wire samples.
    Mirrors SampleConverter reads (src/samplereader.cpp:42-70) but keeps
    raw wire ints; conversion happens on device."""

    def __init__(self, cfg: ServerConfig, stream: io.BufferedReader,
                 loop_file: bool = False, throttle_sps: float = 0.0,
                 include_halo: bool = True):
        self.cfg = cfg
        self.stream = stream
        self.dtype = wire_dtype(cfg.input_format)
        self.wire_per_hop = cfg.hop_size * (1 if cfg.is_real else 2)
        self.block_wire = cfg.hop_batch * self.wire_per_hop
        # mesh mode reads WITHOUT the host halo: the overlap hop moves
        # between the time shards (parallel/sharded.py ring permute)
        self.include_halo = include_halo
        self.halo = np.zeros(self.wire_per_hop, self.dtype)
        self.loop_file = loop_file
        self.throttle_sps = throttle_sps  # simulate realtime for file replay
        self._t0 = None
        self._consumed = 0

    def read_block(self) -> np.ndarray | None:
        """Return [(B+1)*wph] wire samples (halo + new), or [B*wph] when
        include_halo is False; None on EOF."""
        need = self.block_wire * self.dtype.itemsize
        data = b""
        while len(data) < need:
            chunk = self.stream.read(need - len(data))
            if not chunk:
                if self.loop_file and hasattr(self.stream, "seek"):
                    self.stream.seek(0)
                    continue
                return None
            data += chunk
        new = np.frombuffer(data, self.dtype)
        if not self.include_halo:
            block = new
        else:
            block = np.concatenate([self.halo, new])
            self.halo = new[-self.wire_per_hop:]
        if self.throttle_sps > 0:
            scalars_per_sample = 1 if self.cfg.is_real else 2
            self._consumed += self.block_wire / scalars_per_sample
            if self._t0 is None:
                self._t0 = time.monotonic()
            target = self._t0 + self._consumed / self.throttle_sps
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        return block


class _Fetch:
    """One step's packed outputs on their way to the host: one buffer,
    or in mesh mode one per device, joined in order.  On CUDA each copy
    goes into a pinned buffer without blocking and a CUDA event on its
    device's stream marks its end; ``result`` waits for those events
    only."""

    def __init__(self, packed: torch.Tensor | list[torch.Tensor]):
        self.host, self.events = [], []
        for p in packed if isinstance(packed, list) else [packed]:
            if p.device.type == "cuda":
                h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                h.copy_(p, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(p.device))
                self.events.append(ev)
                p = h
            self.host.append(p)

    def result(self) -> np.ndarray:
        for ev in self.events:
            ev.synchronize()
        if len(self.host) == 1:
            return self.host[0].numpy()
        return np.concatenate([h.numpy() for h in self.host])


class DSPDriver:
    """Reader thread -> bounded queue -> device-step thread -> consumer."""

    # active-channel bucketing: consecutive steps the population must
    # stay within the small bucket before the table shrinks back
    shrink_after = 100

    def __init__(self, cfg: ServerConfig, source: SampleSource,
                 channel_registry, consumer: Callable,
                 waterfall_registry=None,
                 waterfall_active: Callable[[], bool] = lambda: True,
                 audio_active: Callable[[], bool] = lambda: True,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.source = source
        self.registry = channel_registry
        self.wf_registry = waterfall_registry
        self.consumer = consumer
        self.waterfall_active = waterfall_active
        self.audio_active = audio_active
        self.metrics = Metrics()
        self.sharded = cfg.mesh_devices > 1
        if self.sharded:
            # mesh server mode: ``mesh`` (a device list) or N devices of
            # ``device``
            self.pipe = ShardedHopPipeline(
                cfg, make_mesh(cfg.mesh_devices, device, devices=mesh))
            source.include_halo = False
        else:
            self.pipe = HopPipeline(cfg, device=device)
        self.device = self.pipe.device
        self.devices = self.pipe.devices if self.sharded else [self.device]
        self._queue: queue.Queue = queue.Queue(maxsize=3)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._table_key = (-1, None)
        self._table = None
        self._views_key = (-1, None)
        self._views = None
        self._np_table = (-1, None)
        self._np_views = None
        self._wf_meta = None    # (l, r, level) snapshotted with views
        self._audio_meta = None  # (l, r, mid) snapshotted with the table
        self._due_idx: dict[tuple[int, ...], torch.Tensor] = {}

    # ------------------------------------------------------------------
    def start(self):
        tr = threading.Thread(target=self._read_loop, name="sdr-reader",
                              daemon=True)
        td = threading.Thread(target=self._device_loop, name="dsp-step",
                              daemon=True)
        self._threads = [tr, td]
        tr.start()
        td.start()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)

    # ------------------------------------------------------------------
    def _read_loop(self):
        def put(item) -> bool:
            # bounded put that honors stop: a dead device thread must
            # not leave the reader parked in a full queue forever
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        while not self._stop.is_set():
            block = self.source.read_block()
            if block is None:
                self.metrics.eof = True
                put(None)
                return
            if not put(block):
                return

    def _refresh_table(self):
        """Snapshot both registries (host numpy); returns the one-shot
        reset mask (int32 RESET_* codes) taken atomically WITH the
        channel table snapshot, so a fresh slot's reset and its table
        row reach the device in the same step.  Device tables are built
        lazily per bucket width by _tables_for()."""
        v, arrays, resets, audio_meta = self.registry.snapshot()
        self._audio_meta = audio_meta
        self._np_table = (v, arrays)
        if self.wf_registry is not None:
            wv, start, length, meta = self.wf_registry.snapshot()
            self._np_views = (wv, start, length)
            self._wf_meta = meta
        else:
            self._np_views = None
        return resets

    def _high_water(self) -> int:
        """Highest active slot + 1 across BOTH registries (audio active
        flags, waterfall view lengths) in the current snapshot -- the
        lower bound on the bucket width the next step must run at."""
        active = self._np_table[1][4]
        hw = int(np.max(np.nonzero(active)[0])) + 1 if active.any() else 0
        if self._np_views is not None:
            length = self._np_views[2]
            nz = np.nonzero(length)[0]
            if nz.size:
                hw = max(hw, int(nz[-1]) + 1)
        return hw

    def _tables_for(self, k: int | None):
        """Device (ChannelTable, WaterfallViews) at bucket width k
        (None = full), cached on the snapshot versions + k."""
        v, arrays = self._np_table
        if (v, k) != self._table_key or self._table is None:
            rows = arrays if k is None else tuple(a[:k] for a in arrays)
            # registry columns: l, r, m_idx, mode, active, nr, rds, am_env
            if self.sharded:  # each shard's table on its device
                self._table = self.pipe.channels_from_numpy(
                    *rows[:5], am_env=rows[7], rds=rows[6], nr=rows[5])
            else:
                self._table = channels_from_numpy(
                    *rows[:5], am_env=rows[7], rds=rows[6], nr=rows[5],
                    device=self.device)
            self._table_key = (v, k)
        if self._np_views is not None:
            wv, start, length = self._np_views
            if (wv, k) != self._views_key or self._views is None:
                if k is not None:
                    start, length = start[:k], length[:k]
                self._views = WaterfallViews(
                    start=to_device(start, torch.int32, self.device),
                    length=to_device(length, torch.int32, self.device))
                self._views_key = (wv, k)
        elif self._views is None:
            self._views = self.pipe.empty_views()
        return self._table, self._views

    def _due_tensor(self, frame0: int, due: list[int]
                    ) -> tuple[torch.Tensor, list[int] | None]:
        """Device gather positions for a step's due list (at most
        skip_num distinct lists occur, so each is copied to the device
        once), and in mesh mode the selector of the due rows among the
        per-shard padded wf rows (None otherwise)."""
        sel = None
        if self.sharded:
            idx, counts = self.pipe.due_layout(frame0)
            key = tuple(idx.reshape(-1))
            sel = self.pipe.due_row_selector(counts)
        else:
            key = tuple(pad_due_positions(due, self.pipe.due_cap))
        t = self._due_idx.get(key)
        if t is None:
            t = self._due_idx[key] = to_device(key, torch.int32, self.device)
        return t, sel

    def _prepare_raw(self, block: np.ndarray):
        pre = host_preconvert(block, self.cfg.input_format)
        if self.sharded:
            return self.pipe.shard_raw(pre)
        return to_device(pre, None, self.device)

    def _unpack(self, packed: np.ndarray, k: int, w: int, due, wf_sel):
        """(audio, pwr, wf or None, rds) of a step that ran at channel
        width k with a view table of w rows."""
        cfg = self.cfg
        if self.sharded:
            rows = self.pipe.due_cap_local if due is not None else 0
            audio, pwr, wf, rds = unpack_outputs_sharded(
                packed, self.pipe.n, cfg.hop_batch, k,
                cfg.audio_fft_size // 2, w, self.pipe.view_cap, rows,
                decim=self.pipe.decim, nch=cfg.audio_channels,
                rds_t=self.pipe.rds_t)
            if wf is not None:
                wf = wf[wf_sel]  # padded per-shard rows -> due order
            return audio, pwr, wf, rds
        d = self.pipe.due_cap if due is not None else 0
        audio, pwr, wf, rds = unpack_outputs(
            packed, cfg.hop_batch, k, cfg.audio_fft_size // 2, d, w,
            self.pipe.view_cap, decim=self.pipe.decim,
            nch=cfg.audio_channels, rds_t=self.pipe.rds_t)
        return audio, pwr, wf if due is not None else None, rds

    def _device_loop(self):
        cfg = self.cfg
        state = self.pipe.init_state()
        scalars_per_sample = 1 if cfg.is_real else 2
        # (frame0, fetch, due_list_or_None, wf_sel, wf_meta, audio_meta,
        #  (k, w), t_start) -- wf_sel maps the mesh's per-shard padded wf
        #  rows to the due list's order; (k, w) are the channel-bucket
        #  and view-table widths the step RAN at, which flush must unpack
        #  with even if the current widths have changed since
        pending = None
        was_idle = False
        # active-channel bucketing (single device only: the mesh shards
        # the fixed channel axis): run the step at the small table width
        # whenever every live slot fits, full width otherwise
        small = (cfg.channel_bucket
                 if (not self.sharded
                     and 0 < cfg.channel_bucket < cfg.max_channels)
                 else 0)
        k_cur = small or cfg.max_channels
        if small:
            state = self.pipe.resize_channel_rows(state, k_cur)
        shrink_streak = 0

        try:
            # warm every (bucket, waterfall-mode) variant once before
            # serving, so cuFFT plans, kernel builds and allocator pools
            # exist before the first listener arrives
            t0 = time.monotonic()
            if self.device.type == "cuda":
                # the warm-up's empty table runs no AM, RDS or noise
                # stage: build their kernels here, not on a listener's
                # first opt-in
                build_all(all_kernels())
            self._refresh_table()
            halo = 0 if self.sharded else self.source.wire_per_hop
            zeros = np.zeros(self.source.block_wire + halo, self.source.dtype)
            raw = self._prepare_raw(zeros)
            for k in ([small, None] if small else [None]):
                warm_state = self.pipe.init_state()
                if k is not None:
                    warm_state = self.pipe.resize_channel_rows(warm_state, k)
                table, views = self._tables_for(k)
                for m in ("views", "off"):
                    warm_state, out = self.pipe.step(warm_state, raw,
                                                     table, views, m)
                    _Fetch(out.packed).result()
            del warm_state
            where = (f"mesh x{cfg.mesh_devices} on "
                     f"{', '.join(map(str, self.devices))}"
                     if self.sharded else str(self.device))
            print(f"device pipeline warmed up in {time.monotonic()-t0:.1f}s "
                  f"({where}"
                  f"{', bucket %d/%d' % (small, cfg.max_channels) if small else ''})",
                  flush=True)
        except Exception as e:
            self.metrics.device_errors += 1
            self.metrics.last_device_error = repr(e)[:300]
            import traceback

            traceback.print_exc()

        def flush_pending():
            nonlocal pending
            if pending is None:
                return
            frame0, fetch, due, wf_sel, wf_meta, audio_meta, kw, t0 = pending
            pending = None
            try:
                packed = fetch.result()
            except Exception as e:
                self.metrics.device_errors += 1
                self.metrics.last_device_error = repr(e)[:300]
                return
            # (channel, view-table) widths the step actually RAN with
            audio, pwr, wf, rds = self._unpack(packed, *kw, due, wf_sel)
            self.metrics.step_seconds.append(time.monotonic() - t0)
            try:
                self.consumer(frame0, audio, pwr, wf,
                              due if due is not None else [],
                              wf_meta, audio_meta, rds)
            except Exception:
                import traceback

                traceback.print_exc()

        while not self._stop.is_set():
            try:
                block = self._queue.get(timeout=0.25)
            except queue.Empty:
                flush_pending()
                continue
            if block is None:
                break
            self.metrics.samples += (
                self.source.block_wire // scalars_per_sample
            )
            # skip all compute when nobody is listening (src/fft.cpp:72-79);
            # state is intentionally left stale, like the reference.
            if not self.audio_active() and not self.waterfall_active():
                flush_pending()
                self.metrics.idle_frames += cfg.hop_batch
                self.metrics.frames += cfg.hop_batch
                was_idle = True
                continue
            if was_idle and self.sharded:
                # the mesh keeps the overlap halo on the device, so it
                # went stale across the idle gap (the single-device path
                # refreshes its host halo on every discarded block):
                # re-init to a zero halo like a cold start, seeding the
                # stream's hop parity so the (-1)^(m*hop) fix-up stays
                # polarity-continuous
                state = self.pipe.init_state(self.metrics.frames)
            was_idle = False
            resets = self._refresh_table()
            if small:
                # bucket decision from THIS snapshot: grow immediately
                # (a slot above the bucket must demodulate next step),
                # shrink only after a sustained quiet streak to avoid
                # resize thrash around the boundary
                hw = self._high_water()
                want = small if hw <= small else cfg.max_channels
                if want > k_cur or (want < k_cur
                                    and shrink_streak >= self.shrink_after):
                    state = self.pipe.resize_channel_rows(state, want)
                    k_cur = want
                    shrink_streak = 0
                elif want < k_cur:
                    shrink_streak += 1
                else:
                    shrink_streak = 0
                if resets is not None:
                    resets = resets[:k_cur]
            self.metrics.channel_rows = k_cur
            table, views = self._tables_for(k_cur if small else None)
            frame0 = self.metrics.frames
            due = (waterfall_due_positions(cfg, frame0)
                   if self.waterfall_active() else [])
            mode = "views" if due else "off"
            t0 = time.monotonic()
            if resets is not None:
                resets = to_device(resets, torch.int32, self.device)
            due_idx, wf_sel = (self._due_tensor(frame0, due) if due
                               else (None, None))
            wf_meta = self._wf_meta
            audio_meta = self._audio_meta
            try:
                raw = self._prepare_raw(block)
                state, out = self.pipe.step(state, raw, table,
                                            views, mode, reset=resets,
                                            due_idx=due_idx)
                # start the device->host copy of THIS step's outputs now
                fetch = _Fetch(out.packed)
            except Exception as e:
                # surface device errors instead of silently killing the
                # DSP thread; rebuild the state and keep serving
                self.metrics.device_errors += 1
                self.metrics.last_device_error = repr(e)[:300]
                import traceback

                traceback.print_exc()
                # the PREVIOUS step completed before this one failed --
                # deliver it (flush_pending tolerates a dead device and
                # counts its own error) instead of dropping a good step
                flush_pending()
                self.metrics.frames += cfg.hop_batch
                # seed the rebuilt counter with the NEXT step's stream
                # parity so the (-1)^(m*hop) fix-up stays polarity-
                # continuous across the rebuild
                state = self.pipe.init_state(self.metrics.frames)
                if small and k_cur != cfg.max_channels:
                    state = self.pipe.resize_channel_rows(state, k_cur)
                continue
            self.metrics.frames += cfg.hop_batch
            # one step in flight: fetch the previous step's outputs only
            # after this one is queued (overlaps transfer & compute)
            flush_pending()
            pending = (frame0, fetch, due if due else None, wf_sel, wf_meta,
                       audio_meta, (k_cur, int(views.start.shape[0])), t0)
            if self._queue.empty():
                # input-paced (realtime SDR slower than the device):
                # fetch NOW instead of idling until the next block, so
                # step_seconds measures device+fetch time, not pacing
                flush_pending()
        flush_pending()

