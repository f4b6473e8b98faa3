"""Channel + waterfall slice registries.

The reference keeps per-client slices in mutex-guarded multimaps keyed
by (l, r) (reference: src/spectrumserver.h:160-174, re-keyed on retune
in src/signal.cpp:81-94 and src/waterfall.cpp:25-42).  Here the audio
side is a dense slot table feeding the device ChannelTable (static
[max_channels] arrays, masked by `active`) -- the host-side face of the
batched channelizer -- and the waterfall side is a plain dict, since
waterfall slicing happens on host over the already-computed pyramid.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..config import ServerConfig

MODE_CODES = {"USB": 0, "LSB": 1, "AM": 2, "FM": 3}

# Device reset-mask codes (pipeline.audio_from_spectra):
RESET_NONE = 0   # keep carries
RESET_FULL = 1   # zero all carries (fresh slot: overlap, DC, AGC)
RESET_AGC = 2    # zero only the AGC (demodulation change, signal.cpp:327)


@dataclass
class AudioSlot:
    slot: int
    l: int = 0
    r: int = 0
    mid: float = 0.0
    mode: str = "USB"
    unique_id: str = ""
    user_id: str = ""
    mute: bool = False
    nr: bool = False
    rds: bool = False
    am_env: bool = False  # AM envelope opt-out of the default PLL sync


@dataclass
class WaterfallSlot:
    level: int = 0
    l: int = 0
    r: int = 0
    user_id: str = ""


class ChannelRegistry:
    """Dense audio-channel slot allocator + device-table builder.

    slot_offset/slot_count restrict ALLOCATION to a sub-range for the
    multi-host serving partition (parallel/multihost.py): each host
    serves the listeners whose channel shards live on its devices.  The
    table arrays stay full-width; rows outside the range are filled by
    merge_rows() from the other hosts' registries."""

    def __init__(self, cfg: ServerConfig, slot_offset: int = 0,
                 slot_count: int | None = None):
        self.cfg = cfg
        c = cfg.max_channels
        self.slot_offset = slot_offset
        self.slot_count = slot_count if slot_count is not None else c
        self._lock = threading.Lock()
        self._free = list(range(slot_offset + self.slot_count - 1,
                                slot_offset - 1, -1))
        self.slots: dict[int, AudioSlot] = {}
        self.l = np.zeros(c, np.int32)
        self.r = np.zeros(c, np.int32)
        self.m_idx = np.zeros(c, np.int32)
        self.mode = np.zeros(c, np.int32)
        self.active = np.zeros(c, bool)
        self.nr = np.zeros(c, bool)   # per-client spectral NR opt-in
        self.rds = np.zeros(c, bool)  # per-client FM-RDS opt-in
        # per-client AM envelope opt-out of the default carrier-sync
        # PLL (signal.cpp:242-257; the reference picks one at build
        # time, here each listener can)
        self.am_env = np.zeros(c, bool)
        # fractional mid (packet metadata only; the device uses m_idx):
        # snapshotted WITH the table so in-flight steps are labeled with
        # the coordinates they were demodulated at
        self.mid = np.zeros(c, np.float64)
        self.version = 0  # bumped on any change; driver re-uploads the table
        self._fresh: set[int] = set()      # slots needing a full state reset
        self._agc_fresh: set[int] = set()  # slots needing an AGC-only reset

    # -------------------------------------------------------------- slots
    def acquire(self, unique_id: str) -> AudioSlot | None:
        with self._lock:
            if not self._free:
                return None
            s = self._free.pop()
            slot = AudioSlot(slot=s, unique_id=unique_id)
            self.slots[s] = slot
            self.active[s] = False
            self._fresh.add(s)  # fresh per-client scratch (signal.cpp:8-79)
            self.version += 1
            return slot

    def release(self, slot: AudioSlot) -> None:
        with self._lock:
            if slot.slot in self.slots:
                del self.slots[slot.slot]
                self.active[slot.slot] = False
                self.nr[slot.slot] = False
                self.rds[slot.slot] = False
                self.am_env[slot.slot] = False
                self._fresh.discard(slot.slot)
                self._agc_fresh.discard(slot.slot)
                self._free.append(slot.slot)
                self.version += 1

    def retune(self, slot: AudioSlot, l: int, mid: float, r: int) -> bool:
        """Validation per src/signal.cpp:300-314: 0<=l<=r<R and
        r-l <= audio_fft_size.  Returns whether the retune was ACCEPTED
        so callers can gate their side effects (RDS decoder reset,
        tuning-change broadcast) on an actual change."""
        cfg = self.cfg
        if not np.isfinite(mid):
            return False
        if l < 0 or l >= cfg.fft_result_size or r < 0 or r >= cfg.fft_result_size:
            return False
        if l > r or r - l > cfg.audio_fft_size:
            return False
        self._apply(slot, l, mid, r)
        return True

    def set_default_range(self, slot: AudioSlot) -> None:
        """Apply the config defaults WITHOUT the command validation: the
        reference routes defaults through set_audio_range directly
        (websocket.cpp:145), and clamped defaults can sit exactly at
        r == fft_result_size, which on_window_message would reject --
        so r is clamped to fft_result_size INCLUSIVE here (the device
        side handles r == R via the DC-wrap spectrum extension)."""
        cfg = self.cfg
        l = max(0, min(cfg.default_l, cfg.fft_result_size - 1))
        r = max(l, min(cfg.default_r, cfg.fft_result_size))
        r = min(r, l + cfg.audio_fft_size)
        self._apply(slot, l, cfg.default_m, r)

    def _apply(self, slot: AudioSlot, l: int, mid: float, r: int) -> None:
        with self._lock:
            slot.l, slot.r, slot.mid = l, r, mid
            s = slot.slot
            self.l[s] = l
            self.r[s] = r
            # any finite mid is accepted (the reference accepts it too
            # and its copy-intersection yields silence when m is outside
            # the slice, src/signal.cpp:106-137; the device channelizer's
            # validity masks reproduce that) -- but the int32 table entry
            # must be clamped or np.floor(3e9) would raise OverflowError
            # mid-update, leaving the registry half-applied
            self.m_idx[s] = int(np.clip(np.floor(mid), -2**31, 2**31 - 1))
            self.mid[s] = mid
            self.active[s] = True
            self.version += 1

    def set_mode(self, slot: AudioSlot, mode: str) -> bool:
        """Demodulation change.  The reference resets the client's AGC on
        EVERY demodulation message, even an unrecognized mode string
        (src/signal.cpp:315-328: the branch chain may all miss, agc.reset()
        runs unconditionally)."""
        with self._lock:
            self._agc_fresh.add(slot.slot)
            self.version += 1
            if mode not in MODE_CODES:
                return False
            slot.mode = mode
            self.mode[slot.slot] = MODE_CODES[mode]
            return True

    def set_nr(self, slot: AudioSlot, enabled: bool) -> None:
        """Per-client spectral NR opt-in ({"cmd":"nr"} extension; only
        effective when the server runs with [input] nr=true)."""
        with self._lock:
            self.nr[slot.slot] = bool(enabled)
            slot.nr = bool(enabled)
            self.version += 1

    def set_rds(self, slot: AudioSlot, enabled: bool) -> None:
        """Per-client FM-RDS opt-in ({"cmd":"rds"} extension; only
        effective when the server runs with [input] rds=true)."""
        with self._lock:
            self.rds[slot.slot] = bool(enabled)
            slot.rds = bool(enabled)
            self.version += 1

    def set_am_sync(self, slot: AudioSlot, enabled: bool) -> None:
        """Per-client AM detector choice ({"cmd":"am_sync"} extension):
        enabled=False opts this listener out of the default PLL carrier
        sync to plain envelope detection; only effective when the
        server runs with [input] am_sync=true (the default).

        Re-enabling sync queues a full carry reset for the slot: while
        the listener was on envelope the PLL carries froze (the cond
        branch doesn't run), so resuming from the stale carrier_prev/
        pll_phase would sum minutes-old carrier into the detector and
        re-lock from an arbitrary phase -- an audible pop.  A zeroed
        restart is the same deterministic ramp a fresh slot gets."""
        with self._lock:
            was_env = bool(self.am_env[slot.slot])
            self.am_env[slot.slot] = not enabled
            slot.am_env = not enabled
            if enabled and was_env:
                self._fresh.add(slot.slot)
            self.version += 1

    # ------------------------------------------------------------- device
    def snapshot(self) -> tuple[int, tuple[np.ndarray, ...],
                                np.ndarray | None,
                                tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Atomic (version, table arrays, one-shot reset mask,
        (l, r, mid) packet-metadata arrays).

        The metadata triple rides with each submitted step so audio
        packets are labeled with the slice the PCM was actually
        demodulated at, not the registry's current (possibly
        retuned-in-flight) values -- same rule as the waterfall wf_meta.

        The reset mask is int32 per RESET_* codes.  Full resets are only
        consumed for slots that are *active in this same snapshot*: a
        freshly acquired slot whose default range hasn't been applied yet
        stays pending, so the reset and the slot's table row always reach
        the device in the same step (otherwise the slot runs a step of
        silence post-reset and the AGC gain ramps to ~2e9 before real
        audio arrives -- a full-scale blast on connect)."""
        with self._lock:
            mask = None
            if self._fresh or self._agc_fresh:
                mask = np.zeros(self.l.shape[0], np.int32)
                for s in self._agc_fresh:
                    mask[s] = RESET_AGC
                self._agc_fresh.clear()
                consumed = {s for s in self._fresh if self.active[s]}
                for s in consumed:
                    mask[s] = RESET_FULL
                self._fresh -= consumed
                if not mask.any():
                    mask = None
            return self.version, (
                self.l.copy(), self.r.copy(), self.m_idx.copy(),
                self.mode.copy(), self.active.copy(), self.nr.copy(),
                self.rds.copy(), self.am_env.copy(),
            ), mask, (self.l.copy(), self.r.copy(), self.mid.copy())

    @property
    def count(self) -> int:
        return len(self.slots)

    # --------------------------------------------------- multi-host sync
    def range_rows(self) -> tuple[int, int, tuple[np.ndarray, ...],
                                  np.ndarray | None]:
        """This host's authoritative sub-range (offset, count, arrays,
        reset mask) for upstream sync.  Consumes pending resets like
        snapshot() (active-gated)."""
        o, n = self.slot_offset, self.slot_count
        with self._lock:
            mask = None
            pend = {s for s in (self._fresh | self._agc_fresh)
                    if o <= s < o + n}
            if pend:
                mask = np.zeros(n, np.int32)
                for s in self._agc_fresh & pend:
                    mask[s - o] = RESET_AGC
                consumed = {s for s in self._fresh & pend if self.active[s]}
                for s in consumed:
                    mask[s - o] = RESET_FULL
                self._fresh -= consumed
                self._agc_fresh -= pend
                if not mask.any():
                    mask = None
            sl = slice(o, o + n)
            return o, n, (self.l[sl].copy(), self.r[sl].copy(),
                          self.m_idx[sl].copy(), self.mode[sl].copy(),
                          self.active[sl].copy(),
                          self.mid[sl].copy(),
                          self.nr[sl].copy(),
                          self.rds[sl].copy(),
                          self.am_env[sl].copy()), mask

    def merge_rows(self, offset: int, arrays: tuple[np.ndarray, ...],
                   resets: np.ndarray | None) -> None:
        """Ingest-host side: apply another host's authoritative rows
        (and queue its resets) into the global table."""
        n = arrays[0].shape[0]
        sl = slice(offset, offset + n)
        with self._lock:
            self.l[sl], self.r[sl] = arrays[0], arrays[1]
            self.m_idx[sl], self.mode[sl] = arrays[2], arrays[3]
            self.active[sl] = arrays[4]
            self.mid[sl] = arrays[5]
            if len(arrays) > 6:
                self.nr[sl] = arrays[6]
            if len(arrays) > 7:
                self.rds[sl] = arrays[7]
            if len(arrays) > 8:
                self.am_env[sl] = arrays[8]
            if resets is not None:
                for i in np.nonzero(resets)[0]:
                    s = offset + int(i)
                    if resets[i] == RESET_FULL:
                        self._fresh.add(s)
                    else:
                        self._agc_fresh.add(s)
            self.version += 1

    @property
    def remote_count(self) -> int:
        """Active rows OUTSIDE this host's range (merged from peers)."""
        o, n = self.slot_offset, self.slot_count
        return int(self.active.sum()) - int(self.active[o:o + n].sum())

    def uid_rows(self) -> dict[int, str]:
        """{slot: unique_id} for this host's live slots (multi-host
        /events sync: uids ride the cluster link so every host can
        attribute remote tuning changes)."""
        with self._lock:
            return {s: sl.unique_id for s, sl in self.slots.items()}


class WaterfallRegistry:
    """Dense waterfall slot table (device view gathers) + level selection
    per src/waterfall.cpp:53-94.

    Like the audio ChannelRegistry, waterfall clients occupy static
    slots; the device gathers each slot's (level-offset + l, r - l)
    view out of the flat pyramid so only the viewed rows cross PCIe.
    """

    def __init__(self, cfg: ServerConfig, level_offsets: list[int],
                 max_slots: int | None = None, slot_offset: int = 0,
                 slot_count: int | None = None):
        self.cfg = cfg
        self.level_offsets = level_offsets
        n = max_slots or cfg.max_channels
        self.max_slots = n
        self.slot_offset = slot_offset
        self.slot_count = slot_count if slot_count is not None else n
        self._lock = threading.Lock()
        self._free = list(range(slot_offset + self.slot_count - 1,
                                slot_offset - 1, -1))
        self.clients: dict[int, WaterfallSlot] = {}
        self.start = np.zeros(n, np.int32)
        self.length = np.zeros(n, np.int32)
        # per-slot display coordinates, snapshotted WITH the view table so
        # packets emitted for a pipelined-in-flight step carry the l/r the
        # rows were actually gathered at (a retune between submit and
        # dispatch must not relabel old bytes)
        self.l = np.zeros(n, np.int32)
        self.r = np.zeros(n, np.int32)
        self.level = np.zeros(n, np.int32)
        self.version = 0
        self.view_cap = cfg.view_cap

    def acquire(self) -> tuple[int, WaterfallSlot] | tuple[None, None]:
        with self._lock:
            if not self._free:
                return None, None
            cid = self._free.pop()
            # default: entire spectrum at the coarsest level
            ws = WaterfallSlot(level=self.cfg.downsample_levels - 1,
                               l=0, r=self.cfg.waterfall_size)
            self.clients[cid] = ws
            self._set_view(cid, ws)
            return cid, ws

    def release(self, cid: int) -> None:
        with self._lock:
            if cid in self.clients:
                del self.clients[cid]
                self.length[cid] = 0
                self._free.append(cid)
                self.version += 1

    def _set_view(self, cid: int, ws: WaterfallSlot) -> None:
        self.start[cid] = self.level_offsets[ws.level] + ws.l
        self.length[cid] = min(ws.r - ws.l, self.view_cap)
        self.l[cid], self.r[cid], self.level[cid] = ws.l, ws.r, ws.level
        self.version += 1

    def retune(self, cid: int, ws: WaterfallSlot, new_l: int, new_r: int) -> None:
        """Pick the pyramid level whose slice width lands closest to
        waterfall_size points (src/waterfall.cpp:53-94)."""
        cfg = self.cfg
        # reject out-of-spectrum requests like the audio side does
        # (signal.cpp:300-314 validates r < fft_result_size): without
        # the upper bound an absurd width never beats the level-search
        # init and the raw level-0 l/r clamp to a zero-width view
        if (new_l < 0 or new_r < 0 or new_l >= new_r
                or new_r > cfg.fft_result_size):
            return
        l_f, r_f = float(new_l), float(new_r)
        best_level = cfg.downsample_levels - 1
        best_diff = cfg.waterfall_size * 2.0
        sel_l, sel_r = new_l, new_r
        for i in range(cfg.downsample_levels):
            send_size = abs((r_f - l_f) - cfg.waterfall_size)
            if send_size < best_diff:
                best_diff = send_size
                best_level = i
                sel_l = round(l_f)
                sel_r = round(r_f)
            l_f /= 2.0
            r_f /= 2.0
        # clamp into the selected level's row (the reference reads out of
        # bounds for absurd r; we don't)
        row_w = cfg.fft_result_size >> best_level
        sel_l = max(0, min(sel_l, row_w))
        sel_r = max(sel_l, min(sel_r, row_w))
        with self._lock:
            ws.level, ws.l, ws.r = best_level, sel_l, sel_r
            self._set_view(cid, ws)

    def snapshot(self) -> tuple[int, np.ndarray, np.ndarray,
                                tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(version, start, length, (l, r, level)) -- the coordinate
        triple rides with each submitted step (see class docstring)."""
        with self._lock:
            return (self.version, self.start.copy(), self.length.copy(),
                    (self.l.copy(), self.r.copy(), self.level.copy()))

    # --------------------------------------------------- multi-host sync
    def range_rows(self) -> tuple[int, int, tuple[np.ndarray, ...]]:
        o, n = self.slot_offset, self.slot_count
        sl = slice(o, o + n)
        with self._lock:
            return o, n, (self.start[sl].copy(), self.length[sl].copy(),
                          self.l[sl].copy(), self.r[sl].copy(),
                          self.level[sl].copy())

    def merge_rows(self, offset: int, arrays: tuple[np.ndarray, ...]) -> None:
        n = arrays[0].shape[0]
        sl = slice(offset, offset + n)
        with self._lock:
            (self.start[sl], self.length[sl], self.l[sl], self.r[sl],
             self.level[sl]) = arrays
            self.version += 1

    @property
    def count(self) -> int:
        return len(self.clients)
