"""Websocket clients and stream decoders for the PyTorch port's server,
free of the JAX package and of python-zstandard.

The card's machine has neither JAX nor python-zstandard, so the JAX
side's clients (tools/stress.py, tools/verify/client.py) cannot decode
there: their FLAC decoder lives in tests/test_codecs.py, which imports
``phantomsdr_tpu``, and their waterfall decoder is python-zstandard.
This module keeps its own copies:

- ``decode_flac``: a copy of tests/test_codecs.py's from-spec decoder
  (RFC 9639: constant / fixed / LPC subframes, Rice residuals, stereo
  decorrelation; CRC-8 and CRC-16 checked), raising ValueError;
- ``cbor_decode``: a copy of tools/verify/client.py's;
- zstd rows through the port's ``runtime.codecs.ZstdDecompressStream``
  (the system libzstd), Opus through its ``OpusChunkDecoder`` (libopus)
  and AV1 through its ``runtime.av1.AV1Decoder`` (libaom);
- ``audio_client`` / ``wf_client``: tools/stress.py's churning clients
  on those decoders, with its RDS and shared-window options;
- ``loop_lag``: the clients' own event-loop lag, so that a client-side
  bottleneck is not read as the server's;
- ``PipeFeeder``: an SDR's side of ``rtl_sdr ... - | python -m
  phantomsdr_tpu_torch``: wire bytes paced by the clock into a pipe
  from a looped pool of blocks, with how far behind its schedule it
  fell;
- ``tone_check``: tools/verify/client.py's ``tone`` variant (the AM
  tone at its Hz through the FLAC stream, the waterfall peak on its
  carrier, the probes that must not kill the stream, /events), on
  ``collect_audio``, which tools/torch_verify.py shares for the other
  variants; it tunes through ``hz_to_bin``, so it also checks a
  real-input server.
"""

from __future__ import annotations

import asyncio
import fcntl
import io
import json
import os
import random
import struct
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


# ----------------------------------------------------------- FLAC decoder

def _crc_table(poly: int, width: int) -> list[int]:
    top, mask = 1 << (width - 1), (1 << width) - 1
    tab = []
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        tab.append(crc & mask)
    return tab


_CRC8_TAB = _crc_table(0x07, 8)     # frame-header CRC (RFC 9639 9.1.1)
_CRC16_TAB = _crc_table(0x8005, 16)  # frame CRC


def _crc8(d: bytes) -> int:
    crc = 0
    for b in d:
        crc = _CRC8_TAB[crc ^ b]
    return crc


def _crc16(d: bytes) -> int:
    crc = 0
    for b in d:
        crc = _CRC16_TAB[(crc >> 8) ^ b] ^ ((crc << 8) & 0xFFFF)
    return crc


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"flac: {what}")


class _BitReader:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0  # bit position

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.d[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def unary(self) -> int:
        q = 0
        while self.bits(1) == 0:
            q += 1
        return q

    def align(self):
        self.pos = (self.pos + 7) & ~7


def _signed(v: int, bits: int) -> int:
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def _residual(br: _BitReader, n: int, order: int) -> list[int]:
    """Rice-coded residual, any partition order (RFC 9639 9.2.7: the
    first partition is ``order`` samples short)."""
    _need(br.bits(2) == 0, "only 4-bit Rice parameters are emitted")
    po = br.bits(4)
    psize = n >> po
    res = []
    for part in range(1 << po):
        k = br.bits(4)
        _need(k != 15, "escaped partition")
        for _ in range(psize - (order if part == 0 else 0)):
            q = br.unary()
            u = (q << k) | (br.bits(k) if k else 0)
            res.append((u >> 1) ^ -(u & 1))
    return res


_FIXED = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _subframe(br: _BitReader, n: int, bps: int = 16) -> list[int]:
    """bps = 17 for the side channel of a stereo-decorrelated frame."""
    _need(br.bits(1) == 0, "subframe padding bit")
    sub = br.bits(6)
    _need(br.bits(1) == 0, "wasted bits")
    if sub == 0:  # CONSTANT
        return [_signed(br.bits(bps), bps)] * n
    if sub == 1:  # VERBATIM
        return [_signed(br.bits(bps), bps) for _ in range(n)]
    if (sub >> 3) == 1:  # FIXED
        order = sub & 7
        _need(order in _FIXED, f"fixed order {order}")
        x = [_signed(br.bits(bps), bps) for _ in range(order)]
        coef, shift = _FIXED[order], 0
    else:  # LPC
        _need(bool(sub & 0x20), f"subframe type {sub:06b}")
        order = (sub & 0x1F) + 1
        x = [_signed(br.bits(bps), bps) for _ in range(order)]
        precision = br.bits(4) + 1
        _need(precision != 16, "LPC precision")
        shift = br.bits(5)
        coef = [_signed(br.bits(precision), precision) for _ in range(order)]
    for i, r in enumerate(_residual(br, n, order)):
        pred = sum(c * x[order + i - 1 - j] for j, c in enumerate(coef))
        x.append(r + (pred >> shift))  # python >> floors = arithmetic
    return x


def _undecorrelate(chan: int, subs: list[list[int]]) -> list[list[int]]:
    """Channel assignment 8/9/10 -> [left, right] (RFC 9639 4.1)."""
    a, b = subs
    if chan == 8:     # left-side: b = left - right
        return [a, [l - s for l, s in zip(a, b)]]
    if chan == 9:     # right-side: a = left - right
        return [[r + s for s, r in zip(a, b)], b]
    left, right = [], []  # mid-side: a = (l+r)>>1, b = l-r
    for m, s in zip(a, b):
        m = (m << 1) | (s & 1)
        left.append((m + s) >> 1)
        right.append((m - s) >> 1)
    return [left, right]


def decode_flac(data: bytes) -> tuple[int, np.ndarray]:
    """Decode the subset the server's encoder emits (16-bit mono or
    stereo).  Returns (sample_rate, samples int32), stereo interleaved
    L0 R0 L1 R1 ...; raises ValueError on a malformed stream."""
    _need(data[:4] == b"fLaC", "stream marker")
    pos = 4
    while True:  # metadata blocks
        hdr = data[pos:pos + 4]
        _need(len(hdr) == 4, "truncated metadata")
        pos += 4 + int.from_bytes(hdr[1:4], "big")
        if hdr[0] & 0x80:
            break
    out: list[int] = []
    sample_rate = None
    try:
        while pos < len(data):
            br = _BitReader(data[pos:])
            _need(br.bits(14) == 0x3FFE, "lost sync")
            br.bits(2)  # reserved, blocking strategy
            bs_code, sr_code, chan = br.bits(4), br.bits(4), br.bits(4)
            _need(chan in (0, 1, 8, 9, 10), f"channel assignment {chan}")
            channels = 1 if chan == 0 else 2
            _need(br.bits(3) == 4, "16 bits a sample")
            br.bits(1)
            first = br.bits(8)  # UTF-8 coded frame number
            extra = 0
            if first >= 0xC0:
                x = first
                while x & 0x40:
                    extra += 1
                    x <<= 1
            br.bits(8 * extra)
            if bs_code == 6:
                n = br.bits(8) + 1
            elif bs_code == 7:
                n = br.bits(16) + 1
            elif bs_code == 1:
                n = 192
            elif 2 <= bs_code <= 5:
                n = 576 << (bs_code - 2)
            else:
                n = 256 << (bs_code - 8)
            if sr_code == 13:
                sample_rate = br.bits(16)
            elif sr_code == 14:
                sample_rate = br.bits(16) * 10
            elif sr_code == 12:
                sample_rate = br.bits(8) * 1000
            crc8 = br.bits(8)
            _need(crc8 == _crc8(data[pos:pos + br.pos // 8 - 1]),
                  "frame header CRC-8")
            subs = [_subframe(br, n, 16 + (ch == (0 if chan == 9 else 1)
                                           and chan >= 8))
                    for ch in range(channels)]
            if chan >= 8:
                subs = _undecorrelate(chan, subs)
            for i in range(n):
                for s in subs:
                    out.append(s[i])
            br.align()
            crc16 = br.bits(16)
            frame_len = br.pos // 8
            _need(crc16 == _crc16(data[pos:pos + frame_len - 2]),
                  "frame CRC-16")
            pos += frame_len
    except IndexError:
        raise ValueError("flac: truncated frame") from None
    return sample_rate, np.array(out, np.int32)


# ------------------------------------------------------------------- CBOR

def cbor_decode(data: bytes):
    """Decoder for the server's nlohmann-compatible packets (maps,
    text/byte strings, ints, 64-bit doubles)."""
    return _cb(data, 0)[0]


def _cb(b: bytes, p: int):
    ib = b[p]
    major, info = ib >> 5, ib & 0x1F
    p += 1
    if info < 24:
        val = info
    elif info == 24:
        val = b[p]
        p += 1
    elif info == 25:
        val = struct.unpack_from(">H", b, p)[0]
        p += 2
    elif info == 26:
        val = struct.unpack_from(">I", b, p)[0]
        p += 4
    elif info == 27:
        val = struct.unpack_from(">Q", b, p)[0]
        p += 8
    else:
        raise ValueError(f"cbor info {info}")
    if major == 0:
        return val, p
    if major == 1:
        return -1 - val, p
    if major == 2:
        return b[p:p + val], p + val
    if major == 3:
        return b[p:p + val].decode("utf-8"), p + val
    if major == 4:
        out = []
        for _ in range(val):
            v, p = _cb(b, p)
            out.append(v)
        return out, p
    if major == 5:
        out = {}
        for _ in range(val):
            k, p = _cb(b, p)
            out[k], p = _cb(b, p)
        return out, p
    if major == 7:
        if info == 27:  # the 8 bytes were already consumed as "val"
            return struct.unpack(">d", struct.pack(">Q", val))[0], p
        if info == 26:
            return struct.unpack(">f", struct.pack(">I", val))[0], p
        if info in (20, 21):
            return info == 21, p
        if info == 22:
            return None, p
    raise ValueError(f"cbor major {major} info {info}")


# ---------------------------------------------------------------- clients

def new_stats() -> dict:
    """The counters the clients share (``last_error``: the repr of the
    last error counted; ``audio_pkts_by_client``: each audio client's
    packets by its index)."""
    return dict(audio_pkts=0, audio_bytes=0, wf_pkts=0, wf_bytes=0,
                audio_errors=0, wf_errors=0, audio_closed=0, wf_closed=0,
                retunes=0, reconnects=0, rds_frames=0, rds_synced=0,
                decoded_audio_samples=0, decoded_wf_rows=0,
                decode_errors=0, deflate_acks=0, last_error=None,
                audio_pkts_by_client={})


def _flac_count(chunks) -> tuple[int, int]:
    """(samples, errors) of one audio session's FLAC stream."""
    try:
        return int(decode_flac(b"".join(chunks))[1].size), 0
    except ValueError:
        return 0, 1


async def audio_client(session, url, idx, stats, stop, churn_secs=0.0,
                       rds=False, same_window=False, decode=False,
                       executor=None):
    """One audio listener (tools/stress.py's): with churn_secs > 0 it
    connects, listens, retunes mid-life, disconnects and reconnects;
    rds=True tunes FM and opts into server-side RDS, counting the
    ``{"type":"rds"}`` text frames; same_window=True puts it on the
    default window's place in the band (the middle, full width), where
    every such listener shares one carrier; decode=True decodes every
    session's stream (FLAC from its start, on ``executor``, Opus packet
    by packet) and counts samples and decode errors."""
    import aiohttp

    from phantomsdr_tpu_torch.runtime.codecs import OpusChunkDecoder

    rng = random.Random(idx)
    loop = asyncio.get_running_loop()
    by_client = stats["audio_pkts_by_client"]
    by_client.setdefault(idx, 0)
    while not stop.is_set():
        chunks = None
        opus_dec = None
        try:
            async with session.ws_connect(url + "/audio",
                                          max_msg_size=1 << 22) as ws:
                info = json.loads((await ws.receive()).data)
                if decode:
                    if info.get("audio_compression", "flac") == "opus":
                        opus_dec = OpusChunkDecoder(
                            48000, info.get("audio_channels", 1))
                    else:
                        chunks = []
                rsize = info["fft_result_size"]
                a = info["audio_max_fft"]
                l = (idx * 131) % max(rsize - a - 1, 1)
                width = min(a, 300)
                if same_window:
                    l, width = (rsize - a) // 2, a
                await ws.send_str(json.dumps({
                    "cmd": "window", "l": l, "m": l + width / 2,
                    "r": l + width}))
                await ws.send_str(json.dumps({
                    "cmd": "demodulation",
                    "demodulation": "FM" if rds else
                    ["USB", "LSB", "AM", "FM"][idx % 4]}))
                if rds:
                    await ws.send_str(json.dumps({"cmd": "rds",
                                                  "enabled": True}))
                deadline = (time.monotonic()
                            + rng.uniform(0.5, 2.0) * churn_secs
                            if churn_secs else None)
                while not stop.is_set():
                    if deadline and time.monotonic() > deadline:
                        break  # disconnect + reconnect (churn)
                    try:
                        msg = await ws.receive(timeout=1)
                    except asyncio.TimeoutError:
                        if churn_secs and rng.random() < 0.3:
                            l2 = rng.randrange(max(rsize - a - 1, 1))
                            await ws.send_str(json.dumps({
                                "cmd": "window", "l": l2,
                                "m": l2 + width / 2, "r": l2 + width}))
                            stats["retunes"] += 1
                        continue
                    if msg.type == aiohttp.WSMsgType.BINARY:
                        stats["audio_pkts"] += 1
                        stats["audio_bytes"] += len(msg.data)
                        by_client[idx] += 1
                        if decode:
                            try:
                                d = bytes(cbor_decode(msg.data)["data"])
                                if opus_dec is not None:
                                    if d:
                                        stats["decoded_audio_samples"] += \
                                            int(opus_dec.decode(d).size)
                                else:
                                    chunks.append(d)
                            except Exception as e:  # counted, run goes on
                                stats["decode_errors"] += 1
                                stats["last_error"] = repr(e)
                    elif msg.type == aiohttp.WSMsgType.TEXT:
                        d = json.loads(msg.data)
                        if d.get("type") == "rds":
                            stats["rds_frames"] += 1
                            if d.get("synced"):
                                stats["rds_synced"] += 1
                    elif msg.type in (aiohttp.WSMsgType.CLOSE,
                                      aiohttp.WSMsgType.CLOSED,
                                      aiohttp.WSMsgType.ERROR):
                        stats["audio_closed"] += 1
                        return
            if not churn_secs or stop.is_set():
                return
            stats["reconnects"] += 1
        except Exception as e:  # counted; a churning client reconnects
            stats["audio_errors"] += 1
            stats["last_error"] = repr(e)
            if not churn_secs:
                return
            await asyncio.sleep(0.5)
        finally:
            # FLAC decodes only from the stream start, so per session
            if chunks:
                try:
                    n, e = await loop.run_in_executor(executor,
                                                      _flac_count, chunks)
                except asyncio.CancelledError:
                    # end-of-run cancellation: still check the stream
                    n, e = _flac_count(chunks)
                    stats["decoded_audio_samples"] += n
                    stats["decode_errors"] += e
                    raise
                stats["decoded_audio_samples"] += n
                stats["decode_errors"] += e
            if opus_dec is not None:
                opus_dec.close()


async def wf_client(session, url, idx, stats, stop, deflate=False,
                    decode=False):
    """One waterfall listener (tools/stress.py's).  deflate=True opts
    into the per-connection raw-deflate extension; decode=True decodes
    every row (zstd / deflate / AV1) and counts rows and errors."""
    import zlib

    import aiohttp

    av1_dec = None
    try:
        async with session.ws_connect(url + "/waterfall",
                                      max_msg_size=1 << 22) as ws:
            info = json.loads((await ws.receive()).data)
            rsize = info["fft_result_size"]
            codec = info.get("waterfall_compression", "zstd")
            span = rsize >> (idx % 3)
            l = (idx * 977) % max(rsize - span, 1)
            await ws.send_str(json.dumps({"cmd": "window", "l": l,
                                          "r": l + span}))
            if deflate and codec == "zstd":
                await ws.send_str(json.dumps(
                    {"cmd": "compression", "waterfall": "deflate"}))
            dfl = dec = None  # dfl: the per-conn deflate stream on ack
            if decode:
                if codec == "av1":
                    from phantomsdr_tpu_torch.runtime.av1 import AV1Decoder

                    av1_dec = AV1Decoder()
                else:
                    from phantomsdr_tpu_torch.runtime.codecs import (
                        ZstdDecompressStream,
                    )

                    dec = ZstdDecompressStream()
            while not stop.is_set():
                try:
                    msg = await ws.receive(timeout=5)
                except asyncio.TimeoutError:
                    continue
                if msg.type == aiohttp.WSMsgType.BINARY:
                    stats["wf_pkts"] += 1
                    stats["wf_bytes"] += len(msg.data)
                    if not decode:
                        continue
                    try:
                        if av1_dec is not None:
                            for frame in av1_dec.decode(msg.data):
                                stats["decoded_wf_rows"] += \
                                    int(frame.shape[0])
                        else:
                            blob = (dfl.decompress(msg.data) if dfl
                                    else dec.decompress(msg.data))
                            cbor_decode(blob)
                            stats["decoded_wf_rows"] += 1
                    except Exception as e:  # counted, run goes on
                        stats["decode_errors"] += 1
                        stats["last_error"] = repr(e)
                elif msg.type == aiohttp.WSMsgType.TEXT:
                    d = json.loads(msg.data)
                    if d.get("type") == "compression" \
                            and d.get("waterfall") == "deflate":
                        # ack: ONE fresh deflate stream starts now
                        dfl = zlib.decompressobj(-15)
                        stats["deflate_acks"] += 1
                elif msg.type in (aiohttp.WSMsgType.CLOSE,
                                  aiohttp.WSMsgType.CLOSED,
                                  aiohttp.WSMsgType.ERROR):
                    stats["wf_closed"] += 1
                    return
    except Exception as e:  # counted: the verdict fails on any
        stats["wf_errors"] += 1
        stats["last_error"] = repr(e)
    finally:
        if av1_dec is not None:
            av1_dec.close()


LAG_PERIOD = 0.05       # s between the loop-lag probe's wake-ups


async def loop_lag(stop: asyncio.Event, lags: list) -> None:
    """Until ``stop``: how late each LAG_PERIOD sleep of this event loop
    wakes, in ms, appended to ``lags`` (a loop busy with the clients'
    own work wakes late, and the server is not at fault for what that
    delays)."""
    loop = asyncio.get_running_loop()
    while not stop.is_set():
        t = loop.time()
        await asyncio.sleep(LAG_PERIOD)
        lags.append((loop.time() - t - LAG_PERIOD) * 1e3)


def percentile(xs, q: float):
    """The ``q`` quantile (0..1) of ``xs`` by rank, or None if empty."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else None


PIPE_BYTES = 1 << 20    # the feeder's pipe buffer (F_SETPIPE_SZ)
FEED_CHUNK = 1 << 20    # the feeder's write: 15 ms of the bench's feed


class PipeFeeder:
    """Wire bytes paced by the clock into ``out`` (a pipe's write end,
    such as a server's stdin), as an SDR writes its samples: ``pool``
    (bytes of whole blocks) is looped, so a tone on an exact FFT bin
    keeps its phase across the wrap, and chunk k (FEED_CHUNK bytes) goes
    out once the
    clock reaches the time its last byte would have been sampled at
    ``rate`` bytes/s (``rate`` None: as fast as the reader drains).

    A chunk's lag is how late its write completes against that time: a
    reader that falls behind fills the pipe, the write blocks, and the
    lag grows.  ``mark`` starts a window: the schedule is anchored
    anew and the counters start from zero; ``stats`` reports the
    window."""

    def __init__(self, out, pool, rate: float | None):
        self.out = out
        self.pool = memoryview(pool).cast("B")
        self.rate = rate
        self.error: str | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pipe-feeder")
        self._gen = 0
        self._window(time.monotonic())

    def _window(self, t0: float) -> None:
        """Anchor the schedule at ``t0`` and zero the window's counters
        (the lock held, or before the thread starts)."""
        self._gen += 1
        self._t0, self._sent, self._chunks = t0, 0, 0
        self._lag_max = self._lag_sum = 0.0

    def start(self) -> "PipeFeeder":
        with self._lock:
            self._window(time.monotonic())
        self._thread.start()
        return self

    def mark(self) -> None:
        with self._lock:
            self._window(time.monotonic())

    def stats(self) -> dict:
        with self._lock:
            secs = time.monotonic() - self._t0
            return {"secs": secs, "bytes": self._sent,
                    "mbps": self._sent / max(secs, 1e-9) / 1e6,
                    "chunks": self._chunks,
                    "max_lag_ms": self._lag_max * 1e3,
                    "mean_lag_ms": (self._lag_sum / self._chunks * 1e3
                                    if self._chunks else None),
                    "error": self.error}

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)

    def _write(self, piece: memoryview) -> None:
        fd = self.out.fileno()
        while piece:
            piece = piece[os.write(fd, piece):]

    def _run(self) -> None:
        n, pos = len(self.pool), 0
        try:
            while not self._stop.is_set():
                piece = self.pool[pos:min(pos + FEED_CHUNK, n)]
                with self._lock:
                    gen, t0, sent = self._gen, self._t0, self._sent
                due = (t0 + (sent + len(piece)) / self.rate
                       if self.rate else time.monotonic())
                if self._stop.wait(max(due - time.monotonic(), 0.0)):
                    return
                self._write(piece)
                lag = max(time.monotonic() - due, 0.0)
                with self._lock:
                    if gen == self._gen:    # not across a mark
                        self._sent += len(piece)
                        self._chunks += 1
                        self._lag_sum += lag
                        self._lag_max = max(self._lag_max, lag)
                pos = (pos + len(piece)) % n
        except OSError as e:    # the reader went away (BrokenPipeError)
            self.error = repr(e)


def feed_pipe(pool, rate: float | None):
    """(the read end of a new OS pipe, a started PipeFeeder on its write
    end); the pipe's buffer is set to PIPE_BYTES where the kernel lets
    it.  Closing the read end ends the feeder."""
    rfd, wfd = os.pipe()
    try:
        fcntl.fcntl(wfd, fcntl.F_SETPIPE_SZ, PIPE_BYTES)
    except (OSError, AttributeError):
        pass
    out = io.open(wfd, "wb", buffering=0)
    return io.open(rfd, "rb"), PipeFeeder(out, pool, rate).start()


def seeded_pool(nbytes: int, seed: int) -> np.ndarray:
    """``nbytes`` of u8 IQ wire bytes made from ``seed``: noise about the
    u8 midpoint, as a receiver gives with no strong signal."""
    rng = np.random.default_rng(seed)
    return np.clip(np.rint(rng.normal(128.0, 24.0, nbytes)), 0,
                   255).astype(np.uint8)


# ------------------------------------------------------------- tone check

def hz_to_bin(info: dict, f_hz: float) -> float:
    """The (fractional) display bin of the frequency ``f_hz`` Hz above
    the server's ``[input] frequency``, from its basic_info: for IQ
    input that frequency is the band's centre and bin 0 lies at
    basefreq = frequency - sps/2, so the bin is (0.5 + f/sps) * R; for
    real input it is bin 0 itself (basefreq = frequency), and the bin is
    f * 2R / sps.  In both, basefreq + bin * total_bandwidth / R is the
    frequency again, the frontend's mapping."""
    r, sps = info["fft_result_size"], info["sps"]
    if info["total_bandwidth"] == sps:      # IQ: the whole sps shown
        return (0.5 + f_hz / sps) * r
    return f_hz * 2 * r / sps


def hz_to_bins(info: dict, hz: int) -> int:
    """Whole display bins in ``hz`` Hz of bandwidth (a window's half
    width): hz * R // sps for IQ, hz * 2R // sps for real input."""
    return hz * info["fft_result_size"] // info["total_bandwidth"]


def _row_peak(raw, hl, hr):
    """tools/verify/client.py's row_peak: the centroid of the max-valued
    run of a row whose wire coords are [hl, hr); (peak_bin, scale)."""
    scale = max(1, round((hr - hl) / len(raw)))
    peak = hl + float(np.mean(np.nonzero(raw == raw.max())[0])) * scale
    return peak, scale


async def collect_audio(session, url, secs, cmds=(), text_frames=None,
                        probes=False, settle=0.0):
    """client.py's collect_audio: (basic_info, every binary payload for
    secs+settle); with ``text_frames`` a list, each JSON text frame (the
    RDS frames) is appended to it."""
    import aiohttp

    chunks = []
    async with session.ws_connect(url + "/audio", max_msg_size=1 << 22) as ws:
        info = json.loads((await ws.receive(timeout=120)).data)
        for c in cmds:
            await ws.send_str(json.dumps(c))
        if probes:
            await ws.send_str("this is not json {{{")
            await ws.send_str(json.dumps(
                {"cmd": "window", "l": -5, "r": 1e9, "m": 0}))
            await ws.send_str(json.dumps(
                {"cmd": "demodulation", "demodulation": "XYZZY"}))
            await ws.send_str("A" * 5000)
        t_end = time.monotonic() + secs + settle
        while time.monotonic() < t_end:
            try:
                msg = await ws.receive(
                    timeout=max(t_end - time.monotonic(), 0.05))
            except asyncio.TimeoutError:
                break
            if msg.type == aiohttp.WSMsgType.BINARY:
                chunks.append(cbor_decode(msg.data)["data"])
            elif msg.type == aiohttp.WSMsgType.TEXT:
                if text_frames is not None:
                    text_frames.append(json.loads(msg.data))
            else:
                break
    return info, chunks


async def _check_waterfall(session, url, truth):
    """client.py's check_waterfall: zstd rows, the peak at the carrier
    bin, l<<level coordinate scaling consistent."""
    import aiohttp

    from phantomsdr_tpu_torch.runtime.codecs import ZstdDecompressStream

    dec = ZstdDecompressStream()
    rows = peak_ok = 0
    async with session.ws_connect(url + "/waterfall",
                                  max_msg_size=1 << 22) as ws:
        info = json.loads((await ws.receive(timeout=120)).data)
        rsize = info["fft_result_size"]
        m_bin = hz_to_bin(info, truth["f_off_hz"])
        span = min(2048, rsize)
        l = int(max(0, min(rsize - span, m_bin - span / 2)))
        await ws.send_str(json.dumps({"cmd": "window", "l": l,
                                      "r": l + span}))
        for _ in range(12):
            try:
                msg = await ws.receive(timeout=4)
            except asyncio.TimeoutError:
                break
            if msg.type != aiohttp.WSMsgType.BINARY:
                continue
            pkt = cbor_decode(dec.decompress(msg.data))
            rows += 1
            raw = np.frombuffer(bytes(pkt["data"]), dtype=np.int8)
            if not len(raw):
                continue
            peak, scale = _row_peak(raw, pkt["l"], pkt["r"])
            if abs(peak - m_bin) < 16 * scale + 8:
                peak_ok += 1
            if peak_ok >= 3:
                break
    return {"waterfall_rows": rows, "peak_ok": peak_ok}


async def tone_check(url: str, truth: dict, secs: float = 8.0) -> dict:
    """tools/verify/client.py's ``tone`` variant against a server at
    ``url`` serving ``captures.py --variant tone``'s capture (FLAC audio,
    zstd waterfall); raises AssertionError on a miss.  ``truth`` names
    the AM carrier by ``f_off_hz``, Hz above the server's ``[input]
    frequency`` (``hz_to_bin``): IQ or real input alike."""
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as s:
        info, _ = await collect_audio(s, url, 0.1, ())
        for k in ("sps", "fft_size", "fft_result_size", "basefreq"):
            assert k in info, f"basic_info missing {k}"
        assert info["sps"] == truth["sps"], info["sps"]
        assert info.get("audio_compression", "flac") == "flac"
        fs = info["audio_max_sps"]
        m = hz_to_bin(info, truth["f_off_hz"])
        off = hz_to_bins(info, 5_000)
        cmds = [{"cmd": "window", "l": int(m - off), "m": m,
                 "r": int(m + off)},
                {"cmd": "demodulation", "demodulation": "AM"}]
        _, chunks = await collect_audio(s, url, secs, cmds, probes=True,
                                        settle=1.0)
        _, samples = await asyncio.get_running_loop().run_in_executor(
            None, decode_flac, b"".join(bytes(c) for c in chunks))
        x = samples.astype(np.float64)[int(1.0 * fs):] / 32768.0
        spec = np.abs(np.fft.rfft((x - x.mean()) * np.hanning(len(x))))
        f_peak = float(np.fft.rfftfreq(len(x), 1.0 / fs)[
            1 + int(np.argmax(spec[1:]))])
        assert abs(f_peak - truth["tone_hz"]) < 20, \
            f"tone at {f_peak:.1f} Hz, wanted {truth['tone_hz']}"
        wf = await _check_waterfall(s, url, truth)
        assert wf["waterfall_rows"] > 0, "no waterfall rows"
        assert wf["peak_ok"] >= 1, "waterfall peak never at carrier bin"
        async with s.ws_connect(url + "/events") as ws:
            msg = await ws.receive(timeout=5)
            assert msg.type == aiohttp.WSMsgType.TEXT
            events = json.loads(msg.data)
    return {"tone": {"f_peak_hz": round(f_peak, 1), "n_samples": len(x)},
            "waterfall": wf, "events": {"keys": sorted(events)[:4]}}
