"""Websocket + HTTP serving edge, wire-compatible with the reference
frontend.

Endpoints (reference: src/websocket.cpp:14-31): ``/audio`` (demodulated
audio stream), ``/waterfall`` (int8 waterfall rows), ``/events`` (user
counts + tuning changes), anything else = static file server over
html_root (src/http.cpp).

Protocol:
- on connect, a JSON ``basic_info`` handshake (src/websocket.cpp:42-66),
- inbound JSON commands ``{"cmd":"window","l":..,"m":..,"r":..}``,
  ``{"cmd":"demodulation","demodulation":"USB"}``, ``{"cmd":"userid"}``,
  ``{"cmd":"mute"}`` (src/client.cpp:19-118), truncated at 1024 bytes
  (src/websocket.cpp:125),
- outbound audio: CBOR {data, frame_num, l, m, pwr, r} with FLAC/Opus
  payload (src/audio.cpp:17-36),
- outbound waterfall: zstd-compressed CBOR {data, frame_num, l, r}
  with coordinates scaled by the pyramid level (src/waterfall.cpp:44-51),
- slow clients are dropped (not disconnected, just skipped) when their
  socket backlog exceeds 50 kB (src/websocket.cpp:174,222),
- /events: initial full state on connect, then 1 Hz deltas
  (src/events.cpp).
"""

from __future__ import annotations

import asyncio
import json
import math
import queue
import secrets
import threading
import time
import traceback
from pathlib import Path

import numpy as np
from aiohttp import web, WSMsgType
from collections import deque

from ..config import ServerConfig
from ..ops.cuda import all_kernels
from ..ops.quantize import pyramid_level_offsets
from . import cbor
from .codecs import (DeflateStream, FlacEncoder, OpusChunkEncoder,
                     ZstdStream)
from .registry import AudioSlot, ChannelRegistry, WaterfallRegistry, WaterfallSlot

BACKPRESSURE_LIMIT = 50_000  # bytes (src/websocket.cpp:174,222)
MAX_CMD_LEN = 1024           # (src/websocket.cpp:125)


def _generate_unique_id() -> str:
    return secrets.token_hex(16)


class _SendQueue:
    """Single-writer outbound queue per websocket: dispatch enqueues,
    one sender task drains -- concurrent ws.send_* calls can interleave
    frame fragments, and ordering must be preserved per client.

    Tracks outstanding (queued + in-flight) bytes: that is the slow-client
    backpressure signal (src/websocket.cpp:174,222's 50 kB socket-backlog
    gate).  When the peer stops reading, aiohttp's writer blocks the
    sender task on TCP drain, the queue backs up, and `backlogged`
    trips -- no aiohttp-private transport introspection needed.

    The queue itself is UNBOUNDED on purpose: dispatch stops producing
    for a backlogged connection BEFORE encoding (like the reference's
    pre-encode gate), but a packet that has already been produced must
    never be dropped here -- the per-client FLAC/zstd/AV1 encoders are
    stateful streams, and a post-encode drop would permanently corrupt
    everything the client decodes afterwards.  Memory stays bounded by
    the byte gate: once outstanding_bytes > 50 kB no new encode jobs
    are submitted for this connection, so the queue holds at most the
    gate plus the packets already in flight from the current step."""

    def __init__(self, ws: web.WebSocketResponse):
        self.ws = ws
        self.q: asyncio.Queue = asyncio.Queue()
        self.outstanding_bytes = 0
        self.task = asyncio.create_task(self._run())

    async def _run(self):
        try:
            while True:
                data = await self.q.get()
                if data is None:
                    break
                try:
                    if isinstance(data, str):
                        await self.ws.send_str(data)
                    else:
                        await self.ws.send_bytes(data)
                finally:
                    self.outstanding_bytes -= len(data)
        except (ConnectionError, asyncio.CancelledError, RuntimeError):
            pass

    def send_nowait(self, data) -> bool:
        self.q.put_nowait(data)  # unbounded; see class docstring
        self.outstanding_bytes += len(data)
        return True

    @property
    def backlogged(self) -> bool:
        return self.outstanding_bytes > BACKPRESSURE_LIMIT

    def close(self):
        self.task.cancel()


class EncodePool:
    """Connection-affine encode workers.

    The reference posts each client's demod+encode job to its asio
    thread pool (src/websocket.cpp:180-182,227-229); here demod already
    happened on device, but the FLAC/Opus/zstd/AV1 encoders are stateful
    native calls that do NOT belong on the asyncio event loop (at 500
    clients that is thousands of ctypes calls per step).  Each
    connection hashes to ONE worker thread, which keeps its stateful
    encoder single-threaded and its packet order intact with zero locks;
    ctypes releases the GIL during the native encode, so workers run in
    parallel.  Finished packets hop back to the event loop in one
    call_soon_threadsafe per job.

    A data job that has waited more than MAX_LAG_S when its worker
    reaches it is dropped (the slow-encoder analogue of the 50 kB socket
    gate): a bound in time, not in jobs, so that it means the same at
    every step rate.  (The JAX package bounds each queue at 256 jobs:
    about 1.3 s of a bench-config server's 104 listeners and 28
    waterfalls at 1.85 steps a second, but under two steps, 0.17 s, at
    the RX888 config's 11 steps a second, where one event-loop stall of
    a tenth of a second dropped audio while the worker idled most of
    the time.)"""

    MAX_LAG_S = 1.0

    def __init__(self, workers: int):
        self.n = max(1, workers)
        self.queues: list[queue.Queue] = [
            queue.Queue() for _ in range(self.n)]
        self._dropped = [0] * self.n
        self._threads = [
            threading.Thread(target=self._run, args=(i,), daemon=True,
                             name=f"encode-{i}")
            for i in range(self.n)
        ]
        for t in self._threads:
            t.start()

    def _run(self, i: int):
        q = self.queues[i]
        while True:
            item = q.get()
            if item is None:
                return
            t_submit, fn, droppable = item
            if droppable and time.monotonic() - t_submit > self.MAX_LAG_S:
                self._dropped[i] += 1
                continue
            try:
                fn()
            except Exception:
                traceback.print_exc()

    def submit(self, key: int, fn) -> None:
        """Enqueue data job fn on the worker owning `key`; the worker
        drops it if it has waited more than MAX_LAG_S by then."""
        self.queues[key % self.n].put_nowait((time.monotonic(), fn, True))

    def submit_control(self, key: int, fn) -> None:
        """Enqueue a rare control op (e.g. a compression swap) that must
        NOT be shed however long it waits: data jobs are droppable, but a
        dropped swap loses its protocol ack and the client waits on it
        forever."""
        self.queues[key % self.n].put_nowait((time.monotonic(), fn, False))

    @property
    def dropped(self) -> int:
        return sum(self._dropped)

    @property
    def depth(self) -> int:
        return sum(q.qsize() for q in self.queues)

    def stop(self):
        for q in self.queues:
            q.put(None)


class AudioConn:
    def __init__(self, server: "SpectrumServer", ws: web.WebSocketResponse,
                 slot: AudioSlot):
        self.server = server
        self.ws = ws
        self.slot = slot
        cfg = server.cfg
        # codec construction can raise (missing native lib); the sender
        # task is spawned only after it succeeds so a failed ctor can't
        # leak a pending _SendQueue task
        if cfg.audio_compression == "opus":
            # with device decimation the stream already arrives at the
            # legal Opus rate; otherwise the encoder host-decimates
            rate = cfg.opus_rate if cfg.device_decim else cfg.audio_sps
            self.encoder = OpusChunkEncoder(rate,
                                            channels=cfg.audio_channels)
            self.is_opus = True
        else:
            self.encoder = FlacEncoder(cfg.audio_sps,
                                       channels=cfg.audio_channels)
            self.is_opus = False
        # per-listener RDS protocol decoder ({"cmd":"rds"}); only read
        # by this conn's affine encode worker, so no locking
        self.rds_decoder = None
        self.out = _SendQueue(ws)

    def handle_command(self, msg: str):
        try:
            cmd = json.loads(msg[:MAX_CMD_LEN])
        except (json.JSONDecodeError, UnicodeDecodeError):
            return
        if not isinstance(cmd, dict):
            return  # valid JSON scalar/array ("null", "[1]") must not
            #          AttributeError the ws handler out of its loop
        name = cmd.get("cmd")
        if name == "window":
            m = cmd.get("m")
            if m is None:
                return
            try:
                # json.loads accepts NaN/Infinity literals; int(inf)
                # raises OverflowError -- a client must not be able to
                # kill its handler or half-update the registry
                l, r = int(cmd["l"]), int(cmd["r"])
                m = float(m)
            except (KeyError, TypeError, ValueError, OverflowError):
                return
            if not math.isfinite(m):
                return
            reg = self.server.channels
            if not reg.retune(self.slot, l, m, r):
                return  # rejected: no reset, no broadcast (nothing moved)
            self._reset_rds_decoder()  # new station: no stale PS/RT
            self.server.broadcast_signal_change(
                self.slot.unique_id, self.slot.l, self.slot.mid, self.slot.r
            )
        elif name == "demodulation":
            mode = cmd.get("demodulation")
            if isinstance(mode, str):
                # also queues a one-shot device-side AGC reset, exactly
                # like the reference's agc.reset() (src/signal.cpp:327)
                self.server.channels.set_mode(self.slot, mode)
                self._reset_rds_decoder()
        elif name == "userid":
            uid = cmd.get("userid")
            if isinstance(uid, str):
                self.slot.user_id = uid[:32]
        elif name == "mute":
            self.slot.mute = bool(cmd.get("mute", False))
        elif name == "nr":
            # extension: server-side spectral noise reduction opt-in
            # (ops/nr.py); a no-op unless the server runs [input] nr=true
            # (the device NR chain is compiled in).  The reference's
            # protocol has no such command -- its NR is browser-local.
            if self.server.cfg.nr:
                self.server.channels.set_nr(
                    self.slot, bool(cmd.get("enabled", False)))
        elif name == "rds":
            # extension: server-side FM-RDS decoding opt-in (ops/rds.py
            # + runtime/rds.py); a no-op unless the server runs
            # [input] rds=true.  The reference decodes RDS browser-side
            # (jsdsp/redsea.js).  Re-enabling makes a fresh decoder, so
            # a retune to another station starts from clean sync.
            if self.server.cfg.rds:
                enabled = bool(cmd.get("enabled", False))
                # build the decoder BEFORE the registry flips the column:
                # dispatch() runs on this same event loop, so the device
                # baseband can never arrive at a conn without a decoder
                self.rds_decoder = (self._make_rds_decoder() if enabled
                                    else None)
                self.server.channels.set_rds(self.slot, enabled)
        elif name == "am_sync":
            # extension: per-client AM detector choice.  The server
            # defaults every listener to the reference's PLL carrier-
            # synchronous detection (src/signal.cpp:242-252, its normal
            # liquid build); {"cmd":"am_sync","enabled":false} opts
            # this listener out to plain envelope detection (the
            # reference's non-liquid fallback, :253-257).  A no-op when
            # the server runs [input] am_sync=false (envelope-only
            # build parity; the PLL path is then not compiled in).
            if self.server.cfg.am_sync:
                self.server.channels.set_am_sync(
                    self.slot, bool(cmd.get("enabled", True)))

    def _make_rds_decoder(self):
        """Fresh protocol decoder at the device baseband rate -- the
        ONE place the rate derivation lives (enable and reset must
        agree)."""
        from ..ops.rds import rds_decim_for
        from .rds import RDSDecoder

        cfg = self.server.cfg
        d = rds_decim_for(cfg.audio_sps, cfg.audio_fft_size // 2)
        return RDSDecoder(cfg.audio_sps / d)

    def _reset_rds_decoder(self):
        """Fresh protocol decoder on retune/demodulation change: the
        persistent group state (PI/PS/RadioText) belongs to the OLD
        station and must not be reported as the new one's."""
        if self.rds_decoder is not None:
            self.rds_decoder = self._make_rds_decoder()


class WaterfallConn:
    def __init__(self, server: "SpectrumServer", ws: web.WebSocketResponse,
                 cid: int, slot: WaterfallSlot):
        self.server = server
        self.ws = ws
        self.cid = cid
        self.slot = slot
        self.user_id = ""
        # codec ctor first (can raise), sender task after -- see AudioConn
        if server.cfg.waterfall_compression == "av1":
            from .av1 import AV1Encoder

            self.av1 = AV1Encoder(server.cfg.waterfall_size)
            self.encoder = None
        else:
            self.av1 = None
            self.encoder = ZstdStream()
        self.out = _SendQueue(ws)

    def handle_command(self, msg: str):
        try:
            cmd = json.loads(msg[:MAX_CMD_LEN])
        except (json.JSONDecodeError, UnicodeDecodeError):
            return
        if not isinstance(cmd, dict):
            return  # see AudioConn.handle_command
        name = cmd.get("cmd")
        if name == "window":
            try:
                l, r = int(cmd["l"]), int(cmd["r"])
            except (KeyError, TypeError, ValueError, OverflowError):
                return
            self.server.waterfalls.retune(self.cid, self.slot, l, r)
        elif name == "userid":
            uid = cmd.get("userid")
            if isinstance(uid, str):
                self.user_id = uid[:32]
        elif name == "compression":
            # extension: {"cmd":"compression","waterfall":"deflate"}
            # switches THIS conn's waterfall stream from zstd to raw
            # deflate (browser-decodable, runtime/codecs.DeflateStream).
            # The swap runs on the conn's affine encode worker so it
            # can't race a row job, and the {"type":"compression"} ack
            # is posted from the same worker -- everything after the
            # ack is one fresh deflate stream (rows before it were
            # zstd; the client drops binary frames until the ack).
            if cmd.get("waterfall") == "deflate" and self.av1 is None:
                srv = self.server

                def swap(c=self):
                    c.encoder = DeflateStream()
                    srv._post_threadsafe(c, [json.dumps(
                        {"type": "compression", "waterfall": "deflate"})])
                srv.encode_pool.submit_control(
                    srv.channels.cfg.max_channels + self.cid, swap)


class SpectrumServer:
    def __init__(self, cfg: ServerConfig, channels: ChannelRegistry = None,
                 waterfalls: WaterfallRegistry = None, chan_offset: int = 0):
        """channels/waterfalls: inject range-partitioned registries for
        the multi-host serving partition; chan_offset maps global slot
        ids onto this host's local audio/power arrays in dispatch()."""
        self.cfg = cfg
        if cfg.waterfall_compression == "av1":
            # fall back to zstd BEFORE serving if libaom is unusable, so
            # basic_info advertises the format clients will actually get
            # (av1.py validates the ABI layout at load)
            from .av1 import av1_available, _Aom

            if not av1_available():
                print(f"av1 unavailable ({_Aom.failure()}); falling back "
                      f"to zstd waterfall compression", flush=True)
                cfg.waterfall_compression = "zstd"
        self.chan_offset = chan_offset
        self.channels = channels or ChannelRegistry(cfg)
        self.waterfalls = waterfalls or WaterfallRegistry(
            cfg, pyramid_level_offsets(cfg.fft_result_size,
                                       cfg.downsample_levels))
        self.audio_conns: dict[int, AudioConn] = {}       # slot -> conn
        self.wf_conns: dict[int, WaterfallConn] = {}      # cid -> conn
        # /events sockets each get their own _SendQueue: two concurrent
        # send_str coroutines on one WebSocketResponse can interleave
        # frames, so broadcasts are enqueued, never fire-and-forget
        self.event_conns: dict[web.WebSocketResponse, _SendQueue] = {}
        self.signal_changes: dict[str, tuple[int, float, int]] = {}
        self.level_offsets = pyramid_level_offsets(
            cfg.fft_result_size, cfg.downsample_levels
        )
        self.loop: asyncio.AbstractEventLoop | None = None
        self.driver = None  # set by main
        # [server] threads maps to encode workers (the reference's asio
        # pool size, src/spectrumserver.cpp:21,253-261)
        self.encode_pool = EncodePool(cfg.threads)
        # event-loop time spent in dispatch() per step (the part that
        # blocks serving; encoding happens on the pool)
        self._dispatch_seconds: "deque[float]" = deque(maxlen=240)
        # multi-host /events sync state (apply_cluster_state)
        self._cluster_counts = None
        self._cluster_prev = None
        self._cluster_uids: dict = {}
        self._gzip_cache: dict = {}
        self._GZIP_MAX_BYTES = 1 << 20
        self.app = self._build_app()

    # ------------------------------------------------------------- app
    def _build_app(self) -> web.Application:
        app = web.Application()
        app.router.add_get("/audio", self._ws_audio)
        app.router.add_get("/waterfall", self._ws_waterfall)
        app.router.add_get("/events", self._ws_events)
        app.router.add_get("/metrics", self._http_metrics)
        app.router.add_get("/{tail:.*}", self._http_static)
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)
        return app

    async def _on_cleanup(self, app):
        self.encode_pool.stop()

    async def _on_startup(self, app):
        self.loop = asyncio.get_running_loop()
        asyncio.create_task(self._event_timer())

    # ------------------------------------------------- basic_info JSON
    def basic_info(self) -> str:
        cfg = self.cfg
        return json.dumps({
            "sps": cfg.sps,
            "audio_max_sps": cfg.audio_sps,
            "audio_max_fft": cfg.audio_max_fft_size,
            "fft_size": cfg.fft_size,
            "fft_result_size": cfg.fft_result_size,
            "waterfall_size": cfg.waterfall_size,
            "basefreq": cfg.basefreq,
            "total_bandwidth": cfg.total_bandwidth,
            "defaults": {
                "frequency": cfg.default_frequency,
                "modulation": cfg.default_mode_str,
                "l": cfg.default_l,
                "m": cfg.default_m,
                "r": cfg.default_r,
            },
            "waterfall_compression": cfg.waterfall_compression,
            "audio_compression": cfg.audio_compression,
            # extension (absent in websocket.cpp:47-64): 2 when the
            # server decodes WBFM stereo on device ([input] stereo);
            # the audio payload is then interleaved L/R
            "audio_channels": cfg.audio_channels,
            # extension: server-side spectral NR available; clients may
            # send {"cmd":"nr","enabled":true}
            "nr_available": cfg.nr,
            # extension: server-side FM-RDS decoding available; clients
            # may send {"cmd":"rds","enabled":true} and receive
            # {"type":"rds", pi/ps/rt/pty/...} JSON text frames
            "rds_available": cfg.rds,
            # extension: true = AM uses PLL carrier-synchronous
            # detection by default (the reference's liquid build,
            # signal.cpp:242-252); listeners may opt out per client
            # with {"cmd":"am_sync","enabled":false} (envelope).
            # false = envelope-only (non-liquid build parity).
            "am_sync": cfg.am_sync,
            # extension: FM de-emphasis already applied server-side
            # (microseconds; 0 = raw discriminator audio like the
            # reference).  Frontends with their own de-emphasis filter
            # must skip it when this is nonzero or audio gets the pole
            # twice.
            "deemphasis": cfg.deemphasis,
            # extension: waterfall conns may switch their stream to raw
            # deflate ({"cmd":"compression","waterfall":"deflate"}) --
            # what the built-in html/ frontend uses (browsers decode
            # deflate-raw natively, zstd they don't)
            "waterfall_deflate_available":
                cfg.waterfall_compression == "zstd",
        })

    # -------------------------------------------------------- handlers
    async def _ws_audio(self, request: web.Request):
        ws = web.WebSocketResponse(max_msg_size=1 << 20)
        await ws.prepare(request)
        await ws.send_str(self.basic_info())
        # [limits] audio: the reference parses but never enforces these
        # (src/spectrumserver.cpp:92-94); we honor them explicitly.
        slot = None
        if self.channels.count < self.cfg.limit_audio:
            slot = self.channels.acquire(_generate_unique_id())
        if slot is None:
            await ws.close()
            return ws
        try:
            conn = AudioConn(self, ws, slot)
        except Exception:
            # codec construction failed: release the slot or it leaks
            self.channels.release(slot)
            await ws.close()
            raise
        self.channels.set_mode(slot, self.cfg.default_mode)
        # defaults bypass command validation (websocket.cpp:145)
        self.channels.set_default_range(slot)
        self.broadcast_signal_change(slot.unique_id, slot.l, slot.mid, slot.r)
        self.audio_conns[slot.slot] = conn
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    conn.handle_command(msg.data)
                elif msg.type in (WSMsgType.ERROR, WSMsgType.CLOSE):
                    break
        finally:
            conn.out.close()
            self.audio_conns.pop(slot.slot, None)
            self.channels.release(slot)
            self.broadcast_signal_change(slot.unique_id, -1, -1.0, -1)
        return ws

    async def _ws_waterfall(self, request: web.Request):
        ws = web.WebSocketResponse(max_msg_size=1 << 20)
        await ws.prepare(request)
        await ws.send_str(self.basic_info())
        cid, slot = (None, None)
        if self.waterfalls.count < self.cfg.limit_waterfall:
            cid, slot = self.waterfalls.acquire()
        if cid is None:
            await ws.close()
            return ws
        try:
            conn = WaterfallConn(self, ws, cid, slot)
        except Exception:
            self.waterfalls.release(cid)
            await ws.close()
            raise
        self.wf_conns[cid] = conn
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    conn.handle_command(msg.data)
                elif msg.type in (WSMsgType.ERROR, WSMsgType.CLOSE):
                    break
        finally:
            conn.out.close()
            self.wf_conns.pop(cid, None)
            self.waterfalls.release(cid)
        return ws

    async def _ws_events(self, request: web.Request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        if len(self.event_conns) >= self.cfg.limit_events:
            await ws.close()
            return ws
        await ws.send_str(self.initial_state_info())
        q = _SendQueue(ws)
        self.event_conns[ws] = q
        try:
            async for _ in ws:
                pass  # ignore messages (src/events.cpp:78-80)
        finally:
            q.close()
            self.event_conns.pop(ws, None)
        return ws

    async def _http_metrics(self, request: web.Request):
        m = self.driver.metrics.snapshot(self.cfg) if self.driver else {}
        m["audio_clients"] = self.channels.count
        m["waterfall_clients"] = self.waterfalls.count
        m["encode_queue_depth"] = self.encode_pool.depth
        m["encode_dropped"] = self.encode_pool.dropped
        ds = sorted(self._dispatch_seconds)
        if ds:
            m["dispatch_ms_p50"] = ds[len(ds) // 2] * 1e3
            m["dispatch_ms_p99"] = ds[min(len(ds) - 1,
                                          int(len(ds) * 0.99))] * 1e3
        # each hand-written kernel's launches in this process so far (a
        # port-only field: which kernels a served run went through)
        m["kernel_launches"] = {k.name: k.launches for k in all_kernels()}
        return web.json_response(m)

    def _http_404(self, request: web.Request) -> web.Response:
        """Custom 404 page (src/http.cpp:61-76 serves the same shape of
        body).  Deviation: the requested path is HTML-escaped -- the
        reference reflects the raw resource string into the page, a
        reflected-XSS foothold."""
        import html as _html

        path_txt = _html.escape(request.path, quote=True)
        body = ("<!doctype html><html><head>"
                "<title>Error 404 (Resource not found)</title></head>"
                "<body><h1>Error 404</h1>"
                f"<p>The requested URL {path_txt} was not found on "
                "this server.</p></body></html>")
        return web.Response(status=404, text=body,
                            content_type="text/html")

    async def _http_static(self, request: web.Request):
        root = Path(self.cfg.html_root).resolve()
        tail = request.match_info.get("tail", "") or "index.html"
        path = (root / tail).resolve()
        # directory-traversal guard (src/http.cpp:33-39); a bare prefix
        # check would let "html_private" escape past root "html"
        if path != root and not path.is_relative_to(root):
            return self._http_404(request)
        if path.is_dir():
            path = path / "index.html"
        if not path.is_file():
            return self._http_404(request)
        # gzip bodies when the client accepts it (src/http.cpp:86-94);
        # compressed off the event loop, cached by (path, mtime), and
        # only for small assets -- big files stream uncompressed rather
        # than stall audio dispatch for a synchronous compress
        st = path.stat()
        if ("gzip" in request.headers.get("Accept-Encoding", "")
                and st.st_size <= self._GZIP_MAX_BYTES):
            key = (str(path), st.st_mtime_ns)
            body = self._gzip_cache.get(key)
            if body is None:
                import gzip as _gzip

                loop = asyncio.get_running_loop()
                data = await loop.run_in_executor(None, path.read_bytes)
                body = await loop.run_in_executor(None, _gzip.compress,
                                                  data)
                if len(self._gzip_cache) > 64:
                    self._gzip_cache.clear()
                self._gzip_cache[key] = body
            import mimetypes

            ctype = mimetypes.guess_type(str(path))[0] or "text/plain"
            return web.Response(
                body=body, content_type=ctype,
                headers={"Content-Encoding": "gzip",
                         "Cache-Control": "max-age=30"},
            )
        resp = web.FileResponse(path)
        resp.headers["Cache-Control"] = "max-age=30"  # src/http.cpp:95
        return resp

    # ---------------------------------------------------------- events
    def broadcast_signal_change(self, uid: str, l: int, mid: float, r: int):
        if not self.cfg.otherusers:
            return
        self.signal_changes[uid] = (l, mid, r)

    # ---- multi-host /events sync (parallel/multihost.py): the cluster
    # driver feeds every host the replicated slot state + uid map so
    # each host's /events shows ALL users, not just its partition
    def apply_cluster_state(self, l, r, mid, active, uids: dict,
                            wf_clients: int):
        """Called on the event loop per cluster step: diff the replicated
        table against the previous one and emit remote users' tuning
        changes; remember counts + uids for /events state."""
        self._cluster_counts = (int(active.sum()), wf_clients)
        prev = self._cluster_prev
        old_uids = self._cluster_uids
        self._cluster_prev = (l, r, mid, active)
        self._cluster_uids = uids
        if not self.cfg.otherusers:
            return
        local = self.channels.slots  # local slots emit their own changes
        c = len(active)
        for s in range(c):
            if s in local:
                continue
            if active[s]:
                uid = uids.get(str(s))
                if uid is None:
                    continue
                changed = (prev is None or not prev[3][s]
                           or prev[0][s] != l[s] or prev[1][s] != r[s]
                           or prev[2][s] != mid[s])
                if changed:
                    self.signal_changes[uid] = (int(l[s]), float(mid[s]),
                                                int(r[s]))
            elif prev is not None and prev[3][s]:
                # disconnected remote user: the uid left the CURRENT map
                # with the same update, so attribute via the old map
                uid = old_uids.get(str(s)) or uids.get(str(s))
                if uid is not None:
                    self.signal_changes[uid] = (-1, -1.0, -1)

    def _event_counts(self) -> dict:
        if getattr(self, "_cluster_counts", None) is not None:
            a, w = self._cluster_counts
            return {"waterfall_clients": w, "signal_clients": a}
        return {
            "waterfall_clients": self.waterfalls.count,
            "signal_clients": self.channels.count,
        }

    def initial_state_info(self) -> str:
        info = self._event_counts()
        changes = {}
        if self.cfg.otherusers:
            for slot in self.channels.slots.values():
                changes[slot.unique_id] = [slot.l, slot.mid, slot.r]
            prev = getattr(self, "_cluster_prev", None)
            if prev is not None:
                l, r, mid, active = prev
                uids = self._cluster_uids
                for s in range(len(active)):
                    uid = uids.get(str(s))
                    if (uid is not None and active[s]
                            and s not in self.channels.slots):
                        changes[uid] = [int(l[s]), float(mid[s]),
                                        int(r[s])]
        info["signal_changes"] = changes
        return json.dumps(info)

    async def _event_timer(self):
        # unconditional 1 Hz broadcast like the reference
        # (src/events.cpp:86-112): counts must reach /events subscribers
        # even when no tuning changed (e.g. waterfall-only churn)
        while True:
            await asyncio.sleep(1.0)
            if not self.event_conns:
                # still clear the change map (the reference clears it
                # every tick, src/events.cpp): with zero subscribers,
                # per-connection uid entries would otherwise pile up
                # under client churn forever, and the first subscriber
                # would get a burst of stale changes for long-gone uids
                self.signal_changes = {}
                continue
            info = self._event_counts()
            info["signal_changes"] = {
                k: list(v) for k, v in self.signal_changes.items()
            }
            self.signal_changes = {}
            msg = json.dumps(info)
            for q in list(self.event_conns.values()):
                # same 50 kB slow-client gate every other endpoint gets
                # (src/websocket.cpp:174,222): a stalled /events reader
                # must not grow its queue by one JSON blob per tick
                if not q.backlogged:
                    q.send_nowait(msg)

    # -------------------------------------------------------- dispatch
    def dispatch(self, frame0: int, audio: np.ndarray, pwr: np.ndarray,
                 wf: np.ndarray | None, due_positions: list[int],
                 wf_meta=None, audio_meta=None, rds: np.ndarray | None = None):
        """Called (via call_soon_threadsafe) with one device batch:
        audio [B, C, A/2] int16, pwr [B, C], wf [D, W, view_cap] int8
        client waterfall views for the batch's due hop positions,
        rds [C, 2, T] int8 RDS baseband (None unless [input] rds).
        wf_meta: (l, r, level) per-cid arrays; audio_meta: (l, r, mid)
        per-slot arrays -- both snapshotted when the step was SUBMITTED:
        packets must be labeled with the coordinates the data was
        gathered/demodulated at, not the registry's current (possibly
        retuned-in-flight) values."""
        t_start = time.perf_counter()
        cfg = self.cfg
        b = pwr.shape[0]
        decimated = audio.ndim == 2
        # ---- audio: one encode job per connection per step, on the
        # conn's affine worker (order-preserving) ----
        for slot_id, conn in list(self.audio_conns.items()):
            s = conn.slot
            if not self.channels.active[slot_id]:
                continue
            if conn.out.backlogged:
                continue
            li = slot_id - self.chan_offset  # local row (multi-host)
            if li >= (audio.shape[0] if decimated else audio.shape[1]):
                # slot acquired after this step was submitted at a
                # smaller channel bucket; its audio starts next step
                continue
            if audio_meta is not None:
                mid = float(audio_meta[2][slot_id])
                width = int(audio_meta[1][slot_id]
                            - audio_meta[0][slot_id])
            else:  # direct-dispatch callers (tests), no race
                mid, width = s.mid, s.r - s.l
            if not s.mute:
                # {"cmd":"mute"} actually mutes here: the encode job is
                # skipped like a backlogged conn's (frontends already
                # tolerate frame gaps), freeing encode-pool CPU at
                # scale.  The reference stores the flag and never reads
                # it (src/client.cpp:127) -- same deliberate-improvement
                # rule as the enforced [limits].  RDS decode below still
                # runs: muted audio shouldn't blank the station text.
                pcm = audio[li] if decimated else audio[:, li]
                self.encode_pool.submit(slot_id, lambda c=conn, p=pcm,
                                        pw=pwr[:, li], mid=mid,
                                        width=width:
                                        self._encode_audio_job(
                                            c, frame0, b, mid, width, p,
                                            pw, decimated))
            else:
                # muted: still ship ONE data-less packet per step so
                # the listener's S-meter/squelch keeps its live signal
                # power (the reference's per-frame packets always carry
                # pwr); rides the same affine worker so packets stay
                # ordered with the audio stream across mute flips, and
                # an empty FLAC/Opus payload chunk is a stream no-op.
                self.encode_pool.submit(
                    slot_id, lambda c=conn, pw=float(pwr[b - 1, li]),
                    mid=mid, width=width:
                    self._post_threadsafe(c, [cbor.audio_packet(
                        frame0 + b - 1, 0, mid, width, pw, b"")])
                    if self.loop is not None else None)
            if (rds is not None and s.rds and s.mode == "FM"
                    and li < rds.shape[0]
                    and conn.rds_decoder is not None):
                # RDS protocol decode on the SAME affine worker (keeps
                # the per-listener bitstream ordered with zero locks).
                # Gated on FM: a non-FM listener's baseband row is
                # zeroed on device, so decoding it would just burn the
                # worker on silence every step.
                self.encode_pool.submit(
                    slot_id, lambda c=conn, z=rds[li]:
                    self._decode_rds_job(c, z))
        # ---- waterfall ----
        if wf is None or wf.shape[0] == 0:
            self._dispatch_seconds.append(time.perf_counter() - t_start)
            return
        for cid, conn in list(self.wf_conns.items()):
            if conn.out.backlogged:
                continue
            if cid >= wf.shape[1]:
                # view slot acquired after this step was submitted at a
                # smaller bucket; its rows start next step
                continue
            if wf_meta is not None:
                sl, sr, slev = (int(wf_meta[0][cid]), int(wf_meta[1][cid]),
                                int(wf_meta[2][cid]))
            else:  # direct-dispatch callers (tests) with no pipelining race
                ws_slot = conn.slot
                sl, sr, slev = ws_slot.l, ws_slot.r, ws_slot.level
            # views, not copies: the O(rows x width) materialization
            # happens on the encode worker (_encode_waterfall_job), not
            # on the serving event loop; the step's host buffer is
            # freshly allocated per step and never mutated, so the view
            # stays valid for the job's lifetime
            n = min(sr - sl, wf.shape[2])
            entries = [(frame0 + h, wf[d, cid, :n])
                       for d, h in enumerate(due_positions)]
            if not entries:
                continue
            self.encode_pool.submit(
                self.channels.cfg.max_channels + cid,
                lambda c=conn, e=entries, a=sl, o=sr, v=slev:
                self._encode_waterfall_job(c, e, a, o, v))
        self._dispatch_seconds.append(time.perf_counter() - t_start)

    # ---- encode jobs (run on EncodePool workers, never on the loop) ----
    def _post_packets(self, conn, pkts: list):
        for p in pkts:
            conn.out.send_nowait(p)

    def _post_threadsafe(self, conn, pkts: list):
        """Worker->loop handoff; quiet when the loop already shut down
        (late jobs during teardown)."""
        try:
            self.loop.call_soon_threadsafe(self._post_packets, conn, pkts)
        except RuntimeError:
            pass

    def _encode_audio_job(self, conn: AudioConn, frame0: int, b: int,
                          mid: float, width: int, pcm: np.ndarray,
                          pw: np.ndarray, decimated: bool):
        pkts = []
        if decimated:
            # continuous decimated stream: packets attributed to hops by
            # stream position (metadata per src/signal.cpp:102-109,287)
            payloads = conn.encoder.process(pcm)
            k = max(len(payloads), 1)
            for j, payload in enumerate(payloads):
                h = (j * b) // k
                pkts.append(cbor.audio_packet(
                    frame0 + h, 0, mid, width, float(pw[h]), payload))
        elif conn.is_opus:
            for h in range(b):
                for payload in conn.encoder.process(pcm[h]):
                    pkts.append(cbor.audio_packet(
                        frame0 + h, 0, mid, width, float(pw[h]), payload))
        else:
            # one native call per step: the hop loop runs in C
            # (phantom_flac_process_chunks), per-hop packets and bytes
            # bit-identical to per-hop process() calls
            for h, payload in enumerate(conn.encoder.process_chunks(pcm)):
                if payload:
                    # l is slice-relative (always 0), m is the absolute
                    # mid, r is the slice width
                    pkts.append(cbor.audio_packet(
                        frame0 + h, 0, mid, width, float(pw[h]), payload))
        if pkts and self.loop is not None:
            self._post_threadsafe(conn, pkts)

    def _decode_rds_job(self, conn: AudioConn, z: np.ndarray):
        """Feed one step's int8 baseband [2, T] to the listener's RDS
        decoder; post a {"type":"rds",...} JSON text frame when a
        displayed field (PI/PS/RadioText/PTY) changed."""
        dec = conn.rds_decoder
        if dec is None:  # disabled between submit and decode
            return
        upd = dec.feed(z)
        if upd is not None and self.loop is not None:
            upd["type"] = "rds"
            self._post_threadsafe(conn, [json.dumps(upd)])

    def _encode_waterfall_job(self, conn: WaterfallConn, entries: list,
                              sl: int, sr: int, slev: int):
        pkts = []
        for fnum, row in entries:
            if isinstance(row, np.ndarray):
                row = row.tobytes()  # dispatch passes views; copy here
            if conn.av1 is not None:
                # AV1: frame bytes go out raw, headers ride the T.35
                # metadata OBU (src/waterfallcompression.cpp:84-125)
                frame_bytes = conn.av1.send(row, fnum, sl << slev,
                                            sr << slev)
                if frame_bytes:
                    pkts.append(frame_bytes)
            else:
                pkts.append(conn.encoder.compress(cbor.waterfall_packet(
                    fnum, sl << slev, sr << slev, row)))
        if pkts and self.loop is not None:
            self._post_threadsafe(conn, pkts)

    def dispatch_threadsafe(self, frame0, audio, pwr, wf, due_positions,
                            wf_meta=None, audio_meta=None, rds=None):
        if self.loop is None:
            return
        self.loop.call_soon_threadsafe(
            self.dispatch, frame0, audio, pwr, wf, due_positions, wf_meta,
            audio_meta, rds,
        )

    # ---------------------------------------------------------- state
    def audio_active(self) -> bool:
        return self.channels.count > 0

    def waterfall_active(self) -> bool:
        return self.waterfalls.count > 0
