"""Serving-edge codecs: FLAC (native C++), Opus (system libopus via
ctypes), zstd waterfall compression (system libzstd via ctypes).

Mirrors the reference codec layer:
- FLAC: 16-bit, streamed; reference uses libFLAC level 5
  (src/signal.cpp:17-28).  Here: csrc/flac.cpp, a from-scratch encoder
  at level-5 parity (LPC orders 1-8 + fixed predictors, exact Rice
  partition search, adaptive stereo decorrelation; this image has no
  libFLAC).
- Opus: <=48 kHz mono, 20 ms frames, 80 kbps, partial-frame queue
  (src/audio.cpp:55-84).
- zstd: per-client streaming compression of CBOR waterfall rows,
  flushed per message (src/waterfallcompression.cpp:18-37).

Each audio packet is CBOR {data, frame_num, l, m, pwr, r}
(src/audio.cpp:17-36) -- built by the caller via runtime.cbor.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_CSRC = Path(__file__).resolve().parent.parent.parent / "csrc"

# ---------------------------------------------------------------- native lib

_hostlib = None


def _load_hostlib():
    global _hostlib
    if _hostlib is not None:
        return _hostlib
    so = _CSRC / "libphantomhost.so"
    if not so.exists():
        # try to build it (native toolchain is available in the image);
        # main.build() calls this at startup so the compile never runs
        # on the serving path
        import subprocess

        subprocess.run(["make", "-C", str(_CSRC)],
                       capture_output=True, check=False)
    if not so.exists():
        raise RuntimeError("libphantomhost.so not built (run make -C csrc)")
    lib = ctypes.CDLL(str(so))
    lib.phantom_flac_create.restype = ctypes.c_void_p
    lib.phantom_flac_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]
    lib.phantom_flac_process.restype = ctypes.c_int
    lib.phantom_flac_process.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.phantom_flac_finish.restype = ctypes.c_int
    lib.phantom_flac_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.phantom_flac_process_chunks.restype = ctypes.c_int
    lib.phantom_flac_process_chunks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.phantom_flac_take.restype = ctypes.c_int
    lib.phantom_flac_take.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.phantom_flac_set_lpc.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.phantom_flac_set_lpc.restype = None
    lib.phantom_flac_destroy.argtypes = [ctypes.c_void_p]
    _hostlib = lib
    return lib


class FlacEncoder:
    """Streaming FLAC encoder (native).  blocksize 4096 like libFLAC's
    default at the reference's level-5 settings.  channels=2 encodes
    interleaved L/R with per-frame adaptive decorrelation (independent/
    left-side/right-side/mid-side) for the device WBFM stereo path."""

    def __init__(self, sample_rate: int, blocksize: int = 4096,
                 channels: int = 1):
        self._lib = _load_hostlib()
        self.channels = channels
        self._enc = self._lib.phantom_flac_create(sample_rate, blocksize,
                                                  channels)
        if not self._enc:
            raise RuntimeError(
                f"phantom_flac_create({sample_rate}, {blocksize}, "
                f"{channels}) failed")
        # modest initial pickup buffer; _retake grows it on demand (a
        # 1 MB buffer per audio connection is ~2 GB at the serving
        # edge's client scale, for typically a few hundred bytes/step)
        self._cap = 1 << 16
        self._out = ctypes.create_string_buffer(self._cap)

    def set_lpc(self, enabled: bool):
        """Fixed-predictors-only when False (tools/flac_bench.py A/B)."""
        self._lib.phantom_flac_set_lpc(self._enc, 1 if enabled else 0)

    def _retake(self, n: int) -> int:
        """n < 0 = -(bytes needed): the C side consumed the input and
        stashed the encoded bytes; grow the buffer and pick them up (a
        pathological signal can exceed any fixed bound -- there is no
        verbatim-subframe fallback, the Rice escape is not used)."""
        self._cap = max(-n, 2 * self._cap)
        self._out = ctypes.create_string_buffer(self._cap)
        m = self._lib.phantom_flac_take(self._enc, self._out, self._cap)
        if m < 0:
            raise RuntimeError("flac take failed after grow")
        return m

    def process(self, samples: np.ndarray) -> bytes:
        """samples: int16 numpy array -> encoded bytes (may be empty)."""
        samples = np.ascontiguousarray(samples, dtype=np.int16)
        if samples.size % self.channels:
            # a half pair would permanently swap L/R interleave for the
            # REST of the stream with no error anywhere downstream
            raise ValueError(
                f"sample count {samples.size} not a multiple of "
                f"{self.channels} channels")
        n = self._lib.phantom_flac_process(
            self._enc, samples.ctypes.data, samples.size, self._out, self._cap
        )
        if n < 0:
            n = self._retake(n)
        # string_at, NOT ._out.raw[:n] -- .raw copies the whole 1 MB
        # buffer per call (~50 us), which dominated the encode cost
        return ctypes.string_at(self._out, n)

    def process_chunks(self, chunks: np.ndarray) -> list[bytes]:
        """chunks: int16 [nchunks, chunk_len] -> per-chunk encoded
        bytes (entries may be empty).  Bit-identical to nchunks
        process() calls but ONE native call: the serving edge encodes a
        listener's whole hop batch per call instead of per hop (5-6x
        less Python/ctypes overhead per client per step)."""
        chunks = np.ascontiguousarray(chunks, dtype=np.int16)
        nch, clen = chunks.shape
        if clen % self.channels:
            raise ValueError(
                f"chunk length {clen} not a multiple of "
                f"{self.channels} channels")
        sizes = (ctypes.c_int * nch)()
        n = self._lib.phantom_flac_process_chunks(
            self._enc, chunks.ctypes.data, nch, clen, self._out,
            self._cap, sizes)
        if n < 0:
            n = self._retake(n)
        buf = ctypes.string_at(self._out, n)
        out, off = [], 0
        for i in range(nch):
            out.append(buf[off:off + sizes[i]])
            off += sizes[i]
        return out

    def finish(self) -> bytes:
        n = self._lib.phantom_flac_finish(self._enc, self._out, self._cap)
        if n < 0:
            n = self._retake(n)
        return ctypes.string_at(self._out, n)

    def close(self):
        if self._enc:
            self._lib.phantom_flac_destroy(self._enc)
            self._enc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# --------------------------------------------------------------------- opus

_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE_REQUEST = 4002

def decimator_taps(factor: int, taps_per_phase: int = 8) -> np.ndarray:
    """Anti-alias prototype for decimation by ``factor``: a Hamming
    windowed sinc with unity DC gain, cutoff at 0.8 of the output
    Nyquist, factor*taps_per_phase taps."""
    num_taps = factor * taps_per_phase
    n = np.arange(num_taps, dtype=np.float64)
    h = np.sinc((0.8 / factor) * (n - (num_taps - 1) / 2.0))
    h *= np.hamming(num_taps)
    h /= h.sum()
    return h.astype(np.float32)


_opuslib = None


def _load_opus():
    global _opuslib
    if _opuslib is None:
        lib = ctypes.CDLL("libopus.so.0")
        lib.opus_encoder_create.restype = ctypes.c_void_p
        lib.opus_encoder_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.opus_encode.restype = ctypes.c_int
        lib.opus_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
        _opuslib = lib
    return _opuslib


class OpusChunkEncoder:
    """Opus per the reference: <=48k mono, 20 ms frames, 80 kbps, queue
    of partial frames (src/audio.cpp:55-84).  Each encoded packet is
    returned separately (one CBOR packet per opus frame).

    Deviation (improvement) from the reference: for audio rates above
    48 kHz (the WBFM profile's 192 kHz) the reference feeds the full-
    rate samples to a 48 kHz Opus encoder (src/audio.cpp:59-62: rate
    clamped, samples not resampled -- a 4x time-stretch); here the
    stream is polyphase-decimated to <=48 kHz first."""

    def __init__(self, sample_rate: int, channels: int = 1):
        from ..config import opus_decim_factor

        self._lib = _load_opus()
        self.channels = channels
        # single source of truth for the factor selection (config.py);
        # e.g. 60000 -> /5 = 12000, NOT /2 = 30000 which Opus rejects
        self._decim = opus_decim_factor(sample_rate)
        self._dec_tail = None
        if self._decim > 1:
            self._taps = decimator_taps(self._decim, taps_per_phase=12)
            self._dec_tail = np.zeros((self._taps.shape[0] - 1, channels),
                                      np.float32)
            self._dec_rem = np.zeros((0, channels), np.float32)
            sample_rate = sample_rate // self._decim
        # fall back to the reference's bare clamp (src/audio.cpp:59)
        # when no integer factor reaches a legal rate
        self.rate = min(sample_rate, 48000)
        err = ctypes.c_int(0)
        self._enc = self._lib.opus_encoder_create(
            self.rate, channels, _OPUS_APPLICATION_AUDIO, ctypes.byref(err)
        )
        if err.value != 0 or not self._enc:
            raise RuntimeError(f"opus_encoder_create failed: {err.value}")
        # varargs call: wrap every argument explicitly
        rc = self._lib.opus_encoder_ctl(
            ctypes.c_void_p(self._enc),
            ctypes.c_int(_OPUS_SET_BITRATE_REQUEST),
            ctypes.c_int(80000),
        )
        if rc != 0:
            raise RuntimeError(f"opus_encoder_ctl(SET_BITRATE): {rc}")
        self.frame_size = self.rate * 20 // 1000
        self._pending = np.zeros(0, np.int16)
        self._buf = ctypes.create_string_buffer(1024)

    def _decimate(self, samples: np.ndarray) -> np.ndarray:
        """Streaming anti-aliased decimation by self._decim (host side;
        per-hop blocks are small).  Input/output interleaved when
        channels > 1; each channel is filtered independently."""
        ch = self.channels
        x = samples.astype(np.float32).reshape(-1, ch)
        x = np.concatenate([self._dec_rem, x], axis=0)
        n_use = (x.shape[0] // self._decim) * self._decim
        self._dec_rem = x[n_use:]
        x = x[:n_use]
        if n_use == 0:
            # np.convolve(mode="valid") SWAPS arguments when the input
            # is shorter than the kernel -- with only the (taps-1)-long
            # history it would fabricate samples out of thin air
            return np.zeros(0, np.int16)
        y_in = np.concatenate([self._dec_tail, x], axis=0)
        self._dec_tail = y_in[-(self._taps.shape[0] - 1):]
        y = np.stack(
            [np.convolve(y_in[:, c], self._taps,
                         mode="valid")[::self._decim] for c in range(ch)],
            axis=1).reshape(-1)
        return np.clip(np.round(y), -32768, 32767).astype(np.int16)

    def process(self, samples: np.ndarray) -> list[bytes]:
        samples = np.ascontiguousarray(samples, np.int16)
        if self._decim > 1:
            samples = self._decimate(samples)
        self._pending = np.concatenate([self._pending, samples])
        out = []
        ch = self.channels
        fs = self.frame_size          # samples PER CHANNEL per frame
        need = fs * ch
        while self._pending.size > need:  # note: '>' matches audio.cpp:70
            frame = np.ascontiguousarray(self._pending[:need])
            n = self._lib.opus_encode(
                self._enc, frame.ctypes.data, fs, self._buf, 1024
            )
            if n < 0:
                # surface libopus errors (OPUS_BAD_ARG etc.) instead of
                # silently dropping 20 ms of audio per frame forever
                raise RuntimeError(f"opus_encode failed: {n}")
            if n > 1:
                out.append(ctypes.string_at(self._buf, n))
            self._pending = self._pending[need:]
        return out

    def close(self):
        if self._enc:
            self._lib.opus_encoder_destroy(self._enc)
            self._enc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class OpusChunkDecoder:
    """Decode the opus audio stream (one raw opus packet per CBOR
    ``data`` field, OpusChunkEncoder above).  This is the Python
    stand-in for the browser's WebCodecs AudioDecoder -- html/app.js
    feeds the same packets to AudioDecoder({codec:"opus"}); tests and
    tools/verify/client.py close the loop here at signal level
    (reference browsers decode opus in their WASM module,
    jsdsp/src/index.js:17-39)."""

    def __init__(self, rate: int = 48000, channels: int = 1):
        lib = _load_opus()
        if not hasattr(lib, "_dec_proto"):
            lib.opus_decoder_create.restype = ctypes.c_void_p
            lib.opus_decoder_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.opus_decode.restype = ctypes.c_int
            lib.opus_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
            lib._dec_proto = True
        self._lib = lib
        self.rate = rate
        self.channels = channels
        err = ctypes.c_int(0)
        self._dec = lib.opus_decoder_create(rate, channels,
                                            ctypes.byref(err))
        if err.value != 0 or not self._dec:
            raise RuntimeError(f"opus_decoder_create failed: {err.value}")
        # max opus frame: 120 ms
        self._max = rate * 120 // 1000
        self._buf = np.zeros(self._max * channels, np.int16)

    def decode(self, packet: bytes) -> np.ndarray:
        """One opus packet -> interleaved int16 PCM at self.rate."""
        n = self._lib.opus_decode(
            self._dec, packet, len(packet),
            self._buf.ctypes.data, self._max, 0)
        if n < 0:
            raise RuntimeError(f"opus_decode rc={n}")
        return self._buf[:n * self.channels].copy()

    def close(self):
        if self._dec:
            self._lib.opus_decoder_destroy(self._dec)
            self._dec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# --------------------------------------------------------------------- zstd

class _ZstdBuffer(ctypes.Structure):
    # ZSTD_inBuffer / ZSTD_outBuffer: {pointer, size, pos}
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_zstdlib = None


def _load_zstd():
    """The system libzstd, bound with ctypes (the python-zstandard
    package is not installed everywhere this server runs)."""
    global _zstdlib
    if _zstdlib is None:
        lib = ctypes.CDLL("libzstd.so.1")
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_createCCtx.argtypes = []
        lib.ZSTD_freeCCtx.restype = ctypes.c_size_t
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
        lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_int]
        lib.ZSTD_compressStream2.restype = ctypes.c_size_t
        lib.ZSTD_compressStream2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_ZstdBuffer),
            ctypes.POINTER(_ZstdBuffer), ctypes.c_int]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int]
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_createDStream.argtypes = []
        lib.ZSTD_freeDStream.restype = ctypes.c_size_t
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_ZstdBuffer),
            ctypes.POINTER(_ZstdBuffer)]
        lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t
        lib.ZSTD_DStreamOutSize.argtypes = []
        _zstdlib = lib
    return _zstdlib


_ZSTD_C_COMPRESSION_LEVEL = 100
_ZSTD_E_FLUSH = 1


def zstd_frame(data: bytes, level: int) -> bytes:
    """``data`` as one whole zstd frame (ZSTD_compress), which a fresh
    decoder decodes alone -- unlike a ``ZstdStream`` message after the
    first."""
    lib = _load_zstd()
    cap = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(dst, cap, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise RuntimeError(f"zstd error {n}")
    return dst.raw[:n]


class ZstdStream:
    """Per-client streaming zstd, flush per message
    (ZSTD_compressStream2 with ZSTD_e_flush, waterfallcompression.cpp:24-37).
    """

    def __init__(self, level: int = 3):
        self._lib = _load_zstd()
        self._cctx = self._lib.ZSTD_createCCtx()
        if not self._cctx:
            raise MemoryError("ZSTD_createCCtx failed")
        self._check(self._lib.ZSTD_CCtx_setParameter(
            self._cctx, _ZSTD_C_COMPRESSION_LEVEL, level))

    def _check(self, ret: int) -> int:
        if self._lib.ZSTD_isError(ret):
            raise RuntimeError(f"zstd error {ret}")
        return ret

    def compress(self, data: bytes) -> bytes:
        src = ctypes.create_string_buffer(data, len(data))
        inb = _ZstdBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        cap = self._lib.ZSTD_compressBound(len(data)) + 64
        parts = []
        while True:
            dst = ctypes.create_string_buffer(cap)
            outb = _ZstdBuffer(ctypes.cast(dst, ctypes.c_void_p), cap, 0)
            left = self._check(self._lib.ZSTD_compressStream2(
                self._cctx, ctypes.byref(outb), ctypes.byref(inb),
                _ZSTD_E_FLUSH))
            parts.append(ctypes.string_at(dst, outb.pos))
            if left == 0:
                return b"".join(parts)

    def __del__(self):
        if getattr(self, "_cctx", None):
            self._lib.ZSTD_freeCCtx(self._cctx)
            self._cctx = None


class ZstdDecompressStream:
    """The client side of a ``ZstdStream``: one streaming decoder per
    connection (ZSTD_decompressStream), ``decompress`` returning all the
    bytes each flushed message completes."""

    def __init__(self):
        self._lib = _load_zstd()
        self._dctx = self._lib.ZSTD_createDStream()
        if not self._dctx:
            raise MemoryError("ZSTD_createDStream failed")
        self._cap = self._lib.ZSTD_DStreamOutSize()

    def decompress(self, data: bytes) -> bytes:
        src = ctypes.create_string_buffer(data, len(data))
        inb = _ZstdBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        dst = ctypes.create_string_buffer(self._cap)
        parts = []
        while True:
            outb = _ZstdBuffer(ctypes.cast(dst, ctypes.c_void_p), self._cap,
                               0)
            ret = self._lib.ZSTD_decompressStream(
                self._dctx, ctypes.byref(outb), ctypes.byref(inb))
            if self._lib.ZSTD_isError(ret):
                raise RuntimeError(f"zstd error {ret}")
            parts.append(ctypes.string_at(dst, outb.pos))
            # all input taken and the output not full: nothing is left
            # buffered inside the decoder for this message
            if inb.pos == inb.size and outb.pos < self._cap:
                return b"".join(parts)

    def __del__(self):
        if getattr(self, "_dctx", None):
            self._lib.ZSTD_freeDStream(self._dctx)
            self._dctx = None


class DeflateStream:
    """Per-client streaming RAW deflate, flush per message -- the
    browser-native alternative to zstd for the built-in html/ frontend
    (DecompressionStream('deflate-raw') is universal; zstd is not).
    Extension beyond the reference wire format
    (waterfallcompression.cpp is zstd-only); a waterfall client opts in
    with {"cmd":"compression","waterfall":"deflate"} and the server
    acks with a {"type":"compression"} text frame before the first
    deflate row.  Z_SYNC_FLUSH plays the role of ZSTD_e_flush: every
    message ends on a byte boundary the decompressor can fully drain.
    """

    def __init__(self, level: int = 6):
        import zlib

        self._zlib = zlib
        self._c = zlib.compressobj(level, zlib.DEFLATED, -15)

    def compress(self, data: bytes) -> bytes:
        return (self._c.compress(data)
                + self._c.flush(self._zlib.Z_SYNC_FLUSH))
