"""AV1 waterfall compression via the system libaom (ctypes).

Mirrors the reference AV1Encoder (reference:
src/waterfallcompression.cpp:40-129): coalesce WATERFALL_COALESCE=8
waterfall rows into one monochrome lossless AV1 frame (realtime usage,
cpu-used 8), with the 8 per-line headers zstd-compressed into an
ITU-T T.35 metadata OBU; the browser decodes with dav1d WASM
(jsdsp/lib/dav1d.cpp).

This image ships libaom.so.3 (v3.6) but no headers, so the binding
declares the v3.6 ABI itself and **validates the layout at import
time**: after aom_codec_enc_config_default fills the config, known
default values (g_w=320/g_h=240 adjacent, bit depths 8/8, timebase
1/30, kf_max_dist=9999) must appear at the expected word offsets, and
after aom_img_alloc the image dims must appear at theirs -- otherwise
AV1 support disables itself and the server falls back to zstd.

This package's copy compresses the metadata with the system libzstd
(``codecs.zstd_frame``): one whole frame per blob, since the browser
decodes each blob with a fresh decoder.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .codecs import zstd_frame

WATERFALL_COALESCE = 8

AOM_USAGE_REALTIME = 1
AOM_IMG_FMT_PLANAR = 0x100
AOM_IMG_FMT_I420 = AOM_IMG_FMT_PLANAR | 2
OBU_METADATA_TYPE_ITUT_T35 = 4
AOM_MIF_ANY_FRAME = 2  # aom_image.h enum aom_metadata_insert_flags
AOM_CODEC_CX_FRAME_PKT = 0
AOM_RC_ONE_PASS = 0
AOM_CQ = 2
AOM_BITS_8 = 8

# aomcx.h enum aome_enc_control_id values, established EMPIRICALLY
# against the shipped libaom.so.3 (v3.6) since no headers exist in this
# image: CPUUSED=13 (accepts 0..9), CQ_LEVEL=25 (range-checks 0..63,
# rejects 64), LOSSLESS=31 (verified functionally: enabling it nearly
# doubles the encoded size of full-entropy noise frames, 6.3->11.8 kB
# for 8x1024 random int8 -- the quantizer path is bypassed).  Control
# return codes are CHECKED so any future ABI drift fails loudly instead
# of silently degrading "lossless" to lossy.
AOME_SET_CPUUSED = 13
AOME_SET_CQ_LEVEL = 25
AV1E_SET_LOSSLESS = 31

# word offsets (u32) into aom_codec_enc_cfg_t, libaom 3.6 layout
W_USAGE = 0
W_THREADS = 1
W_PROFILE = 2
W_W = 3
W_H = 4
W_BIT_DEPTH = 8
W_INPUT_BIT_DEPTH = 9
W_TIMEBASE_NUM = 10
W_TIMEBASE_DEN = 11
W_PASS = 13
W_LAG_IN_FRAMES = 14
W_RC_END_USAGE = 24
# 8-byte-aligned twopass fixed_bufs at words 26..33
W_RC_TARGET_BITRATE = 34
W_RC_MIN_QUANTIZER = 35
W_RC_MAX_QUANTIZER = 36
# rc_2pass_vbr_{bias,minsection,maxsection}_pct at 42..44
W_FWD_KF_ENABLED = 45
W_KF_MODE = 46
W_KF_MAX_DIST = 48
W_MONOCHROME = 52

# byte offsets into aom_image_t (v3.6)
IMG_W_MONOCHROME = 4          # word: int monochrome
IMG_W_W = 7                   # word: unsigned w
IMG_W_H = 8
IMG_W_DW = 10
IMG_W_DH = 11
IMG_B_PLANES = 64             # byte: unsigned char *planes[3]
IMG_B_STRIDE = 88             # byte: int stride[3]

_CFG_WORDS = 4096 // 4


class _AomError(RuntimeError):
    pass


class _Aom:
    """Lazily-loaded, layout-validated libaom binding (singleton)."""

    _instance = None
    _failed: str | None = None

    def __init__(self):
        lib = ctypes.CDLL("libaom.so.3")
        lib.aom_codec_av1_cx.restype = ctypes.c_void_p
        lib.aom_codec_enc_config_default.restype = ctypes.c_int
        lib.aom_codec_enc_config_default.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint]
        lib.aom_codec_enc_init_ver.restype = ctypes.c_int
        lib.aom_codec_enc_init_ver.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_int]
        lib.aom_codec_encode.restype = ctypes.c_int
        lib.aom_codec_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_ulong, ctypes.c_long]
        lib.aom_codec_get_cx_data.restype = ctypes.c_void_p
        lib.aom_codec_get_cx_data.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.aom_img_alloc.restype = ctypes.c_void_p
        lib.aom_img_alloc.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
            ctypes.c_uint]
        lib.aom_img_free.argtypes = [ctypes.c_void_p]
        lib.aom_img_add_metadata.restype = ctypes.c_int
        lib.aom_img_add_metadata.argtypes = [
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_char_p,
            ctypes.c_size_t, ctypes.c_int]
        lib.aom_img_remove_metadata.argtypes = [ctypes.c_void_p]
        lib.aom_codec_destroy.argtypes = [ctypes.c_void_p]
        lib.aom_codec_error.restype = ctypes.c_char_p
        lib.aom_codec_error.argtypes = [ctypes.c_void_p]
        self.lib = lib
        self.iface = lib.aom_codec_av1_cx()
        if not self.iface:
            raise _AomError("aom_codec_av1_cx returned NULL")
        self._validate_cfg_layout()
        self.abi_version = self._probe_abi_version()

    # -------------------------------------------------------------
    def default_cfg(self, usage: int = AOM_USAGE_REALTIME):
        cfg = (ctypes.c_uint32 * _CFG_WORDS)()
        rc = self.lib.aom_codec_enc_config_default(
            self.iface, ctypes.byref(cfg), usage)
        if rc != 0:
            raise _AomError(f"enc_config_default rc={rc}")
        return cfg

    def _validate_cfg_layout(self):
        cfg = self.default_cfg()
        checks = [
            (W_USAGE, AOM_USAGE_REALTIME),
            (W_W, 320), (W_H, 240),
            (W_BIT_DEPTH, 8), (W_INPUT_BIT_DEPTH, 8),
            (W_TIMEBASE_NUM, 1), (W_TIMEBASE_DEN, 30),
            (W_RC_TARGET_BITRATE, 256),
            (W_RC_MAX_QUANTIZER, 63),
            (42, 50), (44, 2000),      # rc_2pass_vbr bias/maxsection
            (W_KF_MODE, 1),
            (W_KF_MAX_DIST, 9999),
        ]
        for off, want in checks:
            if cfg[off] != want:
                raise _AomError(
                    f"aom_codec_enc_cfg_t layout mismatch: word {off} = "
                    f"{cfg[off]}, expected {want} (libaom != 3.6 ABI?)")

    def _probe_abi_version(self) -> int:
        """aom_codec_enc_init_ver returns ABI_MISMATCH (3) for wrong
        versions without touching state -- probe until accepted."""
        cfg = self.default_cfg()
        for ver in range(1, 80):
            ctx = (ctypes.c_uint8 * 256)()
            rc = self.lib.aom_codec_enc_init_ver(
                ctypes.byref(ctx), self.iface, ctypes.byref(cfg), 0, ver)
            if rc == 0:
                self.lib.aom_codec_destroy(ctypes.byref(ctx))
                return ver
            if rc != 3:  # not ABI_MISMATCH: version ok but init failed
                raise _AomError(f"probe init rc={rc} at ver={ver}")
        raise _AomError("no accepted encoder ABI version in 1..79")

    @classmethod
    def get(cls) -> "_Aom | None":
        if cls._instance is None and cls._failed is None:
            try:
                cls._instance = cls()
            except Exception as e:  # disable AV1, fall back to zstd
                cls._failed = str(e)
        return cls._instance

    @classmethod
    def failure(cls) -> str | None:
        cls.get()
        return cls._failed


def av1_available() -> bool:
    return _Aom.get() is not None


class AV1Encoder:
    """Per-client AV1 waterfall encoder (reference AV1Encoder,
    waterfallcompression.cpp:40-129)."""

    def __init__(self, waterfall_size: int):
        aom = _Aom.get()
        if aom is None:
            raise _AomError(_Aom.failure() or "libaom unavailable")
        self.aom = aom
        lib = aom.lib
        self.width = waterfall_size
        self.lines = 0
        self.frames = 0
        self.headers: list[tuple[int, int, int, int]] = [(0, 0, 0, 0)] * WATERFALL_COALESCE

        # image: monochrome I420, waterfall_size x 8
        self.img = lib.aom_img_alloc(None, AOM_IMG_FMT_I420,
                                     waterfall_size, WATERFALL_COALESCE, 1)
        if not self.img:
            raise _AomError("aom_img_alloc failed")
        w32 = ctypes.cast(self.img, ctypes.POINTER(ctypes.c_uint32))
        if (w32[IMG_W_DW] != waterfall_size
                or w32[IMG_W_DH] != WATERFALL_COALESCE):
            raise _AomError("aom_image_t layout mismatch (d_w/d_h)")
        w32[IMG_W_MONOCHROME] = 1
        self.plane0 = ctypes.cast(
            self.img + IMG_B_PLANES, ctypes.POINTER(ctypes.c_void_p))[0]
        self.stride0 = ctypes.cast(
            self.img + IMG_B_STRIDE, ctypes.POINTER(ctypes.c_int))[0]
        if self.stride0 < waterfall_size:
            raise _AomError("aom_image_t layout mismatch (stride)")

        cfg = aom.default_cfg(AOM_USAGE_REALTIME)
        cfg[W_H] = WATERFALL_COALESCE
        cfg[W_W] = waterfall_size
        cfg[W_BIT_DEPTH] = AOM_BITS_8
        cfg[W_INPUT_BIT_DEPTH] = 8
        cfg[W_PROFILE] = 0
        cfg[W_PASS] = AOM_RC_ONE_PASS
        cfg[W_LAG_IN_FRAMES] = 0
        cfg[W_RC_END_USAGE] = AOM_CQ
        cfg[W_RC_MAX_QUANTIZER] = 63 - 50
        cfg[W_RC_MIN_QUANTIZER] = 63 - 52
        cfg[W_MONOCHROME] = 1
        self._cfg = cfg  # must outlive the ctx (aom keeps the pointer)

        self.ctx = (ctypes.c_uint8 * 256)()
        rc = lib.aom_codec_enc_init_ver(
            ctypes.byref(self.ctx), aom.iface, ctypes.byref(cfg), 0,
            aom.abi_version)
        if rc != 0:
            raise _AomError(f"aom_codec_enc_init rc={rc}")
        lib.aom_codec_control.restype = ctypes.c_int
        for cid, val, name in ((AOME_SET_CPUUSED, 8, "CPUUSED"),
                               (AOME_SET_CQ_LEVEL, 63 - 51, "CQ_LEVEL"),
                               (AV1E_SET_LOSSLESS, 1, "LOSSLESS")):
            rc = lib.aom_codec_control(ctypes.byref(self.ctx),
                                       ctypes.c_int(cid),
                                       ctypes.c_int(val))
            if rc != 0:
                raise _AomError(f"aom_codec_control({name}={val}) rc={rc}")

    def send(self, row: bytes, frame_num: int, l: int, r: int) -> bytes | None:
        """Add one waterfall line; returns an encoded AV1 frame every
        WATERFALL_COALESCE lines, else None."""
        lib = self.aom.lib
        arr = np.frombuffer(row, np.uint8)
        n = min(arr.size, self.width)
        # values are int8 dB ^ 0x80 into the luma plane (reference :90)
        shifted = (arr[:n] ^ 0x80).tobytes()
        ctypes.memmove(self.plane0 + self.lines * self.stride0, shifted, n)
        self.headers[self.lines] = (frame_num, n, l, r)
        self.lines += 1
        if self.lines < WATERFALL_COALESCE:
            return None
        self.lines = 0

        # per-line headers -> zstd -> T.35 metadata OBU (reference :100-108)
        # wire layout per line: {u64 frame_num; u32 bytes; u32 l; u32 r}
        # padded to 24 bytes (waterfallcompression.h:57-62)
        hdr_blob = b"".join(
            struct.pack("<QIII4x", fn, nb, hl, hr)
            for fn, nb, hl, hr in self.headers
        )
        meta = b"\x00" + zstd_frame(hdr_blob, 5)
        lib.aom_img_remove_metadata(self.img)
        rc = lib.aom_img_add_metadata(self.img, OBU_METADATA_TYPE_ITUT_T35,
                                      meta, len(meta), AOM_MIF_ANY_FRAME)
        if rc != 0:
            raise _AomError("aom_img_add_metadata failed")

        rc = lib.aom_codec_encode(ctypes.byref(self.ctx), self.img,
                                  self.frames, 1, 0)
        if rc != 0:
            err = lib.aom_codec_error(ctypes.byref(self.ctx))
            raise _AomError(f"aom_codec_encode rc={rc}: {err}")
        self.frames += 1

        out = b""
        it = ctypes.c_void_p(None)
        while True:
            pkt = lib.aom_codec_get_cx_data(ctypes.byref(self.ctx),
                                            ctypes.byref(it))
            if not pkt:
                break
            kind = ctypes.cast(pkt, ctypes.POINTER(ctypes.c_int))[0]
            if kind == AOM_CODEC_CX_FRAME_PKT:
                u64 = ctypes.cast(pkt, ctypes.POINTER(ctypes.c_uint64))
                buf, sz = u64[1], u64[2]
                out += ctypes.string_at(buf, sz)
        return out or None

    def close(self):
        if getattr(self, "ctx", None) is not None:
            self.aom.lib.aom_codec_destroy(ctypes.byref(self.ctx))
            self.ctx = None
        if getattr(self, "img", None):
            self.aom.lib.aom_img_free(self.img)
            self.img = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AV1Decoder:
    """Verification-side decoder over the same libaom (aom_codec_av1_dx).

    The reference decodes in the browser with the dav1d WASM build
    (jsdsp/lib/dav1d.cpp); binding the system decoder lets tests and
    tools close the waterfall codec loop end to end: the encoder runs
    AV1E_SET_LOSSLESS, so the decoded luma must equal the encoded
    int8^0x80 rows BIT-EXACTLY, and the T.35 metadata OBU must carry
    the zstd'd per-line headers back out.  Same ABI discipline as the
    encoder: init-probe for the version, aom_image_t read through the
    validated word offsets above.
    """

    def __init__(self):
        aom = _Aom.get()
        if aom is None:
            raise _AomError(_Aom.failure() or "libaom unavailable")
        self.aom = aom
        lib = aom.lib
        lib.aom_codec_av1_dx.restype = ctypes.c_void_p
        lib.aom_codec_dec_init_ver.restype = ctypes.c_int
        lib.aom_codec_dec_init_ver.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_int]
        lib.aom_codec_decode.restype = ctypes.c_int
        lib.aom_codec_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p]
        lib.aom_codec_get_frame.restype = ctypes.c_void_p
        lib.aom_codec_get_frame.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        self.iface = lib.aom_codec_av1_dx()
        if not self.iface:
            raise _AomError("aom_codec_av1_dx returned NULL")
        # decoder ABI probe (dec_init_ver returns ABI_MISMATCH=3 for a
        # wrong version, like the encoder path)
        self.ctx = (ctypes.c_uint8 * 256)()
        for ver in range(1, 80):
            rc = lib.aom_codec_dec_init_ver(
                ctypes.byref(self.ctx), self.iface, None, 0, ver)
            if rc == 0:
                break
            if rc != 3:
                raise _AomError(f"dec init rc={rc} at ver={ver}")
        else:
            raise _AomError("no accepted decoder ABI version in 1..79")

    def decode(self, frame_bytes: bytes) -> list[np.ndarray]:
        """Decode one wire blob (a full temporal unit from
        AV1Encoder.send); returns the decoded frames as [8, width]
        int8 arrays (the ^0x80 luma shift undone)."""
        lib = self.aom.lib
        rc = lib.aom_codec_decode(ctypes.byref(self.ctx), frame_bytes,
                                  len(frame_bytes), None)
        if rc != 0:
            err = lib.aom_codec_error(ctypes.byref(self.ctx))
            raise _AomError(f"aom_codec_decode rc={rc}: {err}")
        out = []
        it = ctypes.c_void_p(None)
        while True:
            img = lib.aom_codec_get_frame(ctypes.byref(self.ctx),
                                          ctypes.byref(it))
            if not img:
                break
            w32 = ctypes.cast(img, ctypes.POINTER(ctypes.c_uint32))
            d_w, d_h = w32[IMG_W_DW], w32[IMG_W_DH]
            plane0 = ctypes.cast(
                img + IMG_B_PLANES, ctypes.POINTER(ctypes.c_void_p))[0]
            stride0 = ctypes.cast(
                img + IMG_B_STRIDE, ctypes.POINTER(ctypes.c_int))[0]
            if not plane0 or stride0 < d_w:
                raise _AomError("decoded aom_image_t layout mismatch")
            rows = np.empty((d_h, d_w), np.uint8)
            for y in range(d_h):
                rows[y] = np.frombuffer(
                    ctypes.string_at(plane0 + y * stride0, d_w), np.uint8)
            out.append((rows ^ 0x80).astype(np.int8))
        return out

    def close(self):
        if getattr(self, "ctx", None) is not None:
            self.aom.lib.aom_codec_destroy(ctypes.byref(self.ctx))
            self.ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
