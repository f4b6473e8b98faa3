"""Server configuration: TOML surface + derived DSP parameters.

Config-file-compatible with the reference (same sections/keys,
reference: src/spectrumserver.cpp:17-151, 299-372, config.toml):
``[server]`` port/html_root/otherusers/threads/host, ``[input]``
sps/frequency/fft_size/signal/audio_sps/waterfall_size/
brightness_offset/*_compression/accelerator/fft_threads,
``[input.driver]`` name/format, ``[input.defaults]``
frequency/modulation, ``[register]``, ``[limits]``.

All derived quantities follow the reference formulas exactly
(file:line cites inline).  ``accelerator``/``fft_threads`` are parsed
for compatibility; the compute device is chosen by the caller
(``HopPipeline(cfg, device=...)``, ``--device``).

This is the PyTorch/CUDA package's own copy of the JAX package's
config, with its validations, and a few of its own that fail at load
what would otherwise fail at the first step (a mesh that does not
divide the step, the K-AGC step limit, an unknown waterfall codec).
The ``[tpu]`` table keeps its name for config-file compatibility; its
``fft_strategy`` key is read and ignored.
"""

from __future__ import annotations

import math
import secrets
import tomllib
from dataclasses import dataclass, field

MODE_NAMES = ("USB", "LSB", "AM", "FM")
OPUS_RATES = (48000, 24000, 16000, 12000, 8000)


def opus_decim_factor(audio_sps: int) -> int:
    """Smallest integer decimation landing exactly on a legal Opus rate
    (1 = none found / not needed).  The ONLY place this selection lives;
    runtime/codecs.py consumes it too."""
    if audio_sps in OPUS_RATES:
        return 1  # already legal; anything else searches, including
        # sub-48k rates like 32000 (/2 -> 16000) or 36000 (/3 -> 12000)
    for factor in range(2, 65):
        if audio_sps % factor == 0 and audio_sps // factor in OPUS_RATES:
            return factor
    return 1


@dataclass
class ServerConfig:
    # [server]
    port: int = 9002
    host: str = "0.0.0.0"
    html_root: str = "html/"
    otherusers: bool = True
    threads: int = 1
    # [input]
    sps: int = 0
    frequency: int = 0
    fft_size: int = 131072          # default, spectrumserver.cpp:54
    is_real: bool = False
    audio_sps: int = 12000          # audio_max_sps default, :55
    waterfall_size: int = 1024      # min_waterfall_fft default, :56
    brightness_offset: int = 0
    audio_compression: str = "flac"
    waterfall_compression: str = "zstd"
    # PLL carrier-synchronous AM detection (the reference's liquid-dsp
    # path, signal.cpp:242-252) -- DEFAULT, matching the reference's
    # normal build; false = envelope only (its non-liquid fallback).
    # With am_sync on, each listener can still opt out to envelope
    # per-client ({"cmd":"am_sync","enabled":false}).
    am_sync: bool = True
    # Opt-in DSP stages, all on the device: WBFM stereo, RDS,
    # de-emphasis and the noise processors (nr_algo: spectral NR, LMS NR
    # "lms", auto-notch "notch" or the noise blanker "nb").
    stereo: bool = False
    nr: bool = False
    nr_algo: str = "spectral"
    nr_gain: float = 1.0
    nr_alpha: float = 0.95
    nr_asnr_db: float = 30.0
    nr_taps: int = 64
    nr_delay: int = 8
    nr_two_mu: float = 1e-4
    nr_leakage: float = 0.1
    nb_thresh: float = 5.0
    nb_taps: int = 32
    nb_samples: int = 11
    deemphasis: float = 0.0
    rds: bool = False
    input_format: str = "f32"
    input_driver: str = "stdin"
    # [input.defaults]
    default_frequency: int = -1
    default_mode_str: str = "USB"
    # [register]
    register_enable: bool = False
    register_name: str = "SDR"
    register_hardware: str = ""
    register_antenna: str = ""
    register_description: str = ""
    register_url: str = ""
    register_password: str = ""
    # [limits] (parsed, reference never enforces them: spectrumserver.cpp:92-94)
    limit_audio: int = 1000
    limit_waterfall: int = 1000
    limit_events: int = 1000
    # [tpu] table: device-build extras (not in the reference surface)
    hop_batch: int = 4              # hops per device step
    max_channels: int = 128         # static channel-table capacity
    fft_strategy: str = "auto"      # read for compatibility, unused
    mesh_devices: int = 1           # >1: run the server on a device mesh
    #                                 (time-sharded FFT + channel-sharded
    #                                 demod, parallel/sharded.py)
    channel_bucket: int = 32        # active-channel bucketing: when the
    #                                 highest active slot fits, the step
    #                                 runs at this table width instead of
    #                                 max_channels, shrinking output
    #                                 bytes + demod compute to the live
    #                                 population.  0 disables.  Single-
    #                                 device mode only (the mesh shards
    #                                 the fixed channel axis).

    # ------------- derived (filled by finalize) -------------
    fft_result_size: int = field(default=0)
    basefreq: int = field(default=0)
    audio_max_fft_size: int = field(default=0)
    downsample_levels: int = field(default=0)
    skip_num: int = field(default=1)
    default_mode: str = field(default="USB")
    default_l: int = field(default=0)
    default_m: float = field(default=0.0)
    default_r: int = field(default=0)
    opus_decim: int = field(default=1)

    def finalize(self) -> "ServerConfig":
        if self.sps <= 0:
            raise ValueError("Missing sample rate ([input] sps)")
        # spectrumserver.cpp:99-105
        if self.is_real:
            self.fft_result_size = self.fft_size // 2
            self.basefreq = self.frequency
        else:
            self.fft_result_size = self.fft_size
            self.basefreq = self.frequency - self.sps // 2

        # spectrumserver.cpp:110-120
        if self.default_frequency == -1:
            self.default_frequency = self.basefreq + self.sps // 2
        if self.is_real:
            m = (self.default_frequency - self.basefreq) * self.fft_result_size * 2 / self.sps
        else:
            m = (self.default_frequency - self.basefreq) * self.fft_result_size / self.sps

        # spectrumserver.cpp:121-149
        off3 = 3000 * self.fft_result_size // self.sps
        off5 = 5000 * self.fft_result_size // self.sps
        off96 = 96000 * self.fft_result_size // self.sps
        mode = self.default_mode_str.upper()
        mi = int(m)
        if mode == "LSB":
            self.default_mode, l, r = "LSB", mi - off3, mi
        elif mode == "AM":
            self.default_mode, l, r = "AM", mi - off5, mi + off5
        elif mode == "FM":
            self.default_mode, l, r = "FM", mi - off5, mi + off5
        elif mode == "WBFM":
            self.default_mode, l, r = "FM", mi - off96, mi + off96
        else:
            self.default_mode, l, r = "USB", mi, mi + off3
        self.default_m = max(0.0, min(float(self.fft_result_size), m))
        self.default_l = max(0, min(self.fft_result_size, l))
        self.default_r = max(0, min(self.fft_result_size, r))

        # spectrumserver.cpp:151
        self.audio_max_fft_size = (
            math.ceil(self.audio_sps * self.fft_size / self.sps / 4.0) * 4
        )

        # spectrumserver.cpp:186-190 (guarded: at least one level even
        # when waterfall_size > fft_result_size, or the waterfall
        # registries index an empty pyramid)
        self.downsample_levels = 0
        cur = self.fft_result_size
        while cur >= self.waterfall_size:
            self.downsample_levels += 1
            cur //= 2
        if self.downsample_levels == 0:
            self.downsample_levels = 1
            self.waterfall_size = self.fft_result_size

        # fft.cpp:33 (waterfall ~10 fps throttle)
        self.skip_num = max(1, int(self.sps / self.fft_size / 10.0) * 2)

        # Opus can only run at <=48 kHz (src/audio.cpp:59 clamps the rate
        # WITHOUT resampling -- a 4x time-stretch at the 192 kHz WBFM
        # profile).  Deviation (improvement): pick the smallest integer
        # decimation landing exactly on a legal Opus rate; the stream is
        # anti-alias filtered + decimated (on device when the hop-batch
        # geometry divides, ops/polyphase.py) before encoding.
        self.opus_decim = (opus_decim_factor(self.audio_sps)
                           if self.audio_compression == "opus" else 1)
        if (self.audio_compression == "opus"
                and self.audio_sps // self.opus_decim not in OPUS_RATES):
            # fail at config time: libopus rejects non-{8,12,16,24,48}k
            # rates, which would otherwise kill every audio connection
            # at accept time (the reference has the same latent failure,
            # src/audio.cpp:59 clamps without resampling)
            raise ValueError(
                f"audio_sps={self.audio_sps} cannot feed Opus: no integer "
                f"decimation reaches a legal rate {OPUS_RATES}; use one of "
                f"those rates (or a multiple) or audio_compression='flac'")

        if self.stereo:
            from .ops.stereo import MIN_STEREO_SPS

            if self.audio_sps < MIN_STEREO_SPS:
                # the 38 kHz DSB subcarrier (+15 kHz audio) must sit
                # inside the audio Nyquist or there is nothing to decode
                raise ValueError(
                    f"[input] stereo=true needs audio_sps >= "
                    f"{MIN_STEREO_SPS} (WBFM multiplex bandwidth); got "
                    f"{self.audio_sps}")

        if self.nr and self.nr_algo not in ("spectral", "lms", "notch",
                                            "nb"):
            raise ValueError(
                f"[input] nr_algo must be spectral/lms/notch/nb, got "
                f"{self.nr_algo!r}")
        if self.nr and self.stereo:
            # NR operates on the mono stream before the stereo demix
            raise ValueError("[input] nr=true and stereo=true cannot "
                             "be combined")

        if self.fft_size <= 0 or self.fft_size & (self.fft_size - 1):
            # the reference's FFTW accepts arbitrary sizes; the pyramid
            # halvings and the waterfall kernel's tiling assume a power
            # of two -- fail at config time with a clear message
            raise ValueError("[input] fft_size must be a power of two "
                             f"(got {self.fft_size})")

        if self.deemphasis < 0 or self.deemphasis > 1000:
            raise ValueError("[input] deemphasis must be 0..1000 us")

        if self.nr and self.nr_algo == "nb":
            if not 3 <= self.nb_samples <= 201:
                # impulse_len 1 would divide by zero in the crossfade
                # weights (ops/nb.py) and NaN every repair
                raise ValueError("[input] nb_samples must be in [3, 201]")
            if not 1 <= self.nb_taps <= 40:
                raise ValueError("[input] nb_taps must be in [1, 40] "
                                 "(NB.c:19 max_lpc_order)")

        if self.rds:
            from .ops.rds import (
                MAX_BASEBAND_SPS, rds_decim_for,
            )

            # the 57 kHz subcarrier (+2.4 kHz data lobe) must sit inside
            # the audio Nyquist
            min_sps = int(2 * (57000 + 2400))
            if self.audio_sps < min_sps:
                raise ValueError(
                    f"[input] rds=true needs audio_sps >= {min_sps} "
                    f"(57 kHz subcarrier bandwidth); got {self.audio_sps}")
            d = rds_decim_for(self.audio_sps, self.audio_fft_size // 2)
            if self.audio_sps / d > MAX_BASEBAND_SPS:
                # the decimation factor must divide the per-hop audio
                # block; a pathological audio_fft_size would ship
                # near-raw-rate baseband over the link
                raise ValueError(
                    f"[input] rds=true: the audio block "
                    f"(audio_fft_size/2 = {self.audio_fft_size // 2}) "
                    f"only allows decimation by {d} "
                    f"({self.audio_sps / d:.0f} S/s baseband > "
                    f"{MAX_BASEBAND_SPS:.0f}); pick an fft_size whose "
                    f"audio block has a larger power-of-two factor")

        from .ops.agc import make_agc_params
        from .ops.cuda.agc import max_stream

        # K-AGC holds its window max in shared memory, so the audio of
        # one step per channel has a cap: fail here, not at its launch
        window = make_agc_params(self.audio_sps).window
        step = self.hop_batch * (self.audio_fft_size // 2)
        if step > max_stream(window):
            raise ValueError(
                f"[tpu] hop_batch={self.hop_batch}: {step} audio samples "
                f"per channel a step; the AGC takes at most "
                f"{max_stream(window)} at audio_sps={self.audio_sps} "
                f"(window {window}); lower hop_batch")

        if self.mesh_devices > 1 and (self.hop_batch % self.mesh_devices
                                      or self.max_channels
                                      % self.mesh_devices):
            raise ValueError(
                f"[tpu] mesh_devices={self.mesh_devices}: hop_batch "
                f"({self.hop_batch}) and max_channels ({self.max_channels}) "
                f"must divide evenly over the mesh")
        if self.waterfall_compression not in ("zstd", "av1"):
            raise ValueError(
                f"[input] waterfall_compression must be zstd or av1, not "
                f"{self.waterfall_compression!r}")

        if not self.register_password:
            self.register_password = secrets.token_hex(16)
        return self

    # reference: size_log2 = round(log2(size)) + brightness_offset
    # (fft_impl.cpp:68)
    @property
    def size_log2(self) -> int:
        return int(round(math.log2(self.fft_size))) + self.brightness_offset

    @property
    def base_idx(self) -> int:
        """IQ fftshift offset (fft_impl.cpp:148-153, websocket.cpp:157-160)."""
        return 0 if self.is_real else self.fft_size // 2 + 1

    @property
    def audio_fft_size(self) -> int:
        """Per-client IFFT size == audio_max_fft_size (websocket.cpp:133)."""
        return self.audio_max_fft_size

    @property
    def total_bandwidth(self) -> int:
        return self.sps // 2 if self.is_real else self.sps

    @property
    def hop_size(self) -> int:
        return self.fft_size // 2

    @property
    def view_cap(self) -> int:
        """Per-client waterfall view row capacity (device gather width).

        The level-selection loop (src/waterfall.cpp:53-94, implemented
        in runtime/registry.py) picks the pyramid level whose width w
        minimizes |w - waterfall_size| over the halving chain, so the
        selected width never exceeds 4/3 * waterfall_size -- except
        when even the COARSEST level is wider (coarsest row width is in
        [waterfall_size, 2*waterfall_size) by construction and has no
        coarser level to halve to).  Sizing the gather to this bound
        instead of a blanket 2x cuts ~1/3 of the waterfall bytes off
        every device->host fetch (pure zero padding otherwise)."""
        coarsest = self.fft_result_size >> (self.downsample_levels - 1)
        return max(coarsest, (4 * self.waterfall_size) // 3 + 4)

    @property
    def device_decim(self) -> bool:
        """Opus decimation runs ON DEVICE when the per-step sample count
        divides by the factor (static shapes); otherwise the host
        fallback in runtime/codecs.py filters per client."""
        return (self.opus_decim > 1
                and (self.hop_batch * (self.audio_fft_size // 2))
                % self.opus_decim == 0)

    @property
    def opus_rate(self) -> int:
        """Actual Opus encoder rate after decimation (<=48 kHz)."""
        return min(self.audio_sps // self.opus_decim, 48000)

    @property
    def audio_channels(self) -> int:
        """Interleaved audio channels on the wire (2 with device WBFM
        stereo, else the reference's mono)."""
        return 2 if self.stereo else 1


def load_config(path: str) -> ServerConfig:
    with open(path, "rb") as f:
        t = tomllib.load(f)
    return config_from_dict(t)


def config_from_dict(t: dict) -> ServerConfig:
    c = ServerConfig()
    server = t.get("server", {})
    c.port = int(server.get("port", c.port))
    c.host = str(server.get("host", c.host))
    c.html_root = str(server.get("html_root", c.html_root))
    c.otherusers = int(server.get("otherusers", 1)) > 0
    c.threads = int(server.get("threads", 1))

    inp = t.get("input", {})
    c.sps = int(inp.get("sps", 0))
    c.frequency = int(inp.get("frequency", 0))
    c.fft_size = int(inp.get("fft_size", c.fft_size))
    sig = str(inp.get("signal", "iq")).lower()
    if sig not in ("real", "iq"):
        raise ValueError("Invalid signal type, specify either real or IQ input")
    c.is_real = sig == "real"
    c.audio_sps = int(inp.get("audio_sps", c.audio_sps))
    c.waterfall_size = int(inp.get("waterfall_size", c.waterfall_size))
    c.brightness_offset = int(inp.get("brightness_offset", 0))
    c.audio_compression = str(inp.get("audio_compression", "flac")).lower()
    c.waterfall_compression = str(inp.get("waterfall_compression", "zstd")).lower()
    c.am_sync = bool(inp.get("am_sync", True))
    c.stereo = bool(inp.get("stereo", False))
    c.nr = bool(inp.get("nr", False))
    c.nr_algo = str(inp.get("nr_algo", c.nr_algo)).lower()
    c.nr_gain = float(inp.get("nr_gain", c.nr_gain))
    c.nr_alpha = float(inp.get("nr_alpha", c.nr_alpha))
    c.nr_asnr_db = float(inp.get("nr_asnr_db", c.nr_asnr_db))
    c.nr_taps = int(inp.get("nr_taps", c.nr_taps))
    c.nr_delay = int(inp.get("nr_delay", c.nr_delay))
    c.nr_two_mu = float(inp.get("nr_two_mu", c.nr_two_mu))
    c.nr_leakage = float(inp.get("nr_leakage", c.nr_leakage))
    c.nb_thresh = float(inp.get("nb_thresh", c.nb_thresh))
    c.nb_taps = int(inp.get("nb_taps", c.nb_taps))
    c.nb_samples = int(inp.get("nb_samples", c.nb_samples))
    c.rds = bool(inp.get("rds", False))
    c.deemphasis = float(inp.get("deemphasis", 0.0))

    drv = inp.get("driver", {})
    c.input_driver = str(drv.get("name", "stdin"))
    c.input_format = str(drv.get("format", "f32")).lower()

    dfl = inp.get("defaults", {})
    c.default_frequency = int(dfl.get("frequency", -1))
    c.default_mode_str = str(dfl.get("modulation", "USB")).upper()

    reg = t.get("register", {})
    c.register_enable = bool(reg.get("enable", False))
    c.register_name = str(reg.get("name", "SDR"))
    c.register_hardware = str(reg.get("hardware", ""))
    c.register_antenna = str(reg.get("antenna", ""))
    c.register_description = str(reg.get("description", ""))
    c.register_url = str(reg.get("url", ""))
    c.register_password = str(reg.get("password", ""))

    lim = t.get("limits", {})
    c.limit_audio = int(lim.get("audio", 1000))
    c.limit_waterfall = int(lim.get("waterfall", 1000))
    c.limit_events = int(lim.get("events", 1000))

    tpu = t.get("tpu", {})
    c.hop_batch = int(tpu.get("hop_batch", c.hop_batch))
    c.max_channels = int(tpu.get("max_channels", c.max_channels))
    c.fft_strategy = str(tpu.get("fft_strategy", c.fft_strategy))
    c.mesh_devices = int(tpu.get("mesh_devices", c.mesh_devices))
    c.channel_bucket = int(tpu.get("channel_bucket", c.channel_bucket))
    return c.finalize()
