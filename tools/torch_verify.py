"""tools/verify/ (captures.py and client.py) for the PyTorch port, free of
JAX, of the JAX package, of ``tests/`` and of python-zstandard.

``capture`` writes a variant's ``capture.s16`` (interleaved s16 IQ),
``config.toml`` and ``truth.json``, byte-equal to captures.py's; the
RDS bitstream is a copy of tests/test_rds.py's synthesizer on the
port's own block code (``phantomsdr_tpu_torch.runtime.rds``).  ``check``
judges a live server by client.py's windows, settle times, trims, bars
and messages, decoding through the port's codecs: FLAC through
``tools/torch_clients.decode_flac`` and Opus through
``runtime.codecs.OpusChunkDecoder`` (libopus).  The ``tone`` variant is
``tools/torch_clients.tone_check`` (FLAC audio, zstd waterfall rows
through the system libzstd, /events); tone over Opus audio or AV1 rows
stays client.py's.

Each variant's arithmetic is a pure function of the decoded arrays or
the RDS text frames (``*_figures``), and its bars are another
(``*_bars``), which raises AssertionError with client.py's message.

Usage:
    python tools/torch_verify.py capture --variant am --out /tmp/v_am \\
        --port 19431
    python -m phantomsdr_tpu_torch -c /tmp/v_am/config.toml \\
        --input-file /tmp/v_am/capture.s16 --loop --throttle &
    python tools/torch_verify.py check --dir /tmp/v_am --secs 8

(the server runs on the card unless given ``--device cpu``).  Exit 0
and one JSON line = PASS, as client.py.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VARIANTS = ("tone", "am", "stereo", "rds", "both", "nr", "lms", "nb", "de",
            "soak")
FS_MPX = 192_000  # MPX synthesis rate for the FM variants

# client.py's bar beside each figure the check reports
BARS = {
    "tone": {"f_peak_hz": "within 20 Hz of tone_hz",
             "peak_ok": ">= 1 waterfall row at the carrier"},
    "am": {"pll": "H2/H1 < 0.1", "envelope": "H2/H1 > 0.25"},
    "stereo": {"stereo_sep_db": "> 20 dB each ear"},
    "rds": {"rds": "synced; PI, PS and RT equal the truth"},
    "nr": {"floor_drop_db": "> 4 dB", "tone_delta_db": "> -6 dB"},
    "lms": {"lms_snr_db": "on - off > 6 dB"},
    "nb": {"off": "> 20 click samples", "on": "< 0.6 x off"},
    "de": {"deemph_ratio": "within 15% of the single-pole theory"},
}
BARS["both"] = BARS["soak"] = {**BARS["stereo"], **BARS["rds"]}


# ------------------------------------------------------------- captures

def _write_iq(path: Path, iq: np.ndarray, scale=32000.0) -> None:
    s = np.empty(2 * iq.size, dtype=np.int16)
    s[0::2] = np.round(np.clip(iq.real, -1, 1) * scale).astype(np.int16)
    s[1::2] = np.round(np.clip(iq.imag, -1, 1) * scale).astype(np.int16)
    s.tofile(path)


def _fm_modulate(mpx: np.ndarray, fs_mpx: int, sps: int, secs: float,
                 dev_hz: float = 75_000.0, f_off: float = 0.0,
                 amp: float = 0.5) -> np.ndarray:
    """FM-modulate an MPX waveform at ``dev_hz`` deviation, upsampled
    (linear interp) from fs_mpx to sps, carrier at baseband ``f_off``."""
    n_lo = int(fs_mpx * secs)
    n_hi = int(sps * secs)
    t_lo = np.arange(n_lo, dtype=np.float64) / fs_mpx
    t_hi = np.arange(n_hi, dtype=np.float64) / sps
    mu = np.interp(t_hi, t_lo, mpx[:n_lo].astype(np.float64))
    ph = 2 * np.pi * dev_hz * np.cumsum(mu) / sps
    if f_off:
        ph = ph + 2 * np.pi * f_off * t_hi
    return amp * np.exp(1j * ph)


def _config(out: Path, port: int, sps: int, fft_size: int, audio_sps: int,
            extra_input: dict | None = None, modulation: str = "WBFM",
            frequency: int = 98_000_000,
            default_frequency: int = 0, mesh: int = 0,
            wf_compression: str = "zstd",
            audio_compression: str = "flac") -> None:
    lines = [
        "[server]", f"port = {port}", 'html_root = "html/"',
        "otherusers = 1", "",
        "[input]", f"sps = {sps}", f"fft_size = {fft_size}",
        f"frequency = {frequency}", 'signal = "iq"',
        f"audio_sps = {audio_sps}",
        f'audio_compression = "{audio_compression}"',
        f'waterfall_compression = "{wf_compression}"',
        "waterfall_size = 1024",
    ]
    for k, v in (extra_input or {}).items():
        if isinstance(v, bool):
            lines.append(f"{k} = {'true' if v else 'false'}")
        elif isinstance(v, str):
            lines.append(f'{k} = "{v}"')
        else:
            lines.append(f"{k} = {v}")
    if mesh:
        # mesh server mode (hop_batch and max_channels divide by the
        # mesh size); after the [input] extras: TOML keys bind to the
        # latest section
        lines += ["", "[tpu]", f"mesh_devices = {mesh}",
                  f"hop_batch = {4 * mesh}"]
    lines += ["", "[input.driver]", 'name = "stdin"', 'format = "s16"',
              "", "[input.defaults]", f'modulation = "{modulation}"']
    if default_frequency:
        lines.append(f"frequency = {default_frequency}")
    lines.append("")
    (out / "config.toml").write_text("\n".join(lines))


def _inchannel_noise(rng, n: int, sps: int, cutoff_hz: float = 4500.0,
                     rms: float = 0.15) -> np.ndarray:
    """Band-limited white noise inside the AM channel (<cutoff audio):
    the demodulated floor must be set by it, not by wideband noise the
    channel filter rejects."""
    wn = np.fft.rfft(rng.standard_normal(n))
    wn[np.fft.rfftfreq(n, 1.0 / sps) > cutoff_hz] = 0.0
    out = np.fft.irfft(wn, n)
    return out * (rms / np.sqrt(np.mean(out ** 2)))


def _stereo_mpx(n: int, fs: int = FS_MPX) -> np.ndarray:
    t = np.arange(n) / fs
    th = 2 * np.pi * 19_000.0 * t
    L = np.sin(2 * np.pi * 800.0 * t)
    R = np.sin(2 * np.pi * 1300.0 * t)
    return (0.4 * (L + R) / 2 + 0.09 * np.cos(th)
            + 0.4 * (L - R) / 2 * np.cos(2 * th)).astype(np.float32)


# the RDS synthesizer of tests/test_rds.py: known PI / PS / RadioText
PI = 0x54A7
PS = "PHANTOM!"
RT = "TPU SPECTRUM SERVER RADIOTEXT"


def _group_bits(pi=PI, ps=PS, rt=RT):
    """Clean RDS bitstream: 0A (PS) + 2A (RadioText) groups."""
    from phantomsdr_tpu_torch.runtime.rds import (
        OFFSET_A, OFFSET_B, OFFSET_C, OFFSET_D, encode_block,
    )

    blocks = []
    for seg in range(4):
        b = (0 << 12) | (9 << 5) | seg
        d = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        blocks += [(pi, OFFSET_A), (b, OFFSET_B), (0xE0E0, OFFSET_C),
                   (d, OFFSET_D)]
    text = (rt + "\r").ljust(64)[:64]
    for seg in range(16):
        b = (2 << 12) | (9 << 5) | seg
        c = (ord(text[4 * seg]) << 8) | ord(text[4 * seg + 1])
        d = (ord(text[4 * seg + 2]) << 8) | ord(text[4 * seg + 3])
        blocks += [(pi, OFFSET_A), (b, OFFSET_B), (c, OFFSET_C),
                   (d, OFFSET_D)]
    bits = []
    for data, off in blocks:
        w = encode_block(data, off)
        bits += [(w >> i) & 1 for i in range(25, -1, -1)]
    return bits


def _diff_encode(bits):
    out, prev = [], 0
    for u in bits:
        prev ^= u
        out.append(prev)
    return out


def _rds_wave(n, fs=FS_MPX, phase_off=0.0, bit_offset=0.0):
    """Differentially-encoded biphase RDS waveform at 1187.5 bps on the
    57 kHz subcarrier (3x a coherent 19 kHz pilot), amplitude 1."""
    tx = np.array(_diff_encode(_group_bits() * 40))
    pos = np.arange(n) * 1187.5 / fs + bit_offset
    k = pos.astype(int)
    sign = np.where(tx[k % len(tx)], 1.0, -1.0)
    d = sign * np.sin(2 * np.pi * (pos - k))
    th = 2 * np.pi * 19000.0 * np.arange(n) / fs
    return d * np.cos(3 * th + phase_off), th


def _mpx(n, fs=FS_MPX, phase_off=0.0, rds_amp=0.06, bit_offset=0.0):
    """FM MPX: mono + 9% pilot + stereo DSB + RDS subcarrier."""
    t = np.arange(n) / fs
    d, th = _rds_wave(n, fs, phase_off, bit_offset)
    L = np.sin(2 * np.pi * 800.0 * t)
    R = np.sin(2 * np.pi * 1300.0 * t)
    x = (0.4 * (L + R) / 2 + 0.09 * np.cos(th)
         + 0.4 * (L - R) / 2 * np.cos(2 * th) + rds_amp * d)
    return x.astype(np.float32)


def make(variant: str, out: Path, port: int, secs: float,
         fft_override: int = 0, mesh: int = 0,
         wf_compression: str = "zstd",
         audio_compression: str = "flac", cluster: bool = False) -> dict:
    """captures.py's ``make`` and the files its CLI writes: capture.s16,
    config.toml, truth.json (and config_follower.toml at port + 1 with
    ``cluster``).  Returns the truth."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    truth = _make(variant, out, port, secs, fft_override, mesh,
                  wf_compression, audio_compression)
    if cluster:
        cfg = (out / "config.toml").read_text()
        (out / "config_follower.toml").write_text(
            cfg.replace(f"port = {port}", f"port = {port + 1}"))
        truth["follower_port"] = port + 1
    (out / "truth.json").write_text(json.dumps(truth))
    return truth


def _make(variant, out, port, secs, fft_override, mesh, wf_compression,
          audio_compression) -> dict:
    rng = np.random.default_rng(7)
    truth: dict = {"variant": variant, "port": port}
    if audio_compression == "opus" and variant in ("am", "nr", "lms",
                                                   "nb", "de"):
        # the A/B decode paths of these checks are FLAC-only; an opus
        # config would report coverage the check does not give
        raise SystemExit(
            f"--audio-compression opus is not supported for variant "
            f"{variant!r} (client.py decodes these checks via FLAC); "
            f"use tone/stereo/rds/both/soak")

    if variant in ("tone", "am", "nr", "lms"):
        sps, fft = 960_000, fft_override or 32_768
        f_off = 0.15 * sps if variant == "tone" else 10.0
        n = int(sps * secs)
        t = np.arange(n, dtype=np.float64) / sps
        tone = np.sin(2 * np.pi * 1000.0 * t)
        if variant == "lms":
            # STEADY tone (LMS keeps predictable signals) + in-channel
            # noise; judged by the tone/floor RATIO
            env = 1.0 + 0.5 * tone + _inchannel_noise(rng, n, sps)
        elif variant == "nr":
            gate = ((t % 2.0) < 1.0).astype(np.float64)  # 1 s on/off
            env = 1.0 + 0.5 * tone * gate + _inchannel_noise(rng, n, sps)
        elif variant == "am":
            env = 1.0 + 1.8 * tone  # overmodulated: envelope folds
        else:
            env = 1.0 + 0.5 * tone
        iq = 0.35 * env * np.exp(2j * np.pi * f_off * t)
        _write_iq(out / "capture.s16", iq)
        extra = {}
        if variant == "nr":
            extra = {"nr": True}
        elif variant == "lms":
            extra = {"nr": True, "nr_algo": "lms"}
        _config(out, port, sps, fft, 12_000, extra_input=extra,
                modulation="AM", mesh=mesh,
                wf_compression=wf_compression,
                audio_compression=audio_compression,
                default_frequency=98_000_000 + sps // 2 + int(round(f_off)))
        truth.update(f_off_hz=f_off, tone_hz=1000.0, sps=sps,
                     fft_size=fft, audio_sps=12_000)
        return truth

    if variant == "nb":
        # sharp clicks on an AM carrier, ~8 samples wide at the 192 kHz
        # audio rate; a wide client window keeps them sharp
        sps, fft = 1_536_000, fft_override or 32_768
        n = int(sps * secs)
        t = np.arange(n, dtype=np.float64) / sps
        env = 1.0 + 0.25 * np.sin(2 * np.pi * 1000.0 * t)
        clicks = np.zeros(n)
        step = int(sps * 0.1)                    # 10 clicks/s
        for i in range(step // 2, n - 100, step):
            clicks[i:i + 64] = 4.0
        # 0.12 keeps the click peaks inside s16 full scale (no clipping)
        iq = 0.12 * (env + clicks) * np.exp(2j * np.pi * 10.0 * t)
        _write_iq(out / "capture.s16", iq)
        _config(out, port, sps, fft, 192_000,
                extra_input={"nr": True, "nr_algo": "nb",
                             "nb_samples": 25},
                modulation="AM", mesh=mesh,
                wf_compression=wf_compression,
                default_frequency=98_000_000 + sps // 2 + 10)
        truth.update(f_off_hz=10.0, tone_hz=1000.0, sps=sps,
                     fft_size=fft, audio_sps=192_000, wide_hz=90_000)
        return truth

    # FM family: MPX at 192 kHz, 8x upsampled to 1.536 MSPS (the 8x keeps
    # the audio block a power of two, which RDS decimation requires)
    if variant == "soak":
        sps, fft, secs = 1_536_000, fft_override or 131_072, max(secs, 10.0)
    else:
        sps, fft = 1_536_000, fft_override or 32_768
    n_mpx = int(FS_MPX * secs)
    extra: dict = {}
    if variant == "stereo":
        mpx = _stereo_mpx(n_mpx)
        extra = {"stereo": True}
        truth.update(left_hz=800.0, right_hz=1300.0)
    elif variant in ("rds", "both", "soak"):
        mpx = _mpx(n_mpx)  # stereo tones + pilot + RDS
        extra = {"rds": True}
        if variant in ("both", "soak"):
            extra["stereo"] = True
            truth.update(left_hz=800.0, right_hz=1300.0)
        if variant == "soak":
            extra["deemphasis"] = 75
        truth.update(pi=f"{PI:04X}", ps=PS, rt=RT)
    elif variant == "de":
        t = np.arange(n_mpx) / FS_MPX
        mpx = (0.35 * np.sin(2 * np.pi * 1000.0 * t)
               + 0.35 * np.sin(2 * np.pi * 10_000.0 * t)).astype(np.float32)
        extra = {"deemphasis": 75}
        truth.update(tone_lo_hz=1000.0, tone_hi_hz=10_000.0, tau_us=75.0)
    else:
        raise SystemExit(f"unknown variant {variant!r}")
    iq = _fm_modulate(mpx, FS_MPX, sps, secs)
    _write_iq(out / "capture.s16", iq)
    _config(out, port, sps, fft, 192_000, extra_input=extra,
            modulation="WBFM", mesh=mesh,
            wf_compression=wf_compression,
            audio_compression=audio_compression)
    truth.update(f_off_hz=0.0, sps=sps, fft_size=fft, audio_sps=192_000)
    return truth


# --------------------------------------------------------------- decoders

def decode_audio(chunks: list[bytes], channels: int, trim: int = 0,
                 compression: str = "flac"):
    """client.py's decode_audio on the port's decoders: (rate, x, None)
    or, for 2 channels, (rate, left, right), as float in [-1, 1) with
    ``trim`` leading samples a channel dropped.  Opus: one raw packet
    per CBOR data field, decoded at 48 kHz."""
    if compression == "opus":
        from phantomsdr_tpu_torch.runtime.codecs import OpusChunkDecoder

        dec = OpusChunkDecoder(48000, channels)
        try:
            pcm = [dec.decode(bytes(c)) for c in chunks if len(c)]
        finally:
            dec.close()
        samples = np.concatenate(pcm) if pcm else np.zeros(0, np.int16)
        sr = 48000
    else:
        from tools.torch_clients import decode_flac

        sr, samples = decode_flac(b"".join(bytes(c) for c in chunks))
    x = samples.astype(np.float64) / 32768.0
    if channels == 2:
        return sr, x[0::2][trim:], x[1::2][trim:]
    return sr, x[trim:], None


# ----------------------------------------------------------- pure judges

def tone_power(x: np.ndarray, fs: float, f: float, bw: float = 30.0):
    """client.py's: the Hann-windowed power spectrum's largest bin
    within ``bw`` Hz of ``f``."""
    n = len(x)
    spec = np.abs(np.fft.rfft(x * np.hanning(n))) ** 2
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    sel = (freqs > f - bw) & (freqs < f + bw)
    return spec[sel].max() if sel.any() else 0.0


def am_figures(pll: np.ndarray, env: np.ndarray, fs: float,
               tone_hz: float) -> dict:
    """H2/H1 amplitude ratio of each ear (mean removed), rounded to 3
    places as client.py judges it."""
    out = {}
    for name, x in (("pll", pll), ("envelope", env)):
        x = x - x.mean()
        h1 = tone_power(x, fs, tone_hz)
        h2 = tone_power(x, fs, 2 * tone_hz)
        out[name] = round(float(np.sqrt(h2 / max(h1, 1e-30))), 3)
    return out


def am_bars(fig: dict) -> None:
    assert fig["pll"] < 0.1, f"PLL ear folds: H2/H1={fig['pll']}"
    assert fig["envelope"] > 0.25, \
        f"envelope ear did not fold: H2/H1={fig['envelope']}"


def stereo_figures(left: np.ndarray, right: np.ndarray, fs: float,
                   truth: dict) -> list[float]:
    """[left, right] separation in dB: each ear's own tone over the
    other ear's leak of it."""
    lp_l = tone_power(left, fs, truth["left_hz"])
    lp_r = tone_power(right, fs, truth["left_hz"])
    rp_r = tone_power(right, fs, truth["right_hz"])
    rp_l = tone_power(left, fs, truth["right_hz"])
    return [float(10 * np.log10(lp_l / max(lp_r, 1e-30))),
            float(10 * np.log10(rp_r / max(rp_l, 1e-30)))]


def stereo_bars(sep: list[float]) -> None:
    assert sep[0] > 20 and sep[1] > 20, \
        f"separation L={sep[0]:.1f} R={sep[1]:.1f} dB"


def rds_figures(frames: list[dict]) -> dict:
    """The frames' count, the synced ones' count, the last frame's type
    and the last synced frame's PI / PS / RT."""
    synced = [f for f in frames if f.get("synced")]
    fin = synced[-1] if synced else {}
    return {"frames": len(frames), "synced": len(synced),
            "last_type": frames[-1].get("type") if frames else None,
            "pi": fin.get("pi"), "ps": fin.get("ps"), "rt": fin.get("rt")}


def rds_bars(fig: dict, truth: dict) -> None:
    assert fig["frames"], "no rds text frames"
    assert fig["last_type"] == "rds"
    assert fig["synced"], "rds never synced"
    assert fig["pi"] == truth["pi"], f"PI {fig['pi']}"
    assert fig["ps"] == truth["ps"], f"PS {fig['ps']!r}"
    assert fig["rt"] == truth["rt"], f"RT {fig['rt']!r}"


def _rds_result(fig: dict) -> dict:
    return {k: fig[k] for k in ("frames", "synced", "pi", "ps", "rt")}


def nr_figures(off: np.ndarray, on: np.ndarray, fs: int,
               tone_hz: float) -> dict:
    """The quietest quarter second's RMS (the floor) and the tone's
    amplitude, off then on, as dB of on over off."""
    out = {}
    for name, x in (("off", off), ("on", on)):
        wins = np.array_split(x, max(1, len(x) // (fs // 4)))
        out[name] = (min(float(np.sqrt(np.mean(w ** 2))) for w in wins),
                     float(np.sqrt(tone_power(x, fs, tone_hz))))
    return {"floor_drop_db": float(20 * np.log10(
                out["off"][0] / max(out["on"][0], 1e-30))),
            "tone_delta_db": float(20 * np.log10(
                out["on"][1] / max(out["off"][1], 1e-30)))}


def nr_bars(fig: dict) -> None:
    assert fig["floor_drop_db"] > 4, \
        f"floor only dropped {fig['floor_drop_db']:.1f} dB"
    assert fig["tone_delta_db"] > -6, \
        f"tone lost {fig['tone_delta_db']:.1f} dB"


def lms_snr_db(x: np.ndarray, fs: float) -> float:
    """The 1 kHz tone's peak bin over the mean bin of 200-4500 Hz
    outside 970-1030 Hz, in dB."""
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    sig = (freqs > 970) & (freqs < 1030)
    noise = (freqs > 200) & (freqs < 4500) & ~sig
    return float(10 * np.log10(spec[sig].max()
                               / max(np.mean(spec[noise]), 1e-30)))


def lms_figures(off: np.ndarray, on: np.ndarray, fs: float) -> dict:
    return {"off": lms_snr_db(off, fs), "on": lms_snr_db(on, fs)}


def lms_bars(fig: dict) -> None:
    gain_db = fig["on"] - fig["off"]
    assert gain_db > 6, f"LMS SNR gain only {gain_db:.1f} dB"


def nb_figures(off: np.ndarray, on: np.ndarray) -> dict:
    """The samples above 4x the RMS, off and on."""
    return {name: int(np.sum(np.abs(x) > 4.0 * np.sqrt(np.mean(x ** 2))))
            for name, x in (("off", off), ("on", on))}


def nb_bars(fig: dict) -> None:
    assert fig["off"] > 20, f"clicks not visible pre-NB ({fig['off']})"
    assert fig["on"] < 0.6 * fig["off"], \
        f"NB removed too little: {fig['off']} -> {fig['on']}"


def de_figures(x: np.ndarray, fs: float, truth: dict) -> dict:
    """The decoded high/low tone amplitude ratio (mean removed) and the
    single-pole de-emphasis response's ratio at the same tones."""
    x = x - x.mean()
    a_lo = np.sqrt(tone_power(x, fs, truth["tone_lo_hz"]))
    a_hi = np.sqrt(tone_power(x, fs, truth["tone_hi_hz"]))
    tau = truth["tau_us"] * 1e-6

    def resp(f):
        return 1.0 / np.sqrt(1 + (2 * np.pi * f * tau) ** 2)

    return {"got": float(a_hi / max(a_lo, 1e-30)),
            "theory": float(resp(truth["tone_hi_hz"])
                            / resp(truth["tone_lo_hz"]))}


def de_bars(fig: dict) -> None:
    got, expect = fig["got"], fig["theory"]
    assert abs(got - expect) / expect < 0.15, \
        f"10k/1k ratio {got:.4f}, theory {expect:.4f}"


# ----------------------------------------------------------------- clients

async def collect_ab_audio(session, url, secs, cmds, fs, settle=1.5,
                           extra=({"cmd": "nr", "enabled": True},)):
    """client.py's A/B collection: one connection without the opt-in
    commands, then one with; each decoded, its settle trimmed and its
    mean removed.  Returns (x_off, x_on)."""
    from tools.torch_clients import collect_audio

    out = []
    for add in ((), tuple(extra)):
        _, chunks = await collect_audio(
            session, url, secs, list(cmds) + list(add), settle=settle)
        _, x, _ = decode_audio(chunks, 1, int(settle * fs))
        out.append(x - x.mean())
    return out


def _audio_cmds(info, truth, mode):
    rsize = info["fft_result_size"]
    m = (0.5 + truth["f_off_hz"] / truth["sps"]) * rsize
    if mode == "WBFM":
        off = 96_000 * rsize // truth["sps"]
        mode = "FM"
    elif mode == "AM":
        off = 5_000 * rsize // truth["sps"]
    else:
        off = 3_000 * rsize // truth["sps"]
    return [{"cmd": "window", "l": int(m - off), "m": m,
             "r": int(m + off)},
            {"cmd": "demodulation", "demodulation": mode}]


async def check(url: str, truth: dict, secs: float = 8.0) -> dict:
    """client.py's ``run`` against the server at ``url`` serving the
    capture ``truth`` describes: raises AssertionError on a miss, else
    returns client.py's JSON line as a dict."""
    import aiohttp

    from tools.torch_clients import collect_audio, tone_check

    variant = truth["variant"]
    results: dict = {}
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as s:
        # handshake probe connection to learn geometry for the cmds
        info, _ = await collect_audio(s, url, 0.1)
        for k in ("sps", "fft_size", "fft_result_size", "basefreq"):
            assert k in info, f"basic_info missing {k}"
        assert info["sps"] == truth["sps"]
        fs = info["audio_max_sps"]
        ch = info.get("audio_channels", 1)
        comp = info.get("audio_compression", "flac")

        if variant == "tone":
            if comp != "flac" or info.get("waterfall_compression") == "av1":
                raise SystemExit(
                    "tone is judged over FLAC audio and zstd rows only "
                    "(torch_clients.tone_check); tools/verify/client.py "
                    "judges tone over Opus or AV1")
            results = await tone_check(url, truth, secs)

        elif variant == "am":
            cmds = _audio_cmds(info, truth, "AM")
            (_, pll), (_, env) = await asyncio.gather(
                collect_audio(s, url, secs, cmds, settle=1.5),
                collect_audio(s, url, secs,
                              cmds + [{"cmd": "am_sync",
                                       "enabled": False}], settle=1.5))
            fig = am_figures(decode_audio(pll, 1, int(1.5 * fs))[1],
                             decode_audio(env, 1, int(1.5 * fs))[1], fs,
                             truth["tone_hz"])
            am_bars(fig)
            results["am_h2_h1"] = fig

        elif variant in ("stereo", "both", "soak"):
            assert ch == 2, "server not advertising 2-channel audio"
            cmds = _audio_cmds(info, truth, "WBFM")
            text = None if variant == "stereo" else []
            if text is not None:
                cmds.append({"cmd": "rds", "enabled": True})
            if comp == "opus":
                fs = 48000  # opus decodes at 48 kHz (decimated stereo)
            _, chunks = await collect_audio(
                s, url, secs, cmds, text_frames=text, settle=2.0)
            _, left, right = decode_audio(chunks, 2, int(2.0 * fs), comp)
            sep = stereo_figures(left, right, fs, truth)
            stereo_bars(sep)
            results["stereo_sep_db"] = [round(v, 1) for v in sep]
            if text is not None:
                fig = rds_figures(text)
                rds_bars(fig, truth)
                results["rds"] = _rds_result(fig)

        elif variant == "rds":
            assert info.get("rds_available"), "rds_available false"
            cmds = _audio_cmds(info, truth, "WBFM")
            cmds.append({"cmd": "rds", "enabled": True})
            text = []
            await collect_audio(s, url, secs, cmds, text_frames=text)
            fig = rds_figures(text)
            rds_bars(fig, truth)
            results["rds"] = _rds_result(fig)

        elif variant == "nr":
            assert info.get("nr_available"), "nr_available false"
            cmds = _audio_cmds(info, truth, "AM")
            off, on = await collect_ab_audio(s, url, secs, cmds, fs)
            fig = nr_figures(off, on, fs, truth["tone_hz"])
            nr_bars(fig)
            results["nr"] = {k: round(v, 1) for k, v in fig.items()}

        elif variant == "lms":
            # LMS keeps the STEADY tone and adapts the noise away; the
            # reference's 4x output gain raises both absolute levels,
            # so the judge is the tone/noise RATIO
            assert info.get("nr_available"), "nr_available false"
            cmds = _audio_cmds(info, truth, "AM")
            off, on = await collect_ab_audio(s, url, secs, cmds, fs,
                                             settle=2.5)
            fig = lms_figures(off, on, fs)
            lms_bars(fig)
            results["lms_snr_db"] = {k: round(v, 1) for k, v in fig.items()}

        elif variant == "nb":
            # the count of samples above 4x rms (impulses in the
            # reference's frame-start blind zone survive, NB.c:209)
            assert info.get("nr_available"), "nr_available false"
            rsize = info["fft_result_size"]
            m = (0.5 + truth["f_off_hz"] / truth["sps"]) * rsize
            off_w = int(truth["wide_hz"] * rsize / truth["sps"])
            cmds = [{"cmd": "window", "l": int(m - off_w), "m": m,
                     "r": int(m + off_w)},
                    {"cmd": "demodulation", "demodulation": "AM"}]
            off, on = await collect_ab_audio(s, url, secs, cmds, fs)
            fig = nb_figures(off, on)
            nb_bars(fig)
            results["nb_click_samples"] = fig

        elif variant == "de":
            assert info.get("deemphasis") == truth["tau_us"]
            cmds = _audio_cmds(info, truth, "WBFM")
            _, chunks = await collect_audio(s, url, secs, cmds, settle=2.0)
            _, x, _ = decode_audio(chunks, 1, int(2.0 * fs))
            fig = de_figures(x, fs, truth)
            de_bars(fig)
            results["deemph_ratio"] = {k: round(v, 4)
                                       for k, v in fig.items()}
        else:
            raise SystemExit(f"no client check for variant {variant!r}")
    return {"variant": variant, "pass": True, **results}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    cap = sub.add_parser("capture", help="captures.py's flags")
    cap.add_argument("--variant", required=True, choices=VARIANTS)
    cap.add_argument("--out", required=True)
    cap.add_argument("--port", type=int, default=19020)
    cap.add_argument("--secs", type=float, default=6.0)
    cap.add_argument("--fft-size", type=int, default=0,
                     help="override the variant's fft_size")
    cap.add_argument("--mesh", type=int, default=0,
                     help="emit a [tpu] mesh_devices=N config")
    cap.add_argument("--audio-compression", choices=("flac", "opus"),
                     default="flac")
    cap.add_argument("--wf-compression", choices=("zstd", "av1"),
                     default="zstd")
    cap.add_argument("--cluster", action="store_true",
                     help="also write config_follower.toml (port+1)")
    chk = sub.add_parser("check", help="client.py's flags")
    chk.add_argument("--dir", required=True,
                     help="capture dir made by the capture command")
    chk.add_argument("--secs", type=float, default=8.0)
    chk.add_argument("--port", type=int, default=0,
                     help="override truth.json's port (e.g. a cluster "
                          "follower's)")
    args = ap.parse_args()
    if args.cmd == "capture":
        truth = make(args.variant, Path(args.out), args.port, args.secs,
                     args.fft_size, args.mesh, args.wf_compression,
                     args.audio_compression, args.cluster)
        print(json.dumps(truth))
        return
    truth = json.loads((Path(args.dir) / "truth.json").read_text())
    if args.port:
        truth["port"] = args.port
    print(json.dumps(asyncio.run(check(
        f"http://127.0.0.1:{truth['port']}", truth, args.secs))))


if __name__ == "__main__":
    main()
