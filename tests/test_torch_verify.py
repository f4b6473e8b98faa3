"""tools/torch_verify.py against tools/verify/ (captures.py, client.py).

- The captures: for every variant, torch_verify.make writes a
  capture.s16, config.toml and truth.json byte-equal to captures.make's
  (the ``soak`` case forces 10 s of a 1.536 MSPS capture, ~10 s here).
- The decoders: the port's FLAC (mono, stereo) and Opus streams decode
  as client.decode_audio decodes them, bit for bit.
- The judges: each variant's figures against their closed forms on
  sinusoids, text frames a pass and just past each bar a miss with
  client.py's message.
- The check against a live server: the port's CLI on the CPU serving
  the tool's ``tone`` and ``am`` captures, judged by ``check`` through
  its command line, both at once (~25 s here, longer on a busy CPU).
- The import guard: the tool runs with JAX, the JAX package, tests/ and
  tools/verify unimportable.
"""

import asyncio
import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import torch_verify as tv  # noqa: E402


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


captures = _load("verify_captures", "tools/verify/captures.py")
client = _load("verify_client", "tools/verify/client.py")

FILES = ("capture.s16", "config.toml", "truth.json")


# --------------------------------------------------------------- captures

def _captures_cli(variant, out, port, secs, audio_compression="flac",
                  mesh=0, wf_compression="zstd", cluster=False):
    """What ``captures.py`` writes for these flags (its main())."""
    truth = captures.make(variant, out, port, secs, 0, mesh,
                          wf_compression, audio_compression)
    if cluster:
        cfg = (out / "config.toml").read_text()
        (out / "config_follower.toml").write_text(
            cfg.replace(f"port = {port}", f"port = {port + 1}"))
        truth["follower_port"] = port + 1
    (out / "truth.json").write_text(json.dumps(truth))


@pytest.mark.parametrize("variant,kw", [
    *[pytest.param(v, {}, id=v) for v in tv.VARIANTS],
    pytest.param("both", {"audio_compression": "opus"}, id="both-opus"),
    pytest.param("rds", {"mesh": 4, "wf_compression": "av1",
                         "cluster": True}, id="rds-mesh-av1-cluster"),
])
def test_capture_equals_captures_py(variant, kw, tmp_path):
    ref, got = tmp_path / "ref", tmp_path / "got"
    _captures_cli(variant, ref, 19999, 0.5, **kw)
    tv.make(variant, got, 19999, 0.5, **kw)
    names = FILES + (("config_follower.toml",) if kw.get("cluster")
                     else ())
    for name in names:
        a, b = (ref / name).read_bytes(), (got / name).read_bytes()
        assert a == b, (name, len(a), len(b))
    assert sorted(p.name for p in ref.iterdir()) == \
        sorted(p.name for p in got.iterdir())


@pytest.mark.parametrize("variant", ["am", "nr", "lms", "nb", "de"])
def test_capture_refuses_opus_where_client_decodes_flac(variant,
                                                        tmp_path):
    with pytest.raises(SystemExit) as want:
        captures.make(variant, tmp_path, 1, 0.1, audio_compression="opus")
    with pytest.raises(SystemExit) as got:
        tv.make(variant, tmp_path, 1, 0.1, audio_compression="opus")
    assert str(got.value) == str(want.value)


def test_rds_synth_equals_test_rds():
    from tests import test_rds

    n = 48_000
    assert tv._group_bits() == test_rds._group_bits()
    np.testing.assert_array_equal(tv._mpx(n), test_rds._mpx(n))


# --------------------------------------------------------------- decoders

def _flac_chunks(x: np.ndarray, rate: int, channels: int) -> list[bytes]:
    from phantomsdr_tpu_torch.runtime.codecs import FlacEncoder

    enc = FlacEncoder(rate, channels=channels)
    try:
        step = 1536 * channels
        chunks = [enc.process(x[i:i + step]) for i in range(0, x.size, step)]
        chunks.append(enc.finish())
    finally:
        enc.close()
    return chunks


def _pcm(n: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 12_000
    tone = 9000 * np.sin(2 * np.pi * 700 * t)
    x = np.stack([tone + rng.normal(0, 300 * (c + 1), n)
                  for c in range(channels)], 1)
    return np.clip(np.rint(x), -32768, 32767).astype(np.int16).reshape(-1)


@pytest.mark.parametrize("channels", [1, 2])
def test_flac_decode_equals_client(channels):
    chunks = _flac_chunks(_pcm(20_000, channels, channels), 12_000,
                          channels)
    want = client.decode_audio(chunks, channels, trim=300)
    got = tv.decode_audio(chunks, channels, trim=300)
    assert got[0] == want[0] == 12_000
    for a, b in zip(got[1:], want[1:]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert len(got[1]) == 20_000 - 300


@pytest.mark.parametrize("channels", [1, 2])
def test_opus_decode_equals_client(channels):
    """The same libopus decodes both (tolerance: equal)."""
    from phantomsdr_tpu_torch.runtime.codecs import OpusChunkEncoder

    try:
        enc = OpusChunkEncoder(48_000, channels)
    except OSError as e:
        pytest.skip(f"libopus is not loadable here: {e}")
    try:
        chunks = enc.process(_pcm(48_000, channels, 5))
    finally:
        enc.close()
    assert len(chunks) > 40
    want = client.decode_audio(chunks, channels, 480, "opus")
    got = tv.decode_audio(chunks, channels, 480, "opus")
    assert got[0] == want[0] == 48_000
    for a, b in zip(got[1:], want[1:]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- judges

def _tones(fs: float, secs: float, *parts) -> np.ndarray:
    """Sum of amplitude * sin(2 pi f t) for each (amplitude, f)."""
    t = np.arange(int(fs * secs)) / fs
    return sum(a * np.sin(2 * np.pi * f * t) for a, f in parts)


@pytest.mark.parametrize("r_pll,r_env,msg", [
    (0.05, 0.3, None),
    (0.101, 0.3, "PLL ear folds: H2/H1=0.101"),
    (0.05, 0.249, "envelope ear did not fold: H2/H1=0.249"),
])
def test_am_judge(r_pll, r_env, msg):
    fs = 12_000
    pll = _tones(fs, 4, (0.4, 1000), (0.4 * r_pll, 2000)) + 0.1
    env = _tones(fs, 4, (0.4, 1000), (0.4 * r_env, 2000)) - 0.2
    fig = tv.am_figures(pll, env, fs, 1000.0)
    assert fig == {"pll": r_pll, "envelope": r_env}
    if msg is None:
        tv.am_bars(fig)
    else:
        with pytest.raises(AssertionError, match=re.escape(msg)):
            tv.am_bars(fig)


@pytest.mark.parametrize("sep_l,sep_r,ok", [
    (21.0, 25.0, True), (19.9, 25.0, False), (25.0, 19.9, False)])
def test_stereo_judge(sep_l, sep_r, ok):
    fs, truth = 192_000, {"left_hz": 800.0, "right_hz": 1300.0}
    c_l, c_r = 10 ** (-sep_l / 20), 10 ** (-sep_r / 20)
    left = _tones(fs, 2, (0.3, 800), (0.3 * c_r, 1300))
    right = _tones(fs, 2, (0.3 * c_l, 800), (0.3, 1300))
    sep = tv.stereo_figures(left, right, fs, truth)
    assert sep == pytest.approx([sep_l, sep_r], abs=1e-3)
    if ok:
        tv.stereo_bars(sep)
    else:
        with pytest.raises(AssertionError, match=re.escape(
                f"separation L={sep_l:.1f} R={sep_r:.1f} dB")):
            tv.stereo_bars(sep)


RDS_TRUTH = {"pi": f"{tv.PI:04X}", "ps": tv.PS, "rt": tv.RT}
UNSYNCED = {"type": "rds", "synced": False, "pi": None, "ps": "", "rt": ""}
PART = {"type": "rds", "synced": True, "pi": "54A7", "ps": "PHAN    ",
        "rt": "TPU SPECTRUM"}
FULL = {"type": "rds", "synced": True, **RDS_TRUTH}


@pytest.mark.parametrize("frames,msg", [
    ([UNSYNCED, PART, FULL], None),
    ([UNSYNCED, PART, FULL, UNSYNCED], None),   # judged on the last synced
    ([], "no rds text frames"),
    ([UNSYNCED, UNSYNCED], "rds never synced"),
    ([UNSYNCED, {**FULL, "pi": "54A6"}], "PI 54A6"),
    ([FULL, PART], "PS 'PHAN    '"),
    ([{**FULL, "rt": tv.RT[:-1]}], f"RT {tv.RT[:-1]!r}"),
])
def test_rds_judge(frames, msg):
    fig = tv.rds_figures(frames)
    assert fig["frames"] == len(frames)
    assert fig["synced"] == sum(bool(f.get("synced")) for f in frames)
    if msg is None:
        tv.rds_bars(fig, RDS_TRUTH)
        assert (fig["pi"], fig["ps"], fig["rt"]) == (
            RDS_TRUTH["pi"], tv.PS, tv.RT)
    else:
        with pytest.raises(AssertionError, match=re.escape(msg)):
            tv.rds_bars(fig, RDS_TRUTH)


@pytest.mark.parametrize("drop,delta,msg", [
    (5.0, -1.0, None),
    (3.9, -1.0, "floor only dropped 3.9 dB"),
    (5.0, -6.1, "tone lost -6.1 dB"),
])
def test_nr_judge(drop, delta, msg):
    """Floor: a 3 kHz sine (750 cycles in each quarter second, so each
    window's RMS is amplitude / sqrt 2); tone: 1 kHz gated 1 s on/off."""
    fs, secs = 12_000, 8
    gate = (np.arange(fs * secs) / fs % 2.0) < 1.0

    def audio(tone, floor):
        return gate * _tones(fs, secs, (tone, 1000)) + _tones(
            fs, secs, (floor, 3000))

    off = audio(0.4, 0.05)
    on = audio(0.4 * 10 ** (delta / 20), 0.05 * 10 ** (-drop / 20))
    fig = tv.nr_figures(off, on, fs, 1000.0)
    assert fig == pytest.approx({"floor_drop_db": drop,
                                 "tone_delta_db": delta}, abs=1e-3)
    if msg is None:
        tv.nr_bars(fig)
    else:
        with pytest.raises(AssertionError, match=re.escape(msg)):
            tv.nr_bars(fig)


@pytest.mark.parametrize("gain,ok", [(7.0, True), (5.9, False)])
def test_lms_judge(gain, ok):
    """Tone 1 kHz over a 2 kHz 'noise' sine: the noise band's mean bin
    is (by Parseval, Hann sum of squares 3N/8) 3 b^2 N^2 / (32 M) over
    its M bins and the tone's peak (a N / 4)^2, so the SNR is
    10 log10(2 M a^2 / (3 b^2))."""
    fs, secs, a, b_off = 12_000, 8, 0.3, 0.02
    freqs = np.fft.rfftfreq(fs * secs, 1.0 / fs)
    sig = (freqs > 970) & (freqs < 1030)
    m = int(np.sum((freqs > 200) & (freqs < 4500) & ~sig))
    b_on = b_off * 10 ** (-gain / 20)
    fig = tv.lms_figures(_tones(fs, secs, (a, 1000), (b_off, 2000)),
                         _tones(fs, secs, (a, 1000), (b_on, 2000)), fs)
    for name, b in (("off", b_off), ("on", b_on)):
        want = 10 * np.log10(2 * m * a ** 2 / (3 * b ** 2))
        assert fig[name] == pytest.approx(want, abs=0.01)
    assert fig["on"] - fig["off"] == pytest.approx(gain, abs=1e-3)
    if ok:
        tv.lms_bars(fig)
    else:
        with pytest.raises(AssertionError, match=re.escape(
                f"LMS SNR gain only {gain:.1f} dB")):
            tv.lms_bars(fig)


@pytest.mark.parametrize("n_off,n_on,msg", [
    (40, 23, None),
    (40, 24, "NB removed too little: 40 -> 24"),
    (20, 5, "clicks not visible pre-NB (20)"),
])
def test_nb_judge(n_off, n_on, msg):
    """Unit clicks on a 0.05 sine: 4x the RMS lies between the two, so
    the count is the clicks'."""
    def audio(k):
        x = _tones(19_200, 1, (0.05, 1000))
        x[np.arange(k) * 400 + 7] = 1.0
        return x

    fig = tv.nb_figures(audio(n_off), audio(n_on))
    assert fig == {"off": n_off, "on": n_on}
    if msg is None:
        tv.nb_bars(fig)
    else:
        with pytest.raises(AssertionError, match=re.escape(msg)):
            tv.nb_bars(fig)


@pytest.mark.parametrize("rel,ok", [(1.10, True), (0.90, True),
                                    (1.16, False), (0.84, False)])
def test_de_judge(rel, ok):
    fs = 192_000
    truth = {"tone_lo_hz": 1000.0, "tone_hi_hz": 10_000.0, "tau_us": 75.0}
    w = 2 * np.pi * 75e-6
    theory = np.sqrt((1 + (w * 1000) ** 2) / (1 + (w * 10_000) ** 2))
    fig = tv.de_figures(_tones(fs, 2, (0.3, 1000), (0.3 * theory * rel,
                                                    10_000)) + 0.1,
                        fs, truth)
    assert fig["theory"] == pytest.approx(theory, rel=1e-12)
    assert fig["got"] == pytest.approx(theory * rel, rel=1e-4)
    if ok:
        tv.de_bars(fig)
    else:
        with pytest.raises(AssertionError, match=re.escape(
                f"10k/1k ratio {fig['got']:.4f}, theory {theory:.4f}")):
            tv.de_bars(fig)


def test_tone_power_equals_client():
    x = _tones(12_000, 2, (0.3, 1000), (0.01, 2000))
    for f in (1000.0, 2000.0, 3000.0):
        assert tv.tone_power(x, 12_000, f) == client.tone_power(
            x, 12_000, f)


def test_every_variant_has_bars():
    assert set(tv.BARS) == set(tv.VARIANTS)


# ------------------------------------------------------------ live check

LIVE = {"tone": 1.0, "am": 1.5}     # variant: its check's settle trim, s


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serving(url: str, srv, log_path: Path) -> None:
    deadline = time.monotonic() + 90
    while True:
        try:
            with urllib.request.urlopen(url + "/metrics", timeout=2) as r:
                if json.loads(r.read())["frames"] > 0:
                    return
        except OSError:
            pass
        assert srv.poll() is None and time.monotonic() < deadline, \
            log_path.read_text()[-3000:]
        time.sleep(0.2)


async def _audio_per_wall_second(url: str, truth: dict) -> float:
    """Seconds of audio one AM listener gets a second of wall time: the
    CPU server's plain versions run slower than real time, and slower
    still beside other work."""
    import aiohttp

    from tools.torch_clients import collect_audio

    async with aiohttp.ClientSession() as s:
        info, _ = await collect_audio(s, url, 0.1)
        t0 = time.monotonic()
        _, chunks = await collect_audio(
            s, url, 3.0, tv._audio_cmds(info, truth, "AM"))
        wall = time.monotonic() - t0
    return len(tv.decode_audio(chunks, 1)[1]) / info["audio_max_sps"] / wall


def test_check_against_the_cpu_cli(tmp_path):
    """``check`` against ``python -m phantomsdr_tpu_torch --device cpu``
    serving the tool's captures, tone and am side by side: each
    variant's windows, settle trims and commands (tone through
    torch_clients.tone_check; am's PLL and envelope listeners together),
    client.py's bars on what the wire carried, and its JSON line.
    client.py's default 32,768-point FFT: at 8,192 points the envelope
    ear does not fold in either package.  Each --secs is sized from its
    server's measured pace so that some 2 s of audio are left past the
    check's settle trim (4 s at least)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    runs = {}
    try:
        for variant in LIVE:
            out = tmp_path / variant
            port = _free_port()
            truth = tv.make(variant, out, port, 1.0)
            log = open(out / "server.log", "w")
            srv = subprocess.Popen(
                [sys.executable, "-m", "phantomsdr_tpu_torch", "-c",
                 str(out / "config.toml"), "--input-file",
                 str(out / "capture.s16"), "--loop", "--throttle",
                 "--device", "cpu"], stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, cwd=REPO, env=env)
            runs[variant] = (f"http://127.0.0.1:{port}", truth, srv, log)
        for variant, (url, _, srv, _) in runs.items():
            _serving(url, srv, tmp_path / variant / "server.log")

        async def paces():
            return await asyncio.gather(*(
                _audio_per_wall_second(url, truth)
                for url, truth, _, _ in runs.values()))

        secs = {v: max(4.0, 1.5 * (LIVE[v] + 1.0) / max(p, 0.05) - LIVE[v])
                for v, p in zip(runs, asyncio.run(paces()))}
        checks = {v: subprocess.Popen(
            [sys.executable, "tools/torch_verify.py", "check", "--dir",
             str(tmp_path / v), "--secs", f"{secs[v]:.1f}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env) for v in runs}
        res = {v: (c.communicate(timeout=secs[v] + 120), c.returncode)
               for v, c in checks.items()}
    finally:
        for _, _, srv, log in runs.values():
            srv.terminate()
            try:
                srv.wait(timeout=20)
            except subprocess.TimeoutExpired:
                srv.kill()
                srv.wait()
            log.close()
    for v, ((stdout, stderr), rc) in res.items():
        assert rc == 0, (f"{v}: --secs {secs[v]:.1f}\n" + stdout[-2000:]
                         + stderr[-3000:])
        out = json.loads(stdout.strip().splitlines()[-1])
        assert out["variant"] == v and out["pass"] is True
    tone, am = (json.loads(res[v][0][0].strip().splitlines()[-1])
                for v in ("tone", "am"))
    assert abs(tone["tone"]["f_peak_hz"] - runs["tone"][1]["tone_hz"]) < 20
    assert tone["waterfall"]["peak_ok"] >= 1 and tone["events"]["keys"]
    assert am["am_h2_h1"]["pll"] < 0.1 and am["am_h2_h1"]["envelope"] > 0.25


# ----------------------------------------------------------- import guard

def test_imports_neither_jax_nor_tests_nor_client(tmp_path):
    """The tool's capture and decode paths with JAX, the JAX package,
    tests/ and tools/verify unimportable (a finder that refuses them)."""
    code = f"""
import sys
BLOCKED = ("jax", "jaxlib", "phantomsdr_tpu", "tests", "tools.verify")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name in BLOCKED or name.startswith(tuple(b + "." for b in BLOCKED)):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
import numpy as np
from tools import torch_verify as tv
from phantomsdr_tpu_torch.runtime.codecs import FlacEncoder
truth = tv.make("both", Path({str(tmp_path)!r}), 1, 0.2)
assert truth["pi"] == "54A7"
enc = FlacEncoder(12000)
x = (np.arange(8192) % 64 * 100).astype(np.int16)
sr, y, _ = tv.decode_audio([enc.process(x), enc.finish()], 1)
assert sr == 12000 and np.array_equal(np.rint(y * 32768), x)
bad = [m for m in sys.modules if m in BLOCKED
       or m.startswith(tuple(b + "." for b in BLOCKED))]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
