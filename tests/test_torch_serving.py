"""The PyTorch port served end to end on CPU: main.build -> DSPDriver ->
SpectrumServer, driven by a websocket client that decodes the FLAC
audio of an AM tone capture (the flow of tools/verify/client.py's tone
check); plus the package's import boundary, its device default and
the config-time validations of the mesh, the waterfall codec and the
WBFM and noise-reduction options."""

import asyncio
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from phantomsdr_tpu_torch.config import config_from_dict
from phantomsdr_tpu_torch.pipeline import HopPipeline
from tests.test_codecs import decode_flac
from tools.verify.client import cbor_decode

REPO = Path(__file__).resolve().parent.parent

SPS, FFT, TONE_HZ = 192000, 4096, 1000.0
F_OFF = 0.15 * SPS                        # AM carrier offset from centre


def tone_config(**extra_input):
    return config_from_dict({
        "server": {"port": 0},
        "input": {"sps": SPS, "frequency": 7_000_000, "fft_size": FFT,
                  "signal": "iq", "audio_sps": 12000, "waterfall_size": 512,
                  "driver": {"format": "s16"}, **extra_input},
        "tpu": {"hop_batch": 8, "max_channels": 16, "channel_bucket": 4},
    })


def am_tone_capture(secs=2.0) -> bytes:
    """s16 IQ: AM carrier at +F_OFF, 50% modulated by a 1 kHz tone."""
    t = np.arange(int(SPS * secs)) / SPS
    iq = 0.35 * (1.0 + 0.5 * np.sin(2 * np.pi * TONE_HZ * t)) * np.exp(
        2j * np.pi * F_OFF * t)
    s = np.empty(2 * iq.size, np.int16)
    s[0::2] = np.round(iq.real * 32000)
    s[1::2] = np.round(iq.imag * 32000)
    return s.tobytes()


async def collect(client, cfg, packets):
    ws = await client.ws_connect("/audio", max_msg_size=1 << 22)
    info = json.loads((await ws.receive(timeout=60)).data)
    rsize = info["fft_result_size"]
    m = (0.5 + F_OFF / SPS) * rsize
    off = 5000 * rsize // SPS
    await ws.send_str(json.dumps({"cmd": "window", "l": int(m - off),
                                  "m": m, "r": int(m + off)}))
    await ws.send_str(json.dumps({"cmd": "demodulation",
                                  "demodulation": "AM"}))
    chunks = []
    while len(chunks) < packets:
        msg = await ws.receive(timeout=60)
        if msg.type.name == "BINARY":
            chunks.append(bytes(cbor_decode(msg.data)["data"]))
    wf = await client.ws_connect("/waterfall", max_msg_size=1 << 22)
    rows = 0
    while rows < 2:
        msg = await wf.receive(timeout=60)
        rows += msg.type.name == "BINARY"
    await wf.close()
    await ws.close()
    return info, chunks


def test_served_am_tone_decodes_at_its_frequency():
    from phantomsdr_tpu_torch.main import build

    cfg = tone_config()
    server, driver = build(cfg, io.BytesIO(am_tone_capture()),
                           loop_file=True, device="cpu")

    async def run():
        client = TestClient(TestServer(server.app))
        await client.start_server()
        driver.start()
        try:
            return await collect(client, cfg, packets=20)
        finally:
            driver.stop()
            await client.close()

    info, chunks = asyncio.run(run())
    assert info["audio_compression"] == "flac"
    assert driver.metrics.device_errors == 0
    sr, samples = decode_flac(b"".join(chunks))
    x = samples.astype(np.float64)[int(0.5 * sr):]   # AGC / PLL settle
    assert len(x) > sr // 2 and np.abs(x).max() > 1000
    spec = np.abs(np.fft.rfft((x - x.mean()) * np.hanning(len(x))))
    f_peak = np.fft.rfftfreq(len(x), 1.0 / sr)[1 + np.argmax(spec[1:])]
    assert abs(f_peak - TONE_HZ) < 20, (f_peak, len(x))


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import phantomsdr_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'phantomsdr_tpu.'))\n"
        "       or m == 'phantomsdr_tpu']\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('phantomsdr_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20      # every module was imported


def test_pipeline_defaults_to_cuda():
    cfg = tone_config()
    if torch.cuda.is_available():
        assert HopPipeline(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HopPipeline(cfg)
    assert HopPipeline(cfg, device="cpu").device.type == "cpu"


WIDEBAND = {"sps": 20_000_000, "fft_size": 1 << 20, "audio_sps": 192000,
            "driver": {"format": "u8"}}


@pytest.mark.parametrize("extra,what", [
    # the JAX package's validations of the WBFM options
    pytest.param({"stereo": True}, "stereo=true needs audio_sps",
                 id="extra0-stereo"),
    pytest.param({"nr": True, "nr_algo": "bogus"},
                 "nr_algo must be spectral/lms/notch/nb", id="extra1-nr"),
    # the wideband profile's audio block (5,034) allows only /2: 96 kS/s
    # of RDS baseband, over MAX_BASEBAND_SPS
    pytest.param({**WIDEBAND, "rds": True}, "rds=true.*decimation by 2",
                 id="extra2-rds"),
    pytest.param({"deemphasis": 2000}, "deemphasis must be 0..1000",
                 id="extra3-deemphasis"),
    # no integer decimation reaches a legal Opus rate
    pytest.param({"audio_compression": "opus", "audio_sps": 44100},
                 "cannot feed Opus", id="extra4-Opus decimation"),
    # AV1 is served; a codec name that is neither zstd nor av1 is not
    pytest.param({"waterfall_compression": "av2"},
                 "waterfall_compression must be zstd or av1",
                 id="extra5-av1"),
    pytest.param({"nr": True, "stereo": True, "audio_sps": 192000},
                 "cannot be combined", id="extra6-nr+stereo"),
    pytest.param({"nr": True, "nr_algo": "nb", "nb_samples": 1},
                 r"nb_samples must be in \[3, 201\]",
                 id="extra7-nb_samples"),
    pytest.param({"nr": True, "nr_algo": "nb", "nb_taps": 41},
                 r"nb_taps must be in \[1, 40\]", id="extra8-nb_taps"),
])
def test_unported_stages_are_rejected_at_config_time(extra, what):
    """Invalid settings of the WBFM and noise-reduction options and of
    the waterfall codec are refused when the config loads."""
    with pytest.raises(ValueError, match=what):
        tone_config(**extra)


@pytest.mark.parametrize("profile", ["wideband", "soak"])
def test_wbfm_profiles_load(profile):
    """The wideband profile with stereo, de-emphasis and Opus (device
    decimation /4), and the tools/verify soak profile with stereo, RDS
    and de-emphasis."""
    if profile == "wideband":
        cfg = tone_config(**WIDEBAND, stereo=True, deemphasis=75,
                          audio_compression="opus")
        assert cfg.device_decim and cfg.opus_decim == 4
        assert cfg.audio_fft_size == 10068
    else:
        cfg = tone_config(sps=1_536_000, fft_size=131072, audio_sps=192000,
                          stereo=True, rds=True, deemphasis=75)
        assert cfg.audio_fft_size == 16384
    assert cfg.audio_channels == 2


@pytest.mark.parametrize("hop_batch", [138, 139])
def test_agc_step_past_shared_memory_is_rejected_at_config_time(hop_batch):
    """K-AGC keeps its window max in shared memory, so a step too long
    for it is refused when the config loads: the wideband profile (192
    kHz audio, W = 38,400, 5,034 samples a hop) loads at hop_batch 138
    (694,692 samples a step) and is refused at 139 (699,726 > 698,369)."""
    from phantomsdr_tpu_torch.ops.cuda.agc import max_stream

    assert max_stream(38400) == 698369
    t = {"input": {**WIDEBAND, "frequency": 100_000_000, "signal": "iq"},
         "tpu": {"hop_batch": hop_batch}}
    if hop_batch == 138:
        assert config_from_dict(t).audio_fft_size == 10068
    else:
        with pytest.raises(ValueError, match="hop_batch=139.*at most 698369"):
            config_from_dict(t)


def test_mesh_mode_is_rejected_at_config_time():
    """Mesh mode loads; a mesh that does not divide the step's hops or
    the channel table is refused when the config loads."""
    cfg = config_from_dict({"input": {"sps": SPS, "fft_size": FFT},
                            "tpu": {"mesh_devices": 4}})
    assert cfg.mesh_devices == 4
    for tpu in ({"hop_batch": 6}, {"max_channels": 30}):
        with pytest.raises(ValueError, match="mesh_devices=4.*divide"):
            config_from_dict({"input": {"sps": SPS, "fft_size": FFT},
                              "tpu": {"mesh_devices": 4, **tpu}})


def test_driver_delivers_wbfm_layout_and_rds():
    """DSPDriver at a small WBFM config (stereo + RDS + de-emphasis +
    Opus decimation) hands the consumer each step's decimated,
    interleaved audio [C, 2*B*half/4] and the RDS block [C, 2, rds_t],
    zero for a listener without the opt-in."""
    from phantomsdr_tpu_torch.runtime.driver import DSPDriver, SampleSource
    from phantomsdr_tpu_torch.runtime.registry import ChannelRegistry

    cfg = config_from_dict({
        "input": {"sps": 1_536_000, "frequency": 98_000_000,
                  "fft_size": 8192, "signal": "iq", "audio_sps": 192000,
                  "stereo": True, "rds": True, "deemphasis": 75,
                  "audio_compression": "opus", "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 16, "max_channels": 2, "channel_bucket": 0}})
    blocks = 2
    raw = np.random.default_rng(5).integers(
        -3000, 3000, blocks * cfg.hop_batch * cfg.hop_size * 2,
        dtype=np.int16).tobytes()
    channels = ChannelRegistry(cfg)
    mid, half = cfg.fft_result_size // 2, cfg.audio_fft_size // 2
    for i, rds in enumerate((True, False)):
        slot = channels.acquire(f"l{i}")
        channels.retune(slot, mid - half // 2, float(mid), mid + half // 2)
        channels.set_mode(slot, "FM")
        channels.set_rds(slot, rds)
    got = []
    driver = DSPDriver(cfg, SampleSource(cfg, io.BytesIO(raw)), channels,
                       lambda *a: got.append(a),
                       waterfall_active=lambda: False, device="cpu")
    driver.start()
    t0 = time.monotonic()
    while len(got) < blocks and time.monotonic() - t0 < 120:
        time.sleep(0.1)
    driver.stop()
    assert len(got) == blocks and driver.metrics.device_errors == 0
    for (frame0, audio, pwr, wf, due, wf_meta, audio_meta, rds) in got:
        assert audio.shape == (2, 2 * cfg.hop_batch * half // 4)
        assert rds.shape == (2, 2, driver.pipe.rds_t) and not rds[1].any()
        assert wf is None and np.isfinite(pwr).all()


def test_encode_pool_bounds_a_jobs_wait_not_the_queue(monkeypatch):
    """A burst of many steps' jobs is encoded, none dropped (the JAX
    package's 256-job queue would shed most of this one); a data job that
    waited past MAX_LAG_S behind a stalled worker is dropped, a control
    op never; order on one worker is kept."""
    import threading

    from phantomsdr_tpu_torch.runtime.server import EncodePool

    pool = EncodePool(2)
    try:
        ran, done = [], threading.Event()
        for i in range(1000):
            pool.submit(i % 2, lambda i=i: ran.append(i))
        pool.submit_control(0, done.set)
        pool.submit_control(1, lambda: None)
        assert done.wait(10)
        deadline = time.monotonic() + 10
        while len(ran) < 1000 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool.dropped == 0 and sorted(ran) == list(range(1000))
        assert [i for i in ran if i % 2 == 0] == list(range(0, 1000, 2))

        monkeypatch.setattr(EncodePool, "MAX_LAG_S", 0.05)
        late, ctl = [], threading.Event()
        pool.submit(0, lambda: time.sleep(0.3))      # the stall
        for i in range(5):
            pool.submit(0, lambda i=i: late.append(i))
        pool.submit_control(0, ctl.set)
        pool.submit(1, lambda: late.append("other worker"))
        assert ctl.wait(10)
        time.sleep(0.05)
        assert late == ["other worker"] and pool.dropped == 5
        assert pool.depth == 0
    finally:
        pool.stop()
