"""The PyTorch port served end to end on CPU: main.build -> DSPDriver ->
SpectrumServer, driven by a websocket client that decodes the FLAC
audio of an AM tone capture (the flow of tools/verify/client.py's tone
check); plus the package's import boundary, its device default and the
config-time rejection of the stages it does not implement yet."""

import asyncio
import io
import json
import subprocess
import sys
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


@pytest.mark.parametrize("extra,what", [
    ({"stereo": True, "audio_sps": 192000}, "stereo"),
    ({"nr": True}, "nr"),
    ({"rds": True, "audio_sps": 192000}, "rds"),
    ({"deemphasis": 75}, "deemphasis"),
    ({"audio_compression": "opus", "audio_sps": 96000}, "Opus decimation"),
    ({"waterfall_compression": "av1"}, "av1"),
])
def test_unported_stages_are_rejected_at_config_time(extra, what):
    with pytest.raises(ValueError, match=what):
        tone_config(**extra)


def test_mesh_mode_is_rejected_at_config_time():
    with pytest.raises(ValueError, match="mesh_devices"):
        config_from_dict({"input": {"sps": SPS, "fft_size": FFT},
                          "tpu": {"mesh_devices": 4}})
