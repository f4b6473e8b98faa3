"""The real-input (RX888-class) path of the PyTorch port against the JAX
package, on the CPU.

- Config: ``configs/config.example.rx888.toml`` and bench.py's two
  profile dicts derive the same values in both packages (R, base_idx,
  basefreq, the default mode and window, the pyramid levels, skip_num,
  view_cap, the audio IFFT size A).
- HopPipeline: the port against the JAX one at a small rx888-shaped
  config, the TOML's sizes over 128 (s16 real at 546,875 S/s, FFT 8192,
  waterfall 16: the same 66.76 Hz a bin, A = 180, skip_num 12 and 9
  pyramid levels), hop_batch 12, 16 channels cycling the modes with
  am_sync on and one AM listener on the envelope, views at mixed
  levels; WARM_STEPS + 2 chained steps in 'views' and in 'off'.
- DSPDriver: the port's against the JAX one on one s16 real byte stream
  and one listener table.
- The CLI: ``python -m phantomsdr_tpu_torch --device cpu`` on a copy of
  the rx888 TOML with only its sizes cut -- sps 70,000,000 -> 546,875,
  fft_size 1,048,576 -> 8192, waterfall_size 2048 -> 16, the default
  frequency 7,100,000 -> 55,469 Hz (all / 128), max_channels 128 -> 16
  -- and a free port, reading a real AM tone capture from stdin: the
  tone through ``tools/torch_clients.tone_check`` (tuned by
  ``hz_to_bin``), the waterfall peak on the carrier's bin, basic_info
  against the JAX server's.
- ``hz_to_bin``: today's bins for IQ, f * 2R / sps for real input.

Tolerances (tests/test_torch_pipeline.py's): int16 audio within 4 LSB,
channel power rtol 2e-4, the waterfall at most one int8 step on < 0.1%
of bins.
"""

import asyncio
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import tomllib
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.config import (
    config_from_dict as jconfig, load_config as jload_config,
)
from phantomsdr_tpu.pipeline import (
    HopPipeline as JPipeline, WaterfallViews as JViews,
    channels_from_numpy as jtable,
)
from phantomsdr_tpu.runtime import driver as jdriver
from phantomsdr_tpu.runtime import registry as jregistry
from phantomsdr_tpu.runtime.server import SpectrumServer as JServer

from phantomsdr_tpu_torch.bench import PROFILE_CFG
from phantomsdr_tpu_torch.config import config_from_dict, load_config
from phantomsdr_tpu_torch.ops.quantize import pyramid_level_offsets
from phantomsdr_tpu_torch.pipeline import (
    HopPipeline, WaterfallViews, channels_from_numpy,
)
from phantomsdr_tpu_torch.runtime import driver as tdriver
from phantomsdr_tpu_torch.runtime import registry as tregistry
from tests.test_torch_pipeline import WARM_STEPS, Stream, compare

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import torch_clients  # noqa: E402

RX888 = REPO / "configs" / "config.example.rx888.toml"
CUT = 128                   # the rx888 TOML's sizes over this
DERIVED = ("fft_result_size", "base_idx", "basefreq", "total_bandwidth",
           "default_mode", "default_l", "default_m", "default_r",
           "default_frequency", "downsample_levels", "skip_num",
           "view_cap", "audio_fft_size", "hop_size")


def small_real_dict():
    """The rx888 TOML with its sizes cut (module docstring)."""
    t = tomllib.loads(RX888.read_text())
    inp = t["input"]
    inp["sps"] //= CUT
    inp["fft_size"] //= CUT
    inp["waterfall_size"] //= CUT
    inp["defaults"]["frequency"] = round(inp["defaults"]["frequency"] / CUT)
    t["tpu"]["max_channels"] //= 8
    return t


@pytest.mark.parametrize("which", ["rx888", "bench real", "bench iq",
                                   "rx888 cut"])
def test_config_derives_like_jax(which):
    if which == "rx888":
        jc, tc = jload_config(str(RX888)), load_config(str(RX888))
    elif which == "rx888 cut":
        jc, tc = jconfig(small_real_dict()), config_from_dict(
            small_real_dict())
    else:
        d = PROFILE_CFG[which.split()[1]]
        jc, tc = jconfig(d), config_from_dict(d)
    for name in DERIVED:
        assert getattr(tc, name) == getattr(jc, name), name
    if which == "rx888":
        assert (tc.fft_result_size, tc.base_idx, tc.basefreq) == (
            524288, 0, 0)
        assert (tc.default_mode, tc.default_l, tc.default_r) == (
            "LSB", 106333, 106355)
        assert (tc.downsample_levels, tc.skip_num, tc.audio_fft_size) == (
            9, 12, 180)
    if which == "rx888 cut":
        assert (tc.downsample_levels, tc.skip_num, tc.audio_fft_size) == (
            9, 12, 180)
        assert tc.sps / tc.fft_size == 70_000_000 / (1 << 20)
    if which == "bench real":
        assert (tc.downsample_levels, tc.skip_num, tc.hop_batch) == (
            10, 12, 96)


# ------------------------------------------------------------ HopPipeline

def table_arrays(cfg):
    """16 channels cycling USB/LSB/AM/FM over the band, all active, the
    AM listener of row 6 on the envelope (am_sync off)."""
    c, r = cfg.max_channels, cfg.fft_result_size
    l = np.linspace(10, r - 200, c).astype(np.int32)
    am_env = np.zeros(c, bool)
    am_env[6] = True
    return dict(l=l, r=l + 90, m_idx=l + 45, mode=np.arange(c) % 4,
                active=np.ones(c, bool), am_env=am_env)


def view_arrays(cfg):
    offs = pyramid_level_offsets(cfg.fft_result_size, cfg.downsample_levels)
    lev = cfg.downsample_levels
    start = np.array([offs[0] + 100, offs[1] + 5, offs[3] + 7,
                      offs[lev - 1], offs[0]], np.int32)
    length = np.array([16, 16, 12, cfg.waterfall_size, 0], np.int32)
    return start, length


@pytest.fixture(scope="module")
def real_pair():
    jc, tc = jconfig(small_real_dict()), config_from_dict(small_real_dict())
    start, length = view_arrays(tc)
    arrays = table_arrays(tc)
    return SimpleNamespace(
        jc=jc, tc=tc, jp=JPipeline(jc), tp=HopPipeline(tc, device="cpu"),
        jviews=JViews(start=jnp.asarray(start), length=jnp.asarray(length)),
        tviews=WaterfallViews(start=torch.from_numpy(start),
                              length=torch.from_numpy(length)),
        jt=jtable(**arrays), tt=channels_from_numpy(**arrays))


@pytest.mark.parametrize("mode", ["views", "off"])
def test_hop_pipeline_matches_jax(real_pair, mode):
    p = real_pair
    assert p.tt.need_pll and p.tp.wire_per_hop == p.tc.hop_size
    stream = Stream(p.jc, seed=11)
    js, ts = p.jp.init_state(), p.tp.init_state()
    peak = 0
    for _ in range(WARM_STEPS + 2):
        raw = stream.next()
        frame0 = int(js.frame)
        due = p.jp.default_due_idx(frame0)
        js, jo = p.jp.step(js, jnp.asarray(raw), p.jt, p.jviews, mode,
                           due_idx=due)
        ts, to = p.tp.step(ts, torch.from_numpy(raw), p.tt, p.tviews, mode,
                           due_idx=torch.from_numpy(np.array(due)))
        assert ts.frame == int(js.frame)
        peak = max(peak, compare(jo, to, mode))
        if mode == "views":
            assert to.wf.shape == (1, 5, p.tc.view_cap)
            assert (to.wf[:, :4] != 0).any()
    assert peak > 1000                      # past the AGC's look-ahead


# --------------------------------------------------------------- DSPDriver

LISTENERS = [("USB", 1500, 1500.0, 1544, True), ("LSB", 2000, 2044.5, 2044,
                                                  True),
             ("AM", 2600, 2674.0, 2748, True), ("AM", 2600, 2674.0, 2748,
                                                False),
             ("FM", 3300, 3374.0, 3448, True)]


def run_driver(pkg_driver, pkg_registry, cfg, data: bytes, nblocks: int,
               **kw):
    """Each batch (frame0, audio, pwr, wf, due) of ``pkg_driver``'s
    DSPDriver over ``data`` with LISTENERS and one waterfall client on
    the USB listener's bins at full resolution."""
    src = pkg_driver.SampleSource(cfg, io.BytesIO(data))
    channels = pkg_registry.ChannelRegistry(cfg)
    offs = pyramid_level_offsets(cfg.fft_result_size, cfg.downsample_levels)
    wfr = pkg_registry.WaterfallRegistry(cfg, offs, max_slots=4)
    for i, (mode, l, m, r, sync) in enumerate(LISTENERS):
        slot = channels.acquire(f"l{i}")
        channels.retune(slot, l, m, r)
        channels.set_mode(slot, mode)
        channels.set_am_sync(slot, sync)
    cid, ws = wfr.acquire()
    wfr.retune(cid, ws, 1500, 1500 + cfg.waterfall_size)
    got, done = [], threading.Event()

    def consumer(frame0, audio, pwr, wf, due, wf_meta, audio_meta,
                 rds=None):
        got.append((frame0, audio.copy(), pwr.copy(),
                    None if wf is None else wf.copy(), list(due)))
        if len(got) >= nblocks:
            done.set()

    drv = pkg_driver.DSPDriver(cfg, src, channels, consumer,
                               waterfall_registry=wfr, **kw)
    drv.start()
    ok = done.wait(timeout=150)
    drv.stop()
    assert ok, f"{pkg_driver.__name__}: {len(got)} of {nblocks} batches"
    assert drv.metrics.device_errors == 0, drv.metrics.last_device_error
    return got


def test_driver_matches_jax_on_real_input():
    nblocks = WARM_STEPS + 2
    jc, tc = jconfig(small_real_dict()), config_from_dict(small_real_dict())
    stream = Stream(tc, seed=5)
    data = np.concatenate([stream.next()[tc.hop_size:]
                           for _ in range(nblocks)]).tobytes()
    want = run_driver(jdriver, jregistry, jc, data, nblocks)
    got = run_driver(tdriver, tregistry, tc, data, nblocks, device="cpu")
    assert max(np.abs(a).max() for _, a, _, _, _ in got[-2:]) > 1000
    for (jf, ja, jpw, jw, jd), (tf, ta, tpw, tw, td) in zip(want, got):
        assert tf == jf and td == jd
        assert ta.shape == ja.shape
        assert np.abs(ta.astype(int) - ja.astype(int)).max() <= 4
        np.testing.assert_allclose(tpw, jpw, rtol=2e-4, atol=1e-12)
        if jw is None:
            assert tw is None
        else:
            d = np.abs(tw.astype(int) - jw.astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3


# --------------------------------------------------------------- the CLI

CARRIER_BIN = 1234          # the AM carrier's exact bin
TONE_BINS = 15              # its modulation, 15 bins = 1001.4 Hz


def real_am_capture(cfg, seconds: float = 2.0) -> np.ndarray:
    """s16 real: an AM carrier on CARRIER_BIN, 50% modulated by a tone
    on an exact bin, plus noise; a whole number of FFT frames, so the
    pool loops with no seam."""
    n = cfg.fft_size * round(seconds * cfg.sps / cfg.fft_size)
    t = np.arange(n, dtype=np.float64)
    k = 2 * np.pi / cfg.fft_size
    x = 0.4 * (1 + 0.5 * np.cos(k * TONE_BINS * t)) * np.cos(
        k * CARRIER_BIN * t)
    x += np.random.default_rng(3).normal(0, 0.003, n)
    return np.round(x * 32000).astype(np.int16)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def toml_text(t: dict) -> str:
    out = []
    for sect in ("server", "input", "input.driver", "input.defaults",
                 "tpu"):
        d = t
        for part in sect.split("."):
            d = d[part]
        out.append(f"[{sect}]")
        out += [f"{k} = {json.dumps(v)}" for k, v in d.items()
                if not isinstance(v, dict)]
    return "\n".join(out) + "\n"


async def waterfall_peak(url: str, width: int) -> tuple[dict, list]:
    """basic_info and the centroid of the peak of each of 3 rows, the
    waterfall tuned by hz_to_bin to ``width`` bins around the carrier."""
    import aiohttp

    from phantomsdr_tpu_torch.runtime.codecs import ZstdDecompressStream

    dec = ZstdDecompressStream()
    cents = []
    async with aiohttp.ClientSession() as s:
        async with s.ws_connect(url + "/waterfall",
                                max_msg_size=1 << 22) as ws:
            info = json.loads((await ws.receive(timeout=60)).data)
            f_c = CARRIER_BIN * info["sps"] / info["fft_size"]
            l = round(torch_clients.hz_to_bin(info, f_c)) - width // 2
            await ws.send_str(json.dumps({"cmd": "window", "l": l,
                                          "r": l + width}))
            while len(cents) < 3:
                msg = await ws.receive(timeout=60)
                if msg.type != aiohttp.WSMsgType.BINARY:
                    continue
                pkt = torch_clients.cbor_decode(dec.decompress(msg.data))
                row = np.frombuffer(bytes(pkt["data"]), np.int8)
                if pkt["l"] == l and row.size == width:
                    top = np.nonzero(row == row.max())[0]
                    cents.append(float(top.mean()))
    return info, cents


def test_cli_serves_real_input_from_stdin(tmp_path):
    t = small_real_dict()
    port = free_port()
    t["server"]["port"] = port
    (tmp_path / "config.toml").write_text(toml_text(t))
    cfg = config_from_dict(t)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    log = open(tmp_path / "server.log", "w")
    srv = subprocess.Popen(
        [sys.executable, "-m", "phantomsdr_tpu_torch", "-c",
         str(tmp_path / "config.toml"), "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT,
        cwd=REPO, env=env)
    feeder = torch_clients.PipeFeeder(
        srv.stdin, real_am_capture(cfg).tobytes(), 2 * cfg.sps).start()
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(url + "/metrics",
                                            timeout=2) as r:
                    if json.loads(r.read())["frames"] > 0:
                        break
            except OSError:
                pass
            assert srv.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "server.log").read_text()[-3000:]
            time.sleep(0.2)
        df = cfg.sps / cfg.fft_size
        truth = {"f_off_hz": CARRIER_BIN * df, "sps": cfg.sps,
                 "tone_hz": TONE_BINS * df}
        res = asyncio.run(torch_clients.tone_check(url, truth, secs=8.0))
        info, cents = asyncio.run(waterfall_peak(url, cfg.waterfall_size))
        with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
            metrics = json.loads(r.read())
    finally:
        feeder.stop()
        srv.stdin.close()
        srv.terminate()
        try:
            srv.wait(timeout=20)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
        log.close()
    assert abs(res["tone"]["f_peak_hz"] - truth["tone_hz"]) < 20, res
    assert res["waterfall"]["peak_ok"] >= 1, res
    assert cents == [cfg.waterfall_size / 2] * 3, cents
    want = json.loads(JServer.basic_info(SimpleNamespace(
        cfg=jconfig(t))))
    for key in ("basefreq", "total_bandwidth", "fft_result_size", "sps",
                "fft_size", "defaults"):
        assert info[key] == want[key], key
    assert (info["basefreq"], info["total_bandwidth"],
            info["fft_result_size"]) == (0, cfg.sps // 2, cfg.fft_size // 2)
    assert metrics["device_errors"] == 0 and feeder.error is None


# ------------------------------------------------------------ hz_to_bin

@pytest.mark.parametrize("sps,fft,f_hz", [
    (960_000, 32_768, 144_000.0), (192_000, 4096, 28_800.0),
    (35_000_000, 1 << 20, -1_234_567.0), (1_536_000, 131_072, 10.0)])
def test_hz_to_bin_gives_todays_iq_bins(sps, fft, f_hz):
    c = config_from_dict({"input": {"sps": sps, "fft_size": fft,
                                    "frequency": 98_000_000}})
    info = {"sps": sps, "fft_size": fft, "fft_result_size": c.fft_result_size,
            "basefreq": c.basefreq, "total_bandwidth": c.total_bandwidth}
    rsize = info["fft_result_size"]
    assert torch_clients.hz_to_bin(info, f_hz) == (0.5 + f_hz / sps) * rsize
    assert torch_clients.hz_to_bins(info, 5_000) == 5_000 * rsize // sps
    # the frontend's mapping back to Hz
    assert c.basefreq + torch_clients.hz_to_bin(info, f_hz) \
        * c.total_bandwidth / rsize == pytest.approx(98_000_000 + f_hz)


def test_hz_to_bin_on_real_input():
    c = load_config(str(RX888))
    info = {"sps": c.sps, "fft_size": c.fft_size, "basefreq": c.basefreq,
            "fft_result_size": c.fft_result_size,
            "total_bandwidth": c.total_bandwidth}
    r = c.fft_result_size
    for f in (7_100_000.0, 1_000.0, 34_999_999.0, 21_000_123.5):
        assert torch_clients.hz_to_bin(info, f) == \
            (f - c.basefreq) * 2 * r / c.sps
    # the config's own default window comes from the same mapping
    assert int(torch_clients.hz_to_bin(info, 7_100_000)) == int(c.default_m)
    assert torch_clients.hz_to_bin(info, 7_100_000) == c.default_m
    # a tone on an exact bin maps back to that bin exactly
    df = c.sps / c.fft_size
    for b in (106_340, 157_286, 314_572):
        assert torch_clients.hz_to_bin(info, b * df) == b
    assert torch_clients.hz_to_bins(info, 3_000) == 3_000 * 2 * r // c.sps
