"""The PyTorch port's mesh server mode ([tpu] mesh_devices = N) on CPU
shards: the port's DSPDriver over the mesh against the same driver on
one device, and the websocket serving flow over the mesh, as
tests/test_mesh_server.py holds the JAX package's."""

import asyncio
import io
import json
import threading

import numpy as np
from aiohttp.test_utils import TestClient, TestServer

from phantomsdr_tpu_torch.config import config_from_dict
from phantomsdr_tpu_torch.main import build
from phantomsdr_tpu_torch.ops.quantize import pyramid_level_offsets
from phantomsdr_tpu_torch.runtime.driver import DSPDriver, SampleSource
from phantomsdr_tpu_torch.runtime.registry import (
    ChannelRegistry, WaterfallRegistry,
)
from tests.test_codecs import decode_flac
from tests.test_server import decode_cbor
from tests.zstd_mirror import ZstdStream as MirrorStream


def make_cfg(mesh=1, **inp):
    base = {
        "sps": 192000, "frequency": 7000000, "fft_size": 2048,
        "signal": "iq", "audio_sps": 12000, "waterfall_size": 256,
        "driver": {"format": "s16"},
    }
    base.update(inp)
    return config_from_dict({
        "server": {"port": 0},
        "input": base,
        "tpu": {"hop_batch": 8, "max_channels": 8, "mesh_devices": mesh},
    })


def run_driver(cfg, data, nblocks):
    """Run the port's DSPDriver (CPU) over `data`, collecting batches."""
    src = SampleSource(cfg, io.BytesIO(data.tobytes()))
    channels = ChannelRegistry(cfg)
    offs = pyramid_level_offsets(cfg.fft_result_size, cfg.downsample_levels)
    wf = WaterfallRegistry(cfg, offs, max_slots=4)
    slot = channels.acquire("t")
    channels.retune(slot, 100, 150.0, 200)
    wf.acquire()
    got = []
    done = threading.Event()

    def consumer(frame0, audio, pwr, wfviews, due, wf_meta, audio_meta,
                 rds=None):
        got.append((frame0, audio.copy(), pwr.copy(),
                    None if wfviews is None else wfviews.copy(), list(due)))
        if len(got) >= nblocks:
            done.set()

    drv = DSPDriver(cfg, src, channels, consumer, waterfall_registry=wf,
                    device="cpu")
    assert drv.sharded == (cfg.mesh_devices > 1)
    drv.start()
    ok = done.wait(timeout=120)
    drv.stop()
    assert ok, f"only {len(got)} batches (mesh={cfg.mesh_devices})"
    assert drv.metrics.device_errors == 0, drv.metrics.last_device_error
    return got


def test_mesh_driver_matches_single_device():
    """The mesh driver (halo passed between shards, channel-sharded
    demod, per-shard due gathers) delivers the single-device driver's
    outputs on one stream: the 3 blocks past the AGC look-ahead, so the
    audio is not silent."""
    nblocks = 6
    cfg1 = make_cfg(mesh=1)
    cfg4 = make_cfg(mesh=4)
    wph = cfg1.hop_size * 2
    rng = np.random.default_rng(7)
    data = rng.integers(-20000, 20000,
                        size=wph * cfg1.hop_batch * (nblocks + 1),
                        dtype=np.int16)
    got1 = run_driver(cfg1, data, nblocks)
    got4 = run_driver(cfg4, data, nblocks)
    assert max(np.abs(a).max() for _, a, _, _, _ in got1[-3:]) > 100
    for (f1, a1, p1, w1, d1), (f4, a4, p4, w4, d4) in zip(got1, got4):
        assert f1 == f4 and d1 == d4
        assert np.abs(a1.astype(int) - a4.astype(int)).max() <= 1
        np.testing.assert_allclose(p1, p4, rtol=1e-5, atol=1e-8)
        if w1 is None:
            assert w4 is None
        else:
            assert w1.shape == w4.shape
            assert np.abs(w1.astype(int) - w4.astype(int)).max() <= 1


def test_mesh_websocket_end_to_end():
    """Synthetic IQ capture with a known carrier -> the port's mesh
    DSPDriver (4 CPU shards) -> websocket /audio FLAC decodes to the
    expected tone; /waterfall's peak lands on the carrier."""
    cfg = make_cfg(mesh=4)
    sps, fft = cfg.sps, cfg.fft_size
    f_off = 30000
    bin_c = f_off * cfg.fft_result_size // sps - 1
    n = cfg.hop_size * cfg.hop_batch * 6
    t = np.arange(n)
    iq = 0.5 * np.exp(2j * np.pi * (f_off - sps / 2) * t / sps)
    wire = np.empty(2 * n, np.int16)
    wire[0::2] = np.round(iq.real * 20000)
    wire[1::2] = np.round(iq.imag * 20000)

    async def flow():
        server, driver = build(cfg, io.BytesIO(wire.tobytes()),
                               loop_file=True, throttle=cfg.sps,
                               device="cpu")
        assert driver.sharded and len(driver.devices) == 4
        client = TestClient(TestServer(server.app))
        await client.start_server()
        driver.start()
        try:
            ws = await client.ws_connect("/audio")
            info = json.loads((await ws.receive()).data)
            assert info["fft_result_size"] == cfg.fft_result_size
            # USB with m 1 kHz below the carrier -> ~1 kHz audio tone
            bins_1k = round(1000 * fft / sps)
            m = bin_c - bins_1k
            await ws.send_str(json.dumps(
                {"cmd": "window", "l": m, "m": float(m),
                 "r": m + cfg.audio_fft_size}))
            await ws.send_str(json.dumps(
                {"cmd": "demodulation", "demodulation": "USB"}))
            flac = b""
            for _ in range(400):
                try:
                    msg = await ws.receive(timeout=0.1)
                except asyncio.TimeoutError:
                    continue
                if msg.type.name == "BINARY":
                    flac += bytes(decode_cbor(msg.data)["data"])
                    if len(flac) > 6000:
                        break
            sr, samples = decode_flac(flac)
            assert sr == cfg.audio_sps
            x = samples[len(samples) // 2:].astype(np.float64)
            assert x.size > 2000
            spec = np.abs(np.fft.rfft(x * np.hanning(x.size)))
            freqs = np.fft.rfftfreq(x.size, 1.0 / sr)
            peak = freqs[np.argmax(spec[5:]) + 5]
            expect = bins_1k * sps / fft
            assert abs(peak - expect) < 40, (peak, expect)
            await ws.close()

            wsw = await client.ws_connect("/waterfall")
            json.loads((await wsw.receive()).data)
            d = MirrorStream()   # the browser's streaming decoder
            row = None
            for _ in range(400):
                try:
                    msg = await wsw.receive(timeout=0.1)
                except asyncio.TimeoutError:
                    continue
                if msg.type.name == "BINARY":
                    row = decode_cbor(bytes(d.push(msg.data)))
                    break
            assert row is not None, "no waterfall rows"
            rdata = np.frombuffer(bytes(row["data"]), np.int8)
            scale = (row["r"] - row["l"]) // rdata.size
            peak_bin = int(np.argmax(rdata)) * scale + row["l"]
            assert abs(peak_bin - bin_c) <= 2 * scale, (peak_bin, bin_c)
            await wsw.close()
        finally:
            driver.stop()
            await client.close()

    asyncio.run(flow())


def test_mesh_idle_resume_reinits_with_stream_parity():
    """After an idle block the mesh's device-side halo is stale: the
    driver rebuilds the state as a cold start seeded with the stream's
    hop parity.  Mesh of 3 at an odd hop_batch (9): block 0 served,
    blocks 1-2 idle, blocks 3-8 served from frame0 27 (odd).  Those
    steps must be a fresh mesh's from init_state(27) -- a zero halo, odd
    parity -- over the same blocks, past the AGC's look-ahead (the audio
    of the first ~200 ms after a cold start is silent)."""
    import torch

    from phantomsdr_tpu_torch.parallel import ShardedHopPipeline, make_mesh

    cfg = config_from_dict({
        "input": {"sps": 192000, "frequency": 7000000, "fft_size": 2048,
                  "signal": "iq", "audio_sps": 12000, "waterfall_size": 256,
                  "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 9, "max_channels": 6, "mesh_devices": 3}})
    wph, b, blocks = cfg.hop_size * 2, cfg.hop_batch, 9
    data = np.random.default_rng(11).integers(
        -20000, 20000, size=blocks * b * wph, dtype=np.int16)
    channels = ChannelRegistry(cfg)
    for i in range(cfg.max_channels):
        slot = channels.acquire(f"l{i}")
        channels.retune(slot, 101 + 40 * i, 126.0 + 40 * i, 151 + 40 * i)
        channels.set_mode(slot, ("USB", "LSB", "AM")[i % 3])
    active = iter([True, False, False] + [True] * (blocks - 3))
    got, done = [], threading.Event()

    def consumer(frame0, audio, *rest):
        got.append((frame0, audio.copy(), rest[0].copy()))
        if len(got) == blocks - 2:
            done.set()

    drv = DSPDriver(cfg, SampleSource(cfg, io.BytesIO(data.tobytes())),
                    channels, consumer, waterfall_active=lambda: False,
                    audio_active=lambda: next(active), device="cpu")
    drv.start()
    assert done.wait(timeout=60)
    drv.stop()
    assert drv.metrics.device_errors == 0, drv.metrics.last_device_error
    assert [f for f, _, _ in got] == [0] + [b * k for k in range(3, blocks)]

    sp = ShardedHopPipeline(cfg, make_mesh(3, "cpu"))
    _, arrays, _, _ = channels.snapshot()
    table = sp.channels_from_numpy(*arrays[:5], am_env=arrays[7],
                                   rds=arrays[6], nr=arrays[5])
    state = sp.init_state(3 * b)
    assert state.frame == 1 and not state.halo.any()
    for k, (_, audio, pwr) in zip(range(3, blocks), got[1:]):
        state, out = sp.step(state, sp.shard_raw(data[k * b * wph:
                                                      (k + 1) * b * wph]),
                             table, waterfall="off")
        np.testing.assert_array_equal(audio, torch.cat(out.audio, 1).numpy())
        np.testing.assert_array_equal(pwr, torch.cat(out.avg_power,
                                                     1).numpy())
    assert np.abs(audio).max() > 100
