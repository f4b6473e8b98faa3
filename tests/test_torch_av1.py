"""The PyTorch port's AV1 waterfall codec (runtime/av1.py) against the
JAX package's on the same rows: every OBU but the T.35 metadata equal
byte for byte, and each metadata blob decoding alone, through the
browser decoder's mirror (tests/zstd_mirror.py), to the same per-line
headers; a lossless round trip through the port's AV1Decoder; and the
port's server (mesh mode, CPU shards) serving AV1 waterfall rows whose
decoded peak lands on the carrier.  Skipped, like tests/test_av1.py,
where libaom is missing."""

import asyncio
import io
import json
import struct

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from phantomsdr_tpu.runtime import av1 as jav1
from phantomsdr_tpu_torch.runtime import av1
from tests.test_av1 import OBU_METADATA, parse_obus
from tests.zstd_mirror import ZstdStream as MirrorStream

pytestmark = pytest.mark.skipif(
    not av1.av1_available(),
    reason=f"libaom unavailable: {av1._Aom.failure()}")


def t35_headers(meta: bytes) -> list[tuple[int, int, int, int]]:
    """The per-line headers of one T.35 metadata OBU payload, decoded
    alone by a fresh decoder, as the browser decodes each blob."""
    assert meta[0] == av1.OBU_METADATA_TYPE_ITUT_T35 and meta[1] == 0
    blob = bytes(MirrorStream().push(meta[2:]))
    assert len(blob) == av1.WATERFALL_COALESCE * 24
    return [struct.unpack_from("<QIII", blob, 24 * i)
            for i in range(av1.WATERFALL_COALESCE)]


@pytest.mark.parametrize("width", [512, 1024])
def test_encoder_matches_jax(width):
    """Three temporal units (one key frame, two inter frames)."""
    rng = np.random.default_rng(width)
    tenc, jenc = av1.AV1Encoder(width), jav1.AV1Encoder(width)
    units = 0
    for i in range(3 * av1.WATERFALL_COALESCE):
        row = rng.integers(-128, 128, width).astype(np.int8).tobytes()
        args = (row, 100 + i, 2 * i, 2 * i + width)
        t, j = tenc.send(*args), jenc.send(*args)
        assert (t is None) == (j is None)
        if t is None:
            continue
        units += 1
        tobus, jobus = parse_obus(t), parse_obus(j)
        assert [k for k, _ in tobus] == [k for k, _ in jobus]
        for (kind, tp), (_, jp) in zip(tobus, jobus):
            if kind == OBU_METADATA:
                heads = t35_headers(bytes(tp))
                assert heads == t35_headers(bytes(jp))
                first = i + 1 - av1.WATERFALL_COALESCE
                assert heads[0] == (100 + first, width, 2 * first,
                                    2 * first + width)
            else:
                assert bytes(tp) == bytes(jp)
    assert units == 3
    tenc.close()
    jenc.close()


def test_lossless_decode_roundtrip():
    rng = np.random.default_rng(42)
    enc, dec = av1.AV1Encoder(1024), av1.AV1Decoder()
    for f in range(3):                       # frame 0 key, 1-2 inter
        rows = rng.integers(-128, 128, size=(8, 1024)).astype(np.int8)
        blob = None
        for i in range(8):
            blob = enc.send(rows[i].tobytes(), 8 * f + i, 16, 1040)
        frames = dec.decode(blob)
        assert len(frames) == 1
        np.testing.assert_array_equal(frames[0], rows)
    enc.close()
    dec.close()


def test_mesh_server_serves_av1_waterfall():
    """A carrier capture through the port's server in mesh mode (4 CPU
    shards) with waterfall_compression = "av1": the /waterfall stream is
    AV1 temporal units that decode losslessly, whose metadata names the
    rows' frames and spans, and whose rows peak on the carrier."""
    from phantomsdr_tpu_torch.config import config_from_dict
    from phantomsdr_tpu_torch.main import build

    cfg = config_from_dict({
        "server": {"port": 0},
        "input": {"sps": 192000, "frequency": 7000000, "fft_size": 2048,
                  "signal": "iq", "audio_sps": 12000, "waterfall_size": 256,
                  "waterfall_compression": "av1",
                  "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 8, "max_channels": 8, "mesh_devices": 4},
    })
    sps = cfg.sps
    f_off = 30000
    bin_c = f_off * cfg.fft_result_size // sps - 1
    n = cfg.hop_size * cfg.hop_batch * 6
    iq = 0.5 * np.exp(2j * np.pi * (f_off - sps / 2) * np.arange(n) / sps)
    wire = np.empty(2 * n, np.int16)
    wire[0::2] = np.round(iq.real * 20000)
    wire[1::2] = np.round(iq.imag * 20000)

    async def flow():
        server, driver = build(cfg, io.BytesIO(wire.tobytes()),
                               loop_file=True, device="cpu")
        client = TestClient(TestServer(server.app))
        await client.start_server()
        driver.start()
        try:
            ws = await client.ws_connect("/waterfall", max_msg_size=1 << 22)
            info = json.loads((await ws.receive()).data)
            assert info["waterfall_compression"] == "av1"
            for _ in range(600):
                try:
                    msg = await ws.receive(timeout=0.1)
                except asyncio.TimeoutError:
                    continue
                if msg.type.name == "BINARY":
                    await ws.close()
                    return msg.data
        finally:
            driver.stop()
            await client.close()

    unit = asyncio.run(flow())
    assert unit is not None, "no AV1 temporal unit received"
    meta = [p for k, p in parse_obus(unit) if k == OBU_METADATA][0]
    heads = t35_headers(bytes(meta))
    dec = av1.AV1Decoder()
    (rows,) = dec.decode(unit)
    dec.close()
    for (fnum, nbytes, l, r), row in zip(heads, rows):
        assert nbytes == cfg.waterfall_size
        scale = (r - l) // nbytes
        peak_bin = int(np.argmax(row[:nbytes])) * scale + l
        assert abs(peak_bin - bin_c) <= 2 * scale, (fnum, peak_bin, bin_c)
