"""PyTorch port vs the JAX package: the RDS subcarrier demodulation
(ops/rds.py: the shared pilot front end, the PLL and 57 kHz downmix --
the plain version of kernel K-PILOT -- the lowpass/decimate and the int8
normalization) over chained blocks, on CPU; the port's own chain into
its copy of the host protocol decoder (runtime/rds.py), which must
recover the exact PI, PS and RadioText; and the server's RDS protocol.

Tolerance: int8 baseband within one step on < 0.1% of samples (the two
sum the lowpass and the block RMS in other orders, and a value at a
rounding edge may go either way); pilot carries |diff| <= 1e-5 *
max|x| (tests/test_torch_stereo.py), delay-line tails equal; the I/Q
lowpass tail, 2*x*cos/sin(3*ph), within 6e-5 * max|x| (a phase error of
1e-5 moves it by up to 6 * |x| * 1e-5).
"""

import asyncio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.ops import rds as jrds
from phantomsdr_tpu.runtime import rds as jhost

from phantomsdr_tpu_torch.config import config_from_dict
from phantomsdr_tpu_torch.ops import rds
from phantomsdr_tpu_torch.runtime import rds as host
from tests.test_rds import PI, PS, RT, _group_bits, _mpx

FS = 192000
DECODE_FS = 128000       # the decode runs the plain loop: a lower rate
DECODE_SECS = 1.92       # PS and RadioText assemble by ~1.86 s


@pytest.mark.parametrize("sps,half", [(192000, 4096), (192000, 5034),
                                      (128000, 4096), (192000, 256)])
def test_params_equal_jax(sps, half):
    p, jp = rds.make_rds_params(sps, half), jrds.make_rds_params(sps, half)
    np.testing.assert_array_equal(p.bp_taps, jp.bp_taps)
    np.testing.assert_array_equal(p.lp_taps, jp.lp_taps)
    assert (p.delay, p.f_nom, p.decim) == (jp.delay, jp.f_nom, jp.decim)


def test_rds_process_matches_jax_across_blocks():
    p = rds.make_rds_params(FS, 4096)
    blk = 4096
    x = np.stack([_mpx(3 * blk), 3.0 * _mpx(3 * blk, phase_off=np.pi / 2),
                  0.5 * _mpx(3 * blk)])
    mask = np.array([True, True, False])
    tol = 1e-5 * float(np.abs(x).max())
    js = jrds.init_rds_state(3, p)
    ts = rds.init_rds_state(3, p)
    diff = []
    for k in range(3):
        xb = x[:, k * blk:(k + 1) * blk]
        js, jq = jrds.rds_process(js, p, jnp.asarray(xb), jnp.asarray(mask))
        ts, q = rds.rds_process(ts, p, torch.from_numpy(xb),
                                torch.from_numpy(mask))
        assert q.dtype == torch.int8 and q.shape == (3, 2, blk // p.decim)
        diff.append(np.abs(q.numpy().astype(int) - np.asarray(jq)))
        assert not q[2].any()                  # masked row: zeros
        for name in ("bp_tail", "mpx_tail"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
        for name in ("phase", "freq"):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=tol, rtol=0)
        np.testing.assert_allclose(ts.dec_tail.numpy(),
                                   np.asarray(js.dec_tail), atol=6 * tol,
                                   rtol=0)
    diff = np.concatenate([d.ravel() for d in diff])
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_rds_from_pilot_matches_jax():
    """The downmix + lowpass + int8 half on a given phase, as JAX's."""
    p = rds.make_rds_params(FS, 4096)
    rng = np.random.default_rng(4)
    xd = _mpx(4096)[None].repeat(2, 0) * np.float32(1.5)
    ph = (rng.random((2, 4096)) * 6.28).astype(np.float32)
    fm = np.array([True, False])
    tail = rng.standard_normal((2, 2 * (p.lp_taps.shape[0] - 1))).astype(
        np.float32)
    jt, jq = jrds.rds_from_pilot(jnp.asarray(tail), p, jnp.asarray(xd),
                                 jnp.asarray(ph), jnp.asarray(fm))
    tt, q = rds.rds_from_pilot(torch.from_numpy(tail), p,
                               torch.from_numpy(xd), torch.from_numpy(ph),
                               torch.from_numpy(fm))
    d = np.abs(q.numpy().astype(int) - np.asarray(jq))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3 and not q[1].any()
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_host_decoder_is_the_jax_one():
    """The copy encodes blocks like the JAX module and decodes the clean
    bitstream with zero block errors."""
    for off in (host.OFFSET_A, host.OFFSET_B, host.OFFSET_C, host.OFFSET_D):
        for data in (0, 0x54A7, 0xFFFF):
            assert host.encode_block(data, off) == jhost.encode_block(data,
                                                                      off)
    dec = host.RDSGroupDecoder()
    dec.push_bits([0, 1, 0] + _group_bits() * 2)
    s = dec.status()
    assert s["synced"] and s["block_errors"] == 0
    assert (s["pi"], s["ps"], s["rt"]) == (f"{PI:04X}", PS, RT)


@pytest.fixture(scope="module")
def decoded_baseband():
    """The port's int8 baseband of DECODE_SECS of the RDS MPX at
    DECODE_FS, in the chunks it was made in."""
    p = rds.make_rds_params(DECODE_FS, half=4096)
    chunk = 8192
    n = int(DECODE_FS * DECODE_SECS) // chunk * chunk
    x = _mpx(n, fs=DECODE_FS)
    st = rds.init_rds_state(1, p)
    out = []
    for i in range(0, n, chunk):
        st, bb = rds.rds_process(st, p, torch.from_numpy(x[None, i:i + chunk]),
                                 torch.tensor([True]))
        out.append(bb.numpy()[0])
    return DECODE_FS / p.decim, out


def test_port_chain_decodes_pi_ps_radiotext(decoded_baseband):
    rate, chunks = decoded_baseband
    dec = host.RDSDecoder(rate)
    for bb in chunks:
        dec.feed(bb)
    s = dec.group.status()
    assert s["synced"], s
    assert (s["pi"], s["ps"], s["rt"]) == (f"{PI:04X}", PS, RT), s


def test_rds_server_protocol(decoded_baseband):
    """Serving edge (the port counterpart of tests/test_rds.py's):
    basic_info advertises rds_available, {"cmd":"rds"} flips the
    registry column and makes the listener's decoder, dispatch routes
    the baseband to it on its encode worker, and the client receives
    {"type":"rds"} JSON text frames with the recovered PI and PS."""
    from aiohttp import WSMsgType
    from aiohttp.test_utils import TestClient, TestServer

    from phantomsdr_tpu_torch.runtime.server import SpectrumServer

    # audio_sps DECODE_FS with an audio block of 256: baseband decimation
    # 16, the rate the fixture's baseband is at
    cfg = config_from_dict({
        "input": {"sps": 1_024_000, "frequency": 98_000_000,
                  "fft_size": 4096, "signal": "iq",
                  "audio_sps": DECODE_FS, "waterfall_size": 512,
                  "rds": True, "driver": {"format": "s16"},
                  "defaults": {"frequency": 98_000_000,
                               "modulation": "WBFM"}},
        "tpu": {"hop_batch": 16, "max_channels": 2}})
    rate, chunks = decoded_baseband
    assert cfg.audio_sps / rds.rds_decim_for(
        cfg.audio_sps, cfg.audio_fft_size // 2) == rate
    server = SpectrumServer(cfg)

    async def scenario():
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            ws = await client.ws_connect("/audio")
            info = json.loads((await ws.receive(timeout=5)).data)
            assert info["rds_available"] is True
            await ws.send_str(json.dumps({"cmd": "rds", "enabled": True}))
            await asyncio.sleep(0.1)
            slot_id = next(iter(server.channels.slots))
            assert server.channels.rds[slot_id]
            assert server.audio_conns[slot_id].rds_decoder is not None
            b, c = cfg.hop_batch, cfg.max_channels
            half = cfg.audio_fft_size // 2
            audio = np.zeros((b, c, half), np.int16)
            pwr = np.zeros((b, c), np.float32)
            for bb in chunks:
                z = np.zeros((c, 2, bb.shape[-1]), np.int8)
                z[slot_id] = bb
                server.dispatch(0, audio, pwr, None, [], rds=z)
                await asyncio.sleep(0)
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 10
            while loop.time() < deadline:
                msg = await ws.receive(timeout=10)
                if msg.type == WSMsgType.TEXT:
                    d = json.loads(msg.data)
                    if d.get("type") == "rds" and d.get("ps") == PS:
                        return d
            return None
        finally:
            await client.close()

    got = asyncio.run(scenario())
    assert got is not None
    assert got["pi"] == f"{PI:04X}" and got["synced"]
