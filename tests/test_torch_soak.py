"""tools/torch_soak.py and its clients (tools/torch_clients.py).

The verdict on synthetic samples: a flat run passes; RSS growth, device
memory growth, latency growth and any device, client or decode error
fail it.  The clients' decoders against the port's encoders: the FLAC
decoder copy against the JAX side's from-spec decoder on the port's
streams (mono and stereo), the libzstd stream decoder against the
port's per-message-flushed stream.  Then one CPU smoke of the soak,
12 s with soak.py's RSS and latency bars switched off (the hourly RSS
budget cannot be measured in seconds, and a CPU server's step time on
a machine shared with other test workers says nothing about drift):
packets delivered and decoded, no error of any kind.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_codecs import decode_flac as jax_side_decode_flac
from phantomsdr_tpu_torch.runtime import cbor
from phantomsdr_tpu_torch.runtime.codecs import (
    FlacEncoder, ZstdDecompressStream, ZstdStream,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import torch_clients  # noqa: E402
import torch_soak  # noqa: E402

TOOL = REPO / "tools" / "torch_soak.py"


def args(**kw):
    base = dict(secs=3600, audio=24, wf=8, churn=45, rss_budget_pct=5.0,
                lat_factor=1.5)
    return argparse.Namespace(**{**base, **kw})


def samples(n=20, rss=(1_000_000, 0.0), mem=(2000, 0.0), lat=(4.0, 0.0),
            dev_errors=0):
    """n samples over an hour: rss, device memory and step p50 grow
    linearly from their first value by the given total growth."""
    out = []
    for i in range(n):
        f = i / (n - 1)
        out.append({"t": 3600.0 * f,
                    "rss_kb": int(rss[0] * (1 + rss[1] * f)),
                    "device_mem_mb": int(mem[0] * (1 + mem[1] * f)),
                    "step_ms_p50": lat[0] * (1 + lat[1] * f),
                    "device_errors": dev_errors if i == n // 2 else 0,
                    "encode_dropped": 0})
    return out


def stats(**kw):
    s = torch_clients.new_stats()
    s.update(audio_pkts=5000, wf_pkts=5000, **kw)
    return s


def test_verdict_flat_run_passes():
    v = torch_soak.verdict(samples(), stats(), args())
    assert v["pass"], v
    assert v["rss_pct_per_hour"] == 0 and v["device_mem_pct_per_hour"] == 0


@pytest.mark.parametrize("bad", [
    dict(samples=dict(rss=(1_000_000, 0.10))),      # RSS +10%/h
    dict(samples=dict(mem=(2000, 0.10))),           # device memory
    dict(samples=dict(lat=(4.0, 2.0))),             # latency x3
    dict(samples=dict(dev_errors=1)),
    dict(stats=dict(audio_errors=1)),
    dict(stats=dict(wf_errors=1)),
    dict(stats=dict(decode_errors=1)),
])
def test_verdict_fails_on_growth_or_errors(bad):
    v = torch_soak.verdict(samples(**bad.get("samples", {})),
                           stats(**bad.get("stats", {})), args())
    assert not v["pass"], v


def test_verdict_without_device_memory():
    """A CPU run reads no device memory: the RSS budget alone holds."""
    s = samples()
    for p in s:
        p["device_mem_mb"] = None
    v = torch_soak.verdict(s, stats(), args())
    assert v["pass"] and v["device_mem_pct_per_hour"] is None


@pytest.mark.parametrize("channels", [1, 2])
def test_flac_decoder_copy_matches_the_jax_side_decoder(channels):
    rng = np.random.default_rng(channels)
    t = np.arange(3 * 4096 * channels)
    x = (9000 * np.sin(2 * np.pi * 700 / 12000 * t)
         + 300 * rng.standard_normal(t.size)).astype(np.int16)
    enc = FlacEncoder(12000, channels=channels)
    data = enc.process(x) + enc.finish()
    enc.close()
    sr, got = torch_clients.decode_flac(data)
    want_sr, want = jax_side_decode_flac(data)
    assert sr == want_sr == 12000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)
    with pytest.raises(ValueError):
        torch_clients.decode_flac(data[:len(data) - 7])


def test_zstd_stream_and_cbor_roundtrip():
    enc, dec = ZstdStream(3), ZstdDecompressStream()
    rng = np.random.default_rng(0)
    for i in range(20):
        row = rng.integers(-128, 128, 64 * (i + 1), dtype=np.int8)
        pkt = cbor.waterfall_packet(i, 10, 10 + 4 * row.size, row.tobytes())
        got = torch_clients.cbor_decode(dec.decompress(enc.compress(pkt)))
        assert got["frame_num"] == i and bytes(got["data"]) == row.tobytes()


def test_soak_smoke_on_cpu(tmp_path):
    out = tmp_path / "soak.json"
    res = subprocess.run(
        [sys.executable, str(TOOL), "--device", "cpu", "--secs", "12",
         "--sample-secs", "3", "--audio", "6", "--wf", "3", "--churn", "6",
         "--dir", str(tmp_path / "soak"), "--out", str(out),
         "--rss-budget-pct", "1e9", "--lat-factor", "1e9"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    v = json.loads(res.stdout)
    assert v == json.loads(out.read_text())["verdict"]
    assert v["pass"], v
    assert v["decode_errors"] == 0 and v["client_errors"] == 0, v
    # the CPU server falls far behind real time on a loaded machine (a
    # step took 2.4 s instead of 0.2 s under six test workers), so the
    # bars are on delivery and decoding, not on a rate or a latency
    assert v["audio_pkts"] > 0 and v["wf_pkts"] > 0, v
    assert v["decoded_wf_rows"] > 0, v
    assert v["device_mem_mb_final"] is None and v["card"] is None
