"""tools/torch_ingest_bench.py and the reader its legs time.

The tool on the CPU at a small block with the JAX package unimportable:
the JAX tool's legs and keys, plus the upload's split (delivery only:
CPU times say nothing of the card, so no rate is asserted).  Then the
port's ``SampleSource`` against the JAX package's on the same bytes:
u8 and s16, with and without the halo, from a pipe to its end and from
a file looped across its wrap.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from phantomsdr_tpu.config import config_from_dict as jax_config
from phantomsdr_tpu.runtime.driver import SampleSource as JaxSource
from phantomsdr_tpu_torch.config import config_from_dict
from phantomsdr_tpu_torch.runtime.driver import SampleSource

REPO = Path(__file__).resolve().parent.parent
TOOL = "tools/torch_ingest_bench.py"
NO_JAX = ("import runpy, sys; sys.modules['jax'] = None; "
          "sys.modules['phantomsdr_tpu'] = None; sys.argv = sys.argv[1:]; "
          "runpy.run_path(sys.argv[0], run_name='__main__')")
LEG_KEYS = {"mbps", "msps", "ms_per_block"}


def jax_tool_result_keys() -> set:
    """The top-level keys tools/ingest_bench.py writes: its ``results``
    dict literal and every ``results[...] =``."""
    tree = ast.parse((REPO / "tools" / "ingest_bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "results" \
                    and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            elif isinstance(t, ast.Subscript) and getattr(
                    t.value, "id", None) == "results":
                keys.add(t.slice.value)
    return keys


def test_ingest_bench_cpu_legs_without_jax(tmp_path):
    out = tmp_path / "INGEST_torch.json"
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, TOOL, "--device", "cpu",
         "--fft-log2", "12", "--hop-batch", "4", "--blocks", "4",
         "--out", str(out)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    v = json.loads(res.stdout)
    assert v == json.loads(out.read_text())
    assert jax_tool_result_keys() <= set(v)
    assert {"read", "upload", "overlap"} <= jax_tool_result_keys()
    for leg in ("read", "upload", "overlap"):
        assert set(v[leg]) == LEG_KEYS
        assert all(x > 0 for x in v[leg].values()), v[leg]
    assert v["config"] == {"platform": "cpu", "device": "cpu",
                           "hop_batch": 4, "fft_size": 4096,
                           "format": "u8 iq", "blocks": 4}
    assert v["targets"] == {"wire_mbps": 70.0, "msps": 35.0}
    split = v["upload_split"]
    assert split["halo_concat_ms"] > 0
    assert split["pinned_copy_ms"] is None and split["h2d_ms"] is None
    assert v["card"] is None
    assert v["meets_target"] == (v["overlap"]["msps"] >= 35.0)


def test_ingest_bench_on_the_card_by_default(tmp_path):
    """No fallback: the default --device cuda refuses without a card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, TOOL, "--blocks", "1", "--out",
         str(tmp_path / "x.json")],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 2 and "--device cpu" in res.stderr
    assert res.stdout == "" and not (tmp_path / "x.json").exists()


def _cfg(make, fmt):
    return make({"input": {"sps": 192000, "frequency": 7000000,
                           "fft_size": 1024, "signal": "iq",
                           "audio_sps": 12000, "waterfall_size": 512,
                           "driver": {"format": fmt}},
                 "tpu": {"hop_batch": 4, "max_channels": 16}})


def _pipe(data: bytes):
    """A pipe's read end that yields ``data`` and then EOF."""
    rfd, wfd = os.pipe()

    def write():
        with os.fdopen(wfd, "wb") as w:
            w.write(data)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    return os.fdopen(rfd, "rb"), t


def _blocks(src, n):
    out = []
    for _ in range(n):
        b = src.read_block()
        out.append(None if b is None else b.copy())
    return out


@pytest.mark.parametrize("halo", [True, False], ids=["halo", "no_halo"])
@pytest.mark.parametrize("fmt", ["u8", "s16"])
@pytest.mark.parametrize("kind", ["pipe", "looped_file"])
def test_sample_source_matches_the_jax_package(tmp_path, kind, fmt, halo):
    cfg, jcfg = _cfg(config_from_dict, fmt), _cfg(jax_config, fmt)
    width = 1 if fmt == "u8" else 2
    block = cfg.hop_batch * cfg.hop_size * 2 * width
    rng = np.random.default_rng(11)
    if kind == "pipe":
        # 3.5 blocks: three whole ones, then EOF mid-block
        data = rng.integers(0, 256, 7 * block // 2, np.uint8).tobytes()
        (ours, t1), (theirs, t2) = _pipe(data), _pipe(data)
        n, loop = 5, False
    else:
        # 2.5 blocks looped: every other block spans the file's wrap
        data = rng.integers(0, 256, 5 * block // 2, np.uint8).tobytes()
        path = tmp_path / "capture.bin"
        path.write_bytes(data)
        ours, theirs = open(path, "rb"), open(path, "rb")
        n, loop = 6, True
    try:
        got = _blocks(SampleSource(cfg, ours, loop_file=loop,
                                   include_halo=halo), n)
        want = _blocks(JaxSource(jcfg, theirs, loop_file=loop,
                                 include_halo=halo), n)
    finally:
        ours.close()
        theirs.close()
    assert [b is None for b in got] == [b is None for b in want]
    if kind == "pipe":
        assert [b is None for b in got] == [False] * 3 + [True] * 2
        t1.join(10)
        t2.join(10)
    else:
        assert all(b is not None for b in got)
    wire = cfg.hop_size * 2
    for g, w in zip(got, want):
        if w is None:
            continue
        assert g.dtype == w.dtype and g.dtype.itemsize == width
        assert g.shape == w.shape == (
            (cfg.hop_batch + halo) * wire,)
        np.testing.assert_array_equal(g, w)
    if halo:   # each block opens with the last hop of the one before
        np.testing.assert_array_equal(got[1][:wire], got[0][-wire:])
        assert not got[0][:wire].any()
