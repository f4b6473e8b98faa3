"""``python -m phantomsdr_tpu_torch.bench``, the port's counterpart of
bench.py, on the CPU.

Its setup against bench.py's, computed here with the JAX package's
``config_from_dict``, ``pyramid_level_offsets`` and
``channels_from_numpy`` along bench.py:84-172 (the derived config, every
channel-table array, the view starts and lengths, the block size, the
wire dtype and the pool's bytes, all exactly equal) for both profiles
and a ``--hop-batch`` override; the pool at hop_batch 12, which keeps
the CPU's memory small (the real profile's pool is 407 MB).  Then one
short run of the real profile on the CPU, its flags against bench.py's,
its refusal without a card and its import boundary.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from phantomsdr_tpu.config import config_from_dict as jconfig
from phantomsdr_tpu.ops.quantize import (
    pyramid_level_offsets as jpyramid_level_offsets,
)
from phantomsdr_tpu.pipeline import channels_from_numpy as jtable

from phantomsdr_tpu_torch import bench
from phantomsdr_tpu_torch.pipeline import channels_from_numpy

REPO = Path(__file__).resolve().parent.parent
DERIVED = ("sps", "frequency", "fft_size", "is_real", "audio_sps",
           "waterfall_size", "input_format", "hop_batch", "max_channels",
           "fft_result_size", "basefreq", "audio_max_fft_size",
           "downsample_levels", "skip_num", "base_idx", "hop_size",
           "view_cap", "size_log2")


def bench_py_setup(profile, hop_batch=0, pool=False):
    """bench.py:84-172 with the JAX package's functions, and no device:
    (cfg, table, starts, lengths, blk, wire_dt, pool blocks)."""
    if profile == "real":
        cfg = jconfig({
            "input": {
                "sps": 70_000_000, "frequency": 0, "fft_size": 1 << 20,
                "signal": "real", "audio_sps": 12000,
                "waterfall_size": 1024, "driver": {"format": "s16"},
            },
            "tpu": {"hop_batch": 96, "max_channels": 64},
        })
    else:
        cfg = jconfig({
            "input": {
                "sps": 35_000_000, "frequency": 100_000_000,
                "fft_size": 1 << 20, "signal": "iq", "audio_sps": 12000,
                "waterfall_size": 1024, "driver": {"format": "u8"},
            },
            "tpu": {"hop_batch": 36, "max_channels": 128},
        })
    if hop_batch:
        cfg = jconfig({
            "input": {
                "sps": cfg.sps, "frequency": cfg.frequency,
                "fft_size": cfg.fft_size,
                "signal": "real" if cfg.is_real else "iq",
                "audio_sps": cfg.audio_sps,
                "waterfall_size": cfg.waterfall_size,
                "driver": {"format": cfg.input_format},
            },
            "tpu": {"hop_batch": hop_batch,
                    "max_channels": cfg.max_channels},
        })
    c = cfg.max_channels
    rng = np.random.default_rng(0)
    l = np.linspace(1000, cfg.fft_result_size - 2000, c).astype(np.int64)
    width = np.full(c, min(cfg.audio_fft_size, 300))
    table = jtable(l=l, r=l + width, m_idx=l + width // 2,
                   mode=np.arange(c) % 4, active=np.ones(c, bool))
    offs = jpyramid_level_offsets(cfg.fft_result_size, cfg.downsample_levels)
    wstarts = []
    for w in range(c):
        lev = (w * 7) % cfg.downsample_levels
        row_w = cfg.fft_result_size >> lev
        span = min(cfg.waterfall_size, row_w)
        wstarts.append(offs[lev] + (w * 131) % max(row_w - span, 1))
    lengths = np.full((c,), cfg.waterfall_size, np.int32)
    wph = cfg.hop_size * (1 if cfg.is_real else 2)   # pipe.wire_per_hop
    blk = (cfg.hop_batch + 1) * wph
    wire_dt = np.dtype(np.uint8 if cfg.input_format == 'u8' else np.int16)
    lo, hi = (0, 256) if wire_dt == np.uint8 else (-20000, 20000)
    blocks = ([rng.integers(lo, hi, size=blk, dtype=wire_dt)
               for _ in range(4)] if pool else None)
    return cfg, table, np.asarray(wstarts, np.int32), lengths, blk, \
        wire_dt, blocks


@pytest.mark.parametrize("profile,hop_batch,pool", [
    ("iq", 0, False), ("real", 0, False), ("iq", 12, True),
    ("real", 12, True), ("real", 24, False)])
def test_setup_equals_bench_py(profile, hop_batch, pool):
    jc, jt, jstart, jlen, jblk, jdt, jpool = bench_py_setup(
        profile, hop_batch, pool)
    s = bench.setup(profile, hop_batch)
    for name in DERIVED:
        assert getattr(s.cfg, name) == getattr(jc, name), name
    assert s.cfg.audio_fft_size == jc.audio_fft_size
    tt = channels_from_numpy(**s.table)
    for name in ("l", "r", "m_idx", "mode", "active", "nr", "rds",
                 "am_env"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    assert tt.need_pll and not tt.need_rds and not tt.need_nr
    np.testing.assert_array_equal(s.view_start, jstart)
    np.testing.assert_array_equal(s.view_length, jlen)
    assert s.block == jblk and s.wire_dtype == jdt
    if pool:
        ours = bench.raw_blocks(s, np.random.default_rng(0))
        assert len(ours) == len(jpool) == 4
        for a, b in zip(ours, jpool):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_real_profile_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = bench.run("real", device="cpu", hop_batch=12, secs=0.05,
                    ingest_secs=0.05)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == res
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "sustained_real_msps" and line["unit"] == "MSPS"
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 70.0, 3)
    assert "# windows:" in out.err and "backend=cpu" in out.err
    assert "# with-ingest" in out.err
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BENCH_DETAILS_torch_real.json"]
    det = json.loads((tmp_path / "BENCH_DETAILS_torch_real.json").read_text())
    for key in ("windows_msps", "ingest_msps_windows", "ingest_msps",
                "step_ms", "hop_batch", "channels"):
        assert key in det, key
    assert len(det["windows_msps"]) == 3 and len(det["ingest_msps_windows"]) == 2
    assert det["value"] == sorted(det["windows_msps"])[1]
    assert det["ingest_msps"] == max(det["ingest_msps_windows"])
    assert det["hop_batch"] == 12 and det["channels"] == 64
    assert det["device"] == "cpu" and det["card"] is None
    # the plain versions on the CPU: no kernel launched
    assert set(det["launches"]) >= {"waterfall", "pll", "agc"}
    assert not any(det["launches"].values())


def bench_py_flags() -> dict:
    """bench.py's flags: {flag: (type name, default, choices)}."""
    tree = ast.parse((REPO / "bench.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = (
                getattr(kw.get("type"), "id", None),
                ast.literal_eval(kw["default"]),
                ast.literal_eval(kw["choices"]) if "choices" in kw
                else None)
    return out


def test_flags_and_defaults_are_bench_py_s():
    ours = {a.option_strings[0]: a for a in bench.parser()._actions
            if a.option_strings and a.dest != "help"}
    theirs = bench_py_flags()
    assert set(theirs) == {"--profile", "--hop-batch"}
    for flag, (typ, default, choices) in theirs.items():
        a = ours[flag]
        assert a.default == default, flag
        assert getattr(a.type, "__name__", None) == typ, flag
        assert (tuple(a.choices) if a.choices else None) == choices, flag
    assert set(ours) - set(theirs) == {"--device"}
    assert ours["--device"].default == "cuda"
    args = bench.parser().parse_args([])
    assert (args.profile, args.hop_batch, args.device) == ("iq", 0, "cuda")


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run("iq")
    assert not list(tmp_path.iterdir())


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import phantomsdr_tpu_torch.bench as b\n"
            "b.setup('real', 12)\n"
            "import phantomsdr_tpu_torch.ops.cuda.build, "
            "phantomsdr_tpu_torch.runtime.driver\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib')\n"
            "       or m.startswith(('jax.', 'jaxlib.', 'phantomsdr_tpu.'))\n"
            "       or m == 'phantomsdr_tpu']\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
