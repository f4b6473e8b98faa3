"""tools/torch_profile.py on the CPU at a tiny size: the JSON parses,
every stage key of the JAX package's tools/profile.py is present (read
from that tool's source), each substage lies inside a stage of the
table, and the outside-stage parts are named.  A CPU run gives no
device time, so every time is null; the stages all run.  Then the
mesh mode on two CPU shards."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "torch_profile.py"
TINY = ["--device", "cpu", "--fft-log2", "12", "--hops", "4",
        "--channels", "16", "--kbig", "2"]


def jax_keys(table: str) -> set:
    """The keys tools/profile.py writes into ``results[table]``."""
    src = (REPO / "tools" / "profile.py").read_text()
    return set(re.findall(rf'results\["{table}"\]\["(\w+)"\]', src))


def run(tmp_path, *extra) -> dict:
    out = tmp_path / "p.json"
    res = subprocess.run([sys.executable, str(TOOL), *TINY, "--out",
                          str(out), *extra], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    got = json.loads(out.read_text())
    assert json.loads(res.stdout) == got
    return got


def test_profile_stage_table_on_cpu(tmp_path):
    p = run(tmp_path, "--optin")
    stages = jax_keys("stages_ms")
    assert stages == {"fft_batch", "waterfall_pyramid", "channelizer_demod",
                      "dc_agc"}
    assert set(p["stages_ms"]) == stages
    assert set(p["stages_issue_ms"]) == stages
    assert set(p["optin_stages_ms"]) == jax_keys("optin_stages_ms")
    assert set(p["launches_by_stage"]) == stages | jax_keys("optin_stages_ms")
    assert set(p["substages_ms"]) <= stages
    assert set(p["substages_ms"]["fft_batch"]) == {"window", "cufft"}
    assert set(p["substages_ms"]["channelizer_demod"]) == {
        "gathers", "iffts", "k_pll", "demod_math"}
    assert set(p["substages_ms"]["dc_agc"]) == {"k_agc",
                                                "dc_blocker_and_layout"}
    assert set(p["outside_stages_ms"]) == {"ingest", "pack"}
    assert set(p["step_split_ms"]) == {
        "ingest_and_fft_batch", "waterfall_pyramid", "channelizer_demod",
        "dc_blocker", "k_agc", "other"}
    for key in ("step_ms_e2e_p50", "step_device_ms", "fft_sol",
                "samples_per_step"):
        assert key in p
    # no device time from a CPU run
    assert p["config"]["device"] == "cpu" and p["step_ms_e2e_p50"] is None
    assert all(v is None for v in p["stages_ms"].values())
    assert p["samples_per_step"] == 4 * 2048


def test_profile_mesh_on_cpu(tmp_path):
    p = run(tmp_path, "--mesh", "2")
    assert p["config"]["mesh_devices"] == 2
    assert p["config"]["devices"] == ["cpu", "cpu"]
    assert p["step_ms_sharded_p50"] is None


def test_profile_refuses_the_jax_record(tmp_path):
    res = subprocess.run([sys.executable, str(TOOL), *TINY, "--out",
                          str(tmp_path / "PROFILE.json")],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode != 0 and "JAX package's record" in res.stderr


@pytest.mark.parametrize("flag", [[], ["--mesh", "2"]])
def test_profile_defaults_to_the_card(tmp_path, flag):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(TOOL), "--fft-log2", "12",
                          "--hops", "4", "--channels", "16", "--out",
                          str(tmp_path / "p.json"), *flag],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
