"""The shipped RX888 deployment as benchmark cell ``rx888toml.b12``.

Its pieces are found by name (``configs/config.example.rx888.toml``'s
values, the ``hf128`` band-plan mix, the limits), and the mix runs
through the harness on the CPU at a tiny size shaped like the
deployment: s16 real input, a step's audio narrower than the AGC's
look-ahead window, one waterfall row due a step.  A sound run is
correct; a step that hands on its carries unchanged is not."""

import json
import subprocess
import sys
import tomllib

import pytest

from sdrbench import spec, traffic
from sdrbench.reference import dsp
from sdrbench.tests import sdrbench_cells

REPO = sdrbench_cells.REPO
CELL = "rx888toml.b12"
TINY = "tiny.hf"

# the deployment's bands mapped onto the tiny 0-48 kHz band: AM (PLL)
# low and in two "broadcast" bands, LSB below 20 kHz, USB above
TINY_BANDS = [[8000, "AM"], [14000, "LSB"], [17000, "AM"], [20000, "LSB"],
              [26000, "USB"], [30000, "AM"], [None, "USB"]]
# tiny_real with hop_batch 4: a step's 4 x 64 = 256 audio samples against
# the AGC's 600-sample window, and skip 4: one due waterfall row a step
TINY_CONFIG = dict(sdrbench_cells.TINY_CONFIGS["tiny_real"],
                   tpu={"hop_batch": 4, "max_channels": 16})


def mode_counts(p, mix) -> list[int]:
    """Listeners of the mix by mode: USB, LSB, AM, FM."""
    t = traffic.listener_table(p, mix)
    return [int((t.mode[t.active] == k).sum()) for k in range(4)]


def test_cell_found_by_name():
    c = spec.cell(REPO, CELL)
    assert (c.config_name, c.traffic, c.chips) == (
        "rx888toml_s16_b12", "hf128", 1)
    assert c.config["reduced"] == []
    p = dsp.plan(c.server_config)
    assert (p.r, p.levels, p.skip, p.half, p.agc_window) == (
        524_288, 9, 12, 90, 2400)
    assert (p.is_real, p.fmt, p.b, p.c, p.base_idx) == (
        True, "s16", 12, 128, 0)
    assert p.b * p.hop == c.config["step"]["samples"] == 6_291_456
    # one due row a step, and a window wider than a step's audio
    assert [len(dsp.due_rows(p, k * p.b)) for k in range(4)] == [1] * 4
    assert p.agc_window > p.b * p.half
    assert mode_counts(p, c.mix) == [79, 31, 18, 0]
    t = traffic.listener_table(p, c.mix)
    assert not t.am_env.any()                  # every AM listener on the PLL
    hz = [p.hz(float(m)) for m in t.m_idx[t.active]]
    assert 0.5e6 <= min(hz) and max(hz) < 30e6
    levels = traffic.view_table(p, c.mix).level
    assert len(levels) == 128 and set(levels) == set(range(p.levels))
    nb = traffic.ring_blocks(p, c.mix)
    assert nb == 24
    assert nb * p.b * p.hop % (1 << c.mix["signal"]["period_log2"]) == 0


def test_config_is_the_shipped_toml():
    shipped = tomllib.loads(
        (REPO / "configs" / "config.example.rx888.toml").read_text())
    cfg = spec.cell(REPO, CELL).server_config
    inp = {k: v for k, v in shipped["input"].items()
           if k not in ("driver", "defaults")}
    assert {k: v for k, v in cfg["input"].items()
            if k not in ("driver", "defaults")} == inp
    assert cfg["input"]["driver"]["format"] == shipped["input"]["driver"][
        "format"]
    assert cfg["input"]["defaults"] == shipped["input"]["defaults"]
    assert cfg["tpu"] == shipped["tpu"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the tiny cell added as data files and
    entries, held to this cell's limits."""
    root = sdrbench_cells.make_root(tmp_path_factory.mktemp("bench"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "sdrbench" / "configs" / "tiny_real_b4.json").write_text(
        json.dumps({"name": "tiny_real_b4", "source": "tests",
                    "config": TINY_CONFIG, "assumed": {}, "reduced": []}))
    bench["configs"].append({"name": "tiny_real_b4", "source": "tests",
                             "file": "sdrbench/configs/tiny_real_b4.json",
                             "reduced": [], "why": "tests"})
    mix = sdrbench_cells.tiny_mix(
        "hf128", modes={"bands": TINY_BANDS},
        check={"start_steps": 3, "samples": 1, "stride": 3})
    (root / "sdrbench" / "traffic" / "tiny_hf.json").write_text(
        json.dumps(mix))
    bench["workloads"].append({"name": TINY, "config": "tiny_real_b4",
                               "traffic": "tiny_hf", "chips": 1,
                               "why": "tests"})
    (root / "sdrbench" / "limits" / f"{TINY}.json").write_text(
        (REPO / "sdrbench" / "limits" / f"{CELL}.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_tiny_cell_is_shaped_like_the_deployment(root):
    c = spec.cell(root, TINY)
    p = dsp.plan(c.server_config)
    assert (p.is_real, p.fmt, p.b, p.skip) == (True, "s16", 4, 4)
    assert p.b * p.half == 256 < p.agc_window == 600
    assert [len(dsp.due_rows(p, k * p.b)) for k in range(4)] == [1] * 4
    counts = mode_counts(p, c.mix)
    assert all(counts[:3]) and counts[3] == 0


# the harness refuses a process that has loaded JAX, as this one has (the
# tests' conftest), so each run is a process of its own
RUN = """
import json, sys, time
from pathlib import Path
from sdrbench import harness


def state_unchanged(drv):
    step = drv.pipe.step

    def broken(state, raw, *a, **kw):
        _, out = step(state, raw, *a, **kw)
        return state, out
    drv.pipe.step = broken


root, cell, fault = sys.argv[1:]
out = harness.run(cell, 2**31 + 4242, 1.2, False, root=Path(root),
                  device="cpu", t_process=time.perf_counter(),
                  fault={"none": None, "state_unchanged": state_unchanged}[
                      fault])
print(json.dumps(out))
"""


def run(root, fault="none"):
    got = subprocess.run([sys.executable, "-c", RUN, str(root), TINY, fault],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


def test_hf_mix_sound_run_is_correct(root):
    out = run(root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["steps_missing"]["value"] == 0
    assert out["checks"]["wf_bytes"]["value"] == 0


def test_hf_mix_carries_unchanged_is_not_correct(root):
    out = run(root, "state_unchanged")
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["audio_lsb"]["value"] > out["checks"][
        "audio_lsb"]["limit"]
