"""BENCHMARK.json against the benchmark's contract, and every cell's
pieces found by name: its configuration, traffic mix, limits and
per-layer metrics; a cell added as one traffic file and one workloads
entry is picked up without editing a file."""

import json
import re

import pytest

import sdrbench_cells
from sdrbench import spec, traffic
from sdrbench.reference import dsp

REPO = sdrbench_cells.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "sdrbench"]
    assert BENCH["paths"] == ["sdrbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"msps", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        mod = spec.metric_module(REPO, m["name"])
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["name"], m["unit"], m["layer"], m["moves"])
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"


def test_workloads_one_chip_and_distinct():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = spec.cell(REPO, cell)
    assert c.config["name"] == c.config_name
    assert not c.config["reduced"]
    p = dsp.plan(c.server_config)
    table = traffic.listener_table(p, c.mix)
    views = traffic.view_table(p, c.mix)
    assert table.active.sum() == c.mix["listeners"] <= p.c
    assert len(views.level) == c.mix["views"]["count"]
    assert set(c.limits) == {"audio_lsb", "power_rel", "wf_bytes"}
    assert traffic.ring_blocks(p, c.mix) >= 8
    assert {m["name"] for m in c.end_to_end} == {"msps", "setup_s"}


def _find(kind, name):
    for base in (REPO / "sdrbench", sdrbench_cells.LATER):
        path = base / kind / f"{name}.json"
        if path.exists():
            return json.loads(path.read_text())
    raise FileNotFoundError(name)


def _mix(name):
    return _find("traffic", name)


def _config(name):
    return _find("configs", name)["config"]


def test_north_star_and_rx888_plans():
    iq = dsp.plan(_config("iq35_u8_fft1m"))
    assert (iq.r, iq.a, iq.levels, iq.skip, iq.base_idx) == (
        1 << 20, 360, 11, 6, (1 << 19) + 1)
    assert iq.b * iq.hop == 18_874_368
    rx = dsp.plan(_config("rx888_s16_fft1m"))
    assert (rx.r, rx.a, rx.levels, rx.skip, rx.base_idx) == (
        1 << 19, 180, 10, 12, 0)
    assert rx.b * rx.hop == 50_331_648


@pytest.mark.parametrize("config,mix,want", [
    ("iq35_u8_fft1m", "mixed128", [32, 32, 32, 32]),
    ("iq35_u8_fft1m", "noam128", [43, 43, 0, 42]),
    ("rx888_s16_fft1m", "mixed64", [16, 16, 16, 16]),
    ("rx888_s16_fft1m", "ssb64", None)])
def test_modes_of_the_mixes(config, mix, want):
    """Every mix resolves, the cells of BENCHMARK.json and those left
    for later (``sdrbench/tests/later``) alike."""
    p = dsp.plan(_config(config))
    m = _mix(mix)
    t = traffic.listener_table(p, m)
    got = [int((t.mode[t.active] == k).sum()) for k in range(4)]
    if want is None:     # LSB under 10 MHz, USB above
        usb, lsb, am, fm = got
        assert am == fm == 0 and usb + lsb == 64 and 0 < lsb < 64
        hz = [p.hz(float(x)) for x in t.m_idx[t.active]]
        lsb_rows = t.mode[t.active] == 1
        assert max(h for h, s in zip(hz, lsb_rows) if s) < 10e6
        assert min(h for h, s in zip(hz, lsb_rows) if not s) >= 10e6
    else:
        assert got == want
    assert len(traffic.view_table(p, m).level) == m["views"]["count"]


def test_added_cell_is_found_by_name(tmp_path):
    """The tiny cells are added to a copy as a later change adds one: a
    configuration file, a traffic file and their entries; every file
    the copy shares with the repository is byte for byte the same."""
    root = sdrbench_cells.make_root(tmp_path)
    c = spec.cell(root, "tiny.ssb")
    assert c.traffic == "tiny_ssb" and c.config_name == "tiny_real"
    assert c.limits == json.loads(
        (REPO / "sdrbench/limits/iq35.mixed128.json").read_text())
    src = REPO / "sdrbench"
    for path in src.rglob("*"):
        rel = path.relative_to(src)
        if path.is_file() and rel.parts[0] != "tests" \
                and "__pycache__" not in rel.parts:
            assert (root / "sdrbench" / rel).read_bytes() == \
                path.read_bytes(), rel


@pytest.mark.parametrize("cell", sorted(sdrbench_cells.LATER_CELLS))
def test_later_cells_are_data_only(tmp_path, cell):
    """A cell left for later is added by data files and entries alone,
    and every piece of it is found by name."""
    root = sdrbench_cells.with_later(sdrbench_cells.make_root(tmp_path))
    c = spec.cell(root, cell)
    p = dsp.plan(c.server_config)
    table = traffic.listener_table(p, c.mix)
    assert table.active.sum() == c.mix["listeners"] <= p.c
    assert [m["name"] for m in c.end_to_end] == [
        m["name"] for m in BENCH["end_to_end"]]
    for m in c.per_layer:
        assert spec.metric_module(root, m["name"]).NAME == m["name"]


def test_unknown_cell():
    with pytest.raises(KeyError):
        spec.cell(REPO, "no.such.cell")
