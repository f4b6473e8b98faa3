"""Find a cell's pieces by name.

``BENCHMARK.json`` ties a cell (``workloads[].name``) to a
configuration and a traffic mix; the pieces live in files of their own:

- ``configs[].file``: the deployment (``config``: the dictionary the
  port's ``config_from_dict`` takes; ``source``, ``assumed``,
  ``reduced``);
- ``sdrbench/traffic/<traffic>.json``: the mix (see ``traffic.py``);
- ``sdrbench/metrics/<metric>.py``: one per-layer metric and its reader;
- ``sdrbench/limits/<cell>.json``: the limit of each number the
  comparison reads, set from that cell's readings.

Adding a cell, a mix, a configuration or a metric is a new file and a
new entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict          # the config file's whole object
    mix: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def server_config(self) -> dict:
        return self.config["config"]


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str) -> Cell:
    bench = load(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(wl)})")
    w = wl[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / cfgs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "sdrbench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    lim = root / "sdrbench" / "limits" / f"{name}.json"
    return Cell(
        name=name, config_name=w["config"], traffic=w["traffic"],
        chips=int(w["chips"]), config=config, mix=mix,
        limits=json.loads(lim.read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_module(root: Path, name: str) -> ModuleType:
    """The reader of per-layer metric ``name``."""
    path = root / "sdrbench" / "metrics" / f"{name}.py"
    mod_name = "sdrbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod
