"""Tiny cells for the benchmark's CPU tests: a temporary copy of the
benchmark (``BENCHMARK.json`` and ``sdrbench/``) with two more
configurations, two more traffic mixes and their workloads entries
added, as a later change would add them, without editing a file.

``later/`` holds the data of the cells left for a later change (the
RX888 deployment and three more mixes): ``with_later`` adds them to a
copy the same way."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
LATER = Path(__file__).resolve().parent / "later"
LATER_CELLS = {"rx888.mixed64": ("rx888_s16_fft1m", "mixed64"),
               "iq35.noam128": ("iq35_u8_fft1m", "noam128"),
               "rx888.ssb64": ("rx888_s16_fft1m", "ssb64")}

TINY_CONFIGS = {
    # a 4096-point FFT, 4 (IQ) or 12 (real) hops a step, 16 listener
    # slots; audio at 3 kHz so the AGC's look-ahead (600 samples) fills
    # within the stream's first two steps
    "tiny_iq": {"input": {"sps": 48000, "frequency": 1000000,
                          "fft_size": 4096, "signal": "iq",
                          "audio_sps": 3000, "waterfall_size": 256,
                          "driver": {"format": "u8"}},
                "tpu": {"hop_batch": 4, "max_channels": 16}},
    "tiny_real": {"input": {"sps": 96000, "frequency": 0, "fft_size": 4096,
                            "signal": "real", "audio_sps": 3000,
                            "waterfall_size": 256,
                            "driver": {"format": "s16"}},
                  "tpu": {"hop_batch": 12, "max_channels": 16}},
}


def tiny_mix(repo_mix: str, **over) -> dict:
    path = REPO / "sdrbench" / "traffic" / f"{repo_mix}.json"
    if not path.exists():
        path = LATER / "traffic" / f"{repo_mix}.json"
    mix = json.loads(path.read_text())
    mix.update(listeners=16, views={"count": 16, "level_step": 7,
                                    "start_step": 131},
               placement={"l_from": 100, "r_margin": 400, "width_max": 300},
               ring={"min_blocks": 8, "min_mb": 0},
               window={"steady_steps": 2},
               check={"start_steps": 2, "samples": 1, "stride": 3})
    mix["signal"] = dict(mix["signal"], period_log2=13)
    mix.update(over)
    return mix


def make_root(tmp: Path) -> Path:
    """The copy, with cells ``tiny.mixed`` (tiny_iq, every mode) and
    ``tiny.ssb`` (tiny_real, LSB under 20 kHz, USB above)."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "sdrbench", root / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        (root / "sdrbench" / "configs" / f"{name}.json").write_text(
            json.dumps({"name": name, "source": "tests", "config": cfg,
                        "assumed": {}, "reduced": []}))
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": f"sdrbench/configs/{name}.json",
                                 "reduced": [], "why": "tests"})
    (root / "sdrbench" / "traffic" / "tiny_mixed.json").write_text(
        json.dumps(tiny_mix("mixed128")))
    (root / "sdrbench" / "traffic" / "tiny_ssb.json").write_text(
        json.dumps(tiny_mix("ssb64",
                            modes={"bands": [[20000, "LSB"], [None, "USB"]]})))
    bench["workloads"] += [
        {"name": "tiny.mixed", "config": "tiny_iq", "traffic": "tiny_mixed",
         "chips": 1, "why": "tests"},
        {"name": "tiny.ssb", "config": "tiny_real", "traffic": "tiny_ssb",
         "chips": 1, "why": "tests"}]
    # the tiny cells are held to the north-star cell's limits
    limits = (REPO / "sdrbench" / "limits" / "iq35.mixed128.json").read_text()
    for cell in ("tiny.mixed", "tiny.ssb"):
        (root / "sdrbench" / "limits" / f"{cell}.json").write_text(limits)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def with_later(root: Path) -> Path:
    """Adds the later cells' configuration, mixes, entries and (the
    north-star cell's) limits to the copy at ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for path in (LATER / "configs").glob("*.json"):
        shutil.copy(path, root / "sdrbench" / "configs" / path.name)
        bench["configs"].append({"name": path.stem, "source": "tests",
                                 "file": f"sdrbench/configs/{path.name}",
                                 "reduced": [], "why": "tests"})
    for path in (LATER / "traffic").glob("*.json"):
        shutil.copy(path, root / "sdrbench" / "traffic" / path.name)
    limits = (REPO / "sdrbench" / "limits" / "iq35.mixed128.json").read_text()
    for cell, (config, mix) in LATER_CELLS.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "tests"})
        (root / "sdrbench" / "limits" / f"{cell}.json").write_text(limits)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
