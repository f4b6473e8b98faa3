"""The import guard: top-level names compared whole, the reference
kept apart from the program, the port loaded from the checkout."""

import shutil
import sys

import sdrbench_cells
from sdrbench import guard

REPO = sdrbench_cells.REPO


def test_names_compared_whole():
    assert guard.banned_loaded(["phantomsdr_tpu_torch.ops.cuda",
                                "numpy", "torch"]) == []
    assert guard.banned_loaded(["phantomsdr_tpu.ops", "jaxlib.xla_client",
                                "flax", "jax._src"]) == [
        "flax", "jax", "jaxlib", "phantomsdr_tpu"]
    assert guard.banned_loaded(["jaxtyping", "jax_tools"]) == []


def test_sources_are_clean():
    assert guard.check_sources(REPO / "sdrbench") == []


def test_reference_importing_the_program_is_caught(tmp_path):
    shutil.copytree(REPO / "sdrbench", tmp_path / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    ref = tmp_path / "sdrbench" / "reference" / "dsp.py"
    ref.write_text("from phantomsdr_tpu_torch.ops import agc\n"
                   + ref.read_text())
    got = guard.check_sources(tmp_path / "sdrbench")
    assert len(got) == 1 and "phantomsdr_tpu_torch" in got[0]
    harness = tmp_path / "sdrbench" / "harness.py"
    harness.write_text("import jax.numpy as jnp\n" + harness.read_text())
    assert len(guard.check_sources(tmp_path / "sdrbench")) == 2


def test_reference_imports_only_torch_and_numpy():
    for path in (REPO / "sdrbench" / "reference").rglob("*.py"):
        assert guard.imports_of(path) <= {"__future__", "math",
                                          "dataclasses", "typing", "numpy",
                                          "torch"}, path


def test_program_location(tmp_path):
    import phantomsdr_tpu_torch  # noqa: F401

    assert guard.check_program_location(REPO) is None
    assert "outside" in guard.check_program_location(tmp_path)


def test_this_process_loads_no_jax():
    import sdrbench.harness  # noqa: F401

    assert guard.banned_loaded() == [], sorted(
        m for m in sys.modules if m.split(".")[0] in guard.BANNED)
