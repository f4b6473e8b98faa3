"""The import guard: the benchmark measures the PyTorch and CUDA port
and nothing else.

- No module loaded in the process may have the top-level name (the part
  before the first dot, compared whole) ``jax``, ``jaxlib``, ``flax`` or
  ``phantomsdr_tpu``; ``phantomsdr_tpu_torch`` is the port and is
  allowed, though its name begins with the last.
- Nothing under ``sdrbench/reference/`` imports the port (or JAX): the
  reference takes nothing from the program.
- The port is imported from the checkout the benchmark runs in, never
  from an installed copy.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

BANNED = frozenset({"jax", "jaxlib", "flax", "phantomsdr_tpu"})
PROGRAM = "phantomsdr_tpu_torch"
HERE = Path(__file__).resolve().parent


def top(name: str) -> str:
    return name.split(".")[0]


def banned_loaded(modules=None) -> list[str]:
    """Banned top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names} & BANNED)


def imports_of(path: Path) -> set[str]:
    """Top-level names a Python file imports (absolute imports only;
    relative ones stay inside its package)."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top(node.module))
    return out


def check_sources(root: Path = HERE) -> list[str]:
    """Faults in the benchmark's own sources: a banned import anywhere,
    the program imported by the reference."""
    faults = []
    for path in sorted(root.rglob("*.py")):
        names = imports_of(path)
        bad = names & BANNED
        if path.is_relative_to(root / "reference") and PROGRAM in names:
            bad = bad | {PROGRAM}
        if bad:
            faults.append(f"{path.relative_to(root.parent)} imports "
                          f"{', '.join(sorted(bad))}")
    return faults


def check_program_location(checkout: Path) -> str | None:
    """None when the port is imported from ``checkout``; else why not."""
    mod = sys.modules.get(PROGRAM)
    if mod is None or mod.__file__ is None:
        return f"{PROGRAM} is not imported"
    where = Path(mod.__file__).resolve()
    if not where.is_relative_to(checkout.resolve()):
        return f"{PROGRAM} imported from {where}, outside {checkout}"
    return None
