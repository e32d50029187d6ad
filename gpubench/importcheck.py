"""Which loaded modules a run may not hold.

Names are compared by their top-level part (before the first dot), whole:
``zig_tfhe_tpu_torch`` is the program under test, ``zig_tfhe_tpu`` the JAX
package it was ported from, and only the latter is refused in a run.
"""

from __future__ import annotations

import ast
from pathlib import Path

REFUSED = frozenset({"jax", "jaxlib", "flax", "zig_tfhe_tpu"})
# what the plain reference may not import besides
REFUSED_IN_REFERENCE = REFUSED | {"zig_tfhe_tpu_torch"}


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def refused(modules, names=REFUSED) -> list:
    """The module names whose top-level part is one of ``names``."""
    return sorted(m for m in modules if top_level(m) in names)


def imports_of(path: Path) -> set:
    """The modules a Python source imports (absolute imports only)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module)
    return found
