"""The benchmark's pieces, found by the names that ``BENCHMARK.json`` and
the traffic files give them: ``perfbench/<kind>/<name>.py``.  A later
change adds a piece as a new file of its kind and edits none."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


def module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py``, loaded once a process (a name may
    hold dots, as a metric's does, so it is loaded from its path)."""
    key = f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise ValueError(f"no {kind[:-1]} named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]
