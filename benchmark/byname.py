"""Files of the benchmark found by name: ``<here>/<kind>/<name>.py``.

Whatever belongs to one metric, one entry point or one data recipe is a
file of its own, so a later cell adds files and edits none: the readers
(``end_to_end/``, ``metrics/``), the traffic files' entry points beyond
``harness.ENTRIES`` (``entries/``, each ``call(port, pairs, opts,
device)``) and the configurations' data recipes beyond
``generate.RECIPES`` (``recipes/``, each ``pair(model, data, rng)``).
"""

from __future__ import annotations

import importlib.util
import os


def load(here: str, kind: str, name: str):
    """The module ``<here>/<kind>/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_"),
        os.path.join(here, kind, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
