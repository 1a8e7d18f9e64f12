"""Model families: ``<family>.py`` holds what belongs to one family (the
sizes it reads from a configuration file, the program's config switches
it sets and checks, its weight leaves, its matmul parameters and its layer
of the plain reference), found by the ``family`` a configuration names.
A family file imports nothing of the program."""
from __future__ import annotations

import importlib
from types import ModuleType


def family(name: str) -> ModuleType:
    return importlib.import_module(f"{__name__}.{name}")
