"""Package re-exports that import their module on first use."""

from __future__ import annotations

import importlib
from typing import Callable


def lazy_exports(package: str, table: dict[str, str]) -> Callable[[str], object]:
    """A module `__getattr__` for `package` that resolves each name of
    `table` (name -> submodule) from its submodule when first asked for.
    So importing one host module of a package (the finishing workers'
    numpy-only ones) loads none of its torch modules."""
    def __getattr__(name: str):
        if name in table:
            return getattr(importlib.import_module(f"{package}.{table[name]}"), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return __getattr__
