"""The benchmark measures the PyTorch and CUDA port alone: no process that
prints a result may hold JAX or the JAX package. Modules are compared by
their top-level name (the part before the first dot), whole, because the
port's name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tokenflow_tpu"})


def loaded_forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def check(when: str) -> None:
    found = loaded_forbidden()
    if found:
        raise RuntimeError(f"{when}: the process holds {', '.join(found)}; the benchmark "
                           "measures the PyTorch port alone")
