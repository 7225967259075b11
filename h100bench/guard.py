"""The import guard: the port's benchmark never loads JAX or the JAX
package. Module names are compared by their top-level name, the part
before the first dot, as a whole word, so ``proteingym_tpu_torch`` passes
and ``proteingym_tpu`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "proteingym_tpu"})


def forbidden_modules(names: Iterable[str] | None = None) -> List[str]:
    """The sorted names among ``names`` (default: ``sys.modules``) whose
    top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
