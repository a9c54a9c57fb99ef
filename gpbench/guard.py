"""What the benchmark must never load: JAX, its libraries, and the JAX
package the port was made from. Names are compared by their top-level
part (before the first dot) as a whole, so ``george_tpu_torch`` passes."""

import sys

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "george_tpu"))


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
