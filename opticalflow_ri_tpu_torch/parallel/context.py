"""Call-time context routing solver adapters to their kernel-sharded paths
(port of ``parallel/context.py``).

``auto_sharded_pipeline``'s route 2 runs a whole configuration (pyramid
levels, warps, filters, the adapter protocol) on this rank's tiles.  While
``kernel_sharded_solvers(mesh)`` is active, the pyramid's glue runs on the
tiles (``parallel/sharded_glue.py``) and the HS, Liu-Shen, LK and Farneback
adapters route their solves through the sharded kernel paths
(``parallel/sharded_kernel.py``) on the context's mesh.  The JAX package's
``interpret`` flag has no counterpart: a CPU tile runs the kernels' plain
versions, as everywhere in the port.

Import-cycle note: this module must stay dependency-free (the models and
the pyramid import it inside ``compute`` at call time; ``parallel/__init__``
imports the models via ``sharded.py``).
"""

from __future__ import annotations

import contextlib
import contextvars

# context-local (not process-global): a call on another thread must not
# inherit this call's mesh routing
_CTX: contextvars.ContextVar = contextvars.ContextVar("kernel_shard_ctx", default=None)


@contextlib.contextmanager
def kernel_sharded_solvers(mesh):
    """While active, the pyramid runs its glue on this rank's tiles and the
    solver adapters (HS, LS, LK, FB) run their kernel-sharded paths on
    ``mesh``.  A tile those paths refuse raises ``ValueError``: nothing
    falls back to a single-device solve."""
    token = _CTX.set(mesh)
    try:
        yield
    finally:
        _CTX.reset(token)


def current_kernel_shard():
    """The mesh of the active context, or None."""
    return _CTX.get()
