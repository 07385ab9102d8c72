"""Multi-RHS blocked solves (torch twin of ``repro.multirhs``).

* ``block_krylov`` — batched PCG with per-column convergence masking, and
  the panel-solve builder over a ``GAMGSetup``.
* ``server``       — a solve server that buckets request streams into a
  small set of panel widths, runs panel solves on the cached hierarchy
  and reports per request.
"""
from repro_torch.multirhs.block_krylov import (  # noqa: F401
    BlockCGResult,
    block_pcg,
    make_block_solve,
)
from repro_torch.multirhs.server import AMGSolveServer, SolveReport  # noqa
