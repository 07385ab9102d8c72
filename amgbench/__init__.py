"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
blocked AMG hot loop and the multi-RHS solve server on one H100.  The
entry point is ``run.py``; ``reference/`` is the plain yardstick."""
