"""repro_torch — the blocked, device-resident AMG path in PyTorch + CUDA.

A second package beside the JAX reference ``repro``, with the same module
layout and names.  Host symbolic work (plans, structures, aggregation)
stays numpy; numeric payloads are torch tensors on an explicit device.
Every Pallas kernel on the main path has a hand-written CUDA counterpart
under ``repro_torch.kernels`` (``csrc/*.cu``), launched on CUDA tensors;
CPU tensors take each kernel's plain PyTorch version.

Subpackages:
  core     blocked containers, COO assembly, SpMV, SpGEMM/PtAP, smoothers,
           V-cycle, PCG and the GAMG setup/recompute/solve front door
  fem      Q1/Q2 hex elasticity (numpy) and host assembly
  kernels  device resolution, the CUDA library build, four kernel families
  robust   solve health flags
  configs  the paper's elasticity configuration
  interop  numpy -> port objects, for holding the port against ``repro``
"""
