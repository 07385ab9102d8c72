"""repro_torch — the blocked, device-resident AMG path in PyTorch + CUDA.

A second package beside the JAX reference ``repro``, with the same module
layout and names.  Host symbolic work (plans, structures, aggregation)
stays numpy; numeric payloads are torch tensors on an explicit device.
Every Pallas kernel of ``repro`` (seven) has a hand-written CUDA
counterpart under ``repro_torch.kernels`` (``csrc/*.cu``), launched on
CUDA tensors;
CPU tensors take each kernel's plain PyTorch version.

Subpackages and modules:
  core        blocked containers, COO assembly, SpMV/SpMM, SpGEMM/PtAP,
              smoothers, aggregation (host greedy, device Luby-MIS),
              V-cycle (transpose-free or stored restriction), PCG, the
              precision policies and the GAMG setup/recompute/solve front
              door
  fem         Q1/Q2 hex elasticity (numpy), host assembly and device
              assembly (batched quadrature, coefficient updates)
  multirhs    masked panel PCG and the bucketing solve server
  kernels     device resolution, the CUDA library build, the seven kernel
              families (f64, f32, bf16), the lanes map, the autotuner
  robust      solve health flags, fault injection, the recovery ladder
  obs         host metrics, the server's instruments, transfer counts
  configs     the paper's elasticity configuration and the LM architecture
              zoo (``registry``)
  models      the LM scaffold: configs, layers, the stacked decoders and
              the whisper encoder-decoder, the sharding rules
  train       the serve steps (``make_prefill``, ``make_serve_step``,
              ``make_init``)
  interop     numpy -> port objects, for holding the port against ``repro``
  quickstart  ``python -m repro_torch.quickstart [m]``: the twin of
              ``examples/quickstart.py``
  serve_lm    ``python -m repro_torch.serve_lm``: the twin of
              ``examples/serve_lm.py``
"""
