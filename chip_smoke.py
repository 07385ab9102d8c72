#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the seven hand-written CUDA kernels from ``src/repro_torch/
kernels/csrc`` (each at f64, f32 and bf16 payloads) and drives sixteen
paths of the port, each with the launch counts set to 0 just before it
and read just after, the observability layer and the torch
quickstart.  The autotuner's cache is a fresh temporary file
(``REPRO_TORCH_TUNE_CACHE``), and every path but the tune path runs with
``REPRO_TORCH_TUNE=off`` (the static 256-thread launch).  The first
four run the paper's configuration ``ElasticityConfig(m=32)`` on the host
assembly path and the greedy coarsener, which its pinned numbers were
taken on:

1. the main path — blocked-COO assembly, cold GAMG setup, then 3 hot steps
   of reassembly, ``update_operator`` (the PtAP chain) and the AMG-PCG
   solve (13 iterations each), plus one profiled hot step;
2. the serve path — ``AMGSolveServer`` on the main path's setup, bursts of
   1, 3, 8, 5, 16 and 21 requests in panels of k in {1, 2, 4, 8, 16},
   ``update_operator`` and a burst of 4 copies of ``b`` (13 iterations on
   every column); per-column iterations equal dedicated vector solves;
3. the pairs path — one ``update_operator`` on the unfused "pairs" SpGEMM
   path (``REPRO_TORCH_SPGEMM_PATH=pairs``), held against the fused
   hierarchy (1e-12) and solved (13 iterations), with its peak memory
   beside the fused recompute's;
4. the tune path — the kernel autotuner (``repro_torch.kernels.autotune``)
   sweeps the ``threads`` knob of every (family, signature) the main and
   serve paths launched, plus ``pbjacobi`` at every level's ``dinv``
   shape, records the winners, and runs the CLI's ``smoke`` round trip
   on the card;
5. the MIS path — the reference's defaults as ``examples/quickstart.py``
   runs them (device assembly, the device Luby-MIS coarsener,
   ``coarse_size=40``) at m=12: levels ``[4752, 1212, 918, 66]``,
   aggregates per level ``[202, 153, 11]`` and equal to the port's on the
   CPU, 3 hot steps of 9 iterations whose solutions the same steps on the
   CPU setup match within 1e-9;
6. the coefficient path — ``ElasticityConfig(m=32)`` as built (device
   assembly, its assembler bound to the solver; the main path's levels),
   then ``examples/heterogeneous.py``'s four inclusion contrasts through
   ``update_coefficients`` and a solve each (healthy), the
   device-assembled A within 1e-12 of the host path's, and a server's
   ``update_coefficients`` and burst;
7. the precision path (run last, after the byte witness below) — the
   main path's configuration under the ``"f32"`` and then the ``"bf16"``
   policy (``GAMGSolver(..., precision=)``; the
   hierarchy at that dtype, the outer CG at f64 on the f64
   ``a_fine_ell``): setup (levels ``[95232, 7986, 5016, 114]``), 3 hot
   steps and a profiled one (iterations, relres, health, the solution's
   difference from the f64 main path's; f32 must converge to 1e-8 every
   step), the payload dtypes of every level, the hierarchy's bytes and an
   ``update_operator``'s peak, a burst of 4 requests through
   ``AMGSolveServer`` (whose Krylov operator must be bitwise the f64 fine
   values' ELL), one ``pairs`` recompute held against the fused one, and
   the autotuner's sweep of ``pbjacobi`` at that dtype.  Then every
   kernel at that dtype's m=32 shapes against its plain version (within
   2e-5 of the largest term at f32, 5e-2 at bf16, the reference's own
   tolerances), the bitwise contracts of ``check_bitwise`` and every
   ``threads`` candidate bitwise; each of the seven kernels must launch
   at that dtype on the path;
8. the stored path (after the pairs path) — the main path's
   configuration with ``restriction="stored"``: levels ``[95232, 7986,
   5016, 114]``, each ``R``'s shape and fill (``R0`` has 6x3 blocks), the
   3 hot steps in turns with the transpose-free solver (13 iterations,
   solutions within 1e-12 of it, both step times) and a burst of 4
   requests through ``AMGSolveServer``; ``block_spmv`` and ``block_spmm``
   must launch on 6x3 blocks.  ``R0``, ``R1`` and ``R2`` join the kernel
   cases of ``block_spmv`` and ``block_spmm`` (k=4, 16) at every dtype
   (their bound counts the valid blocks; the padded slots and the fill
   are on their lines) and the bitwise column checks.  One stored hot
   step is profiled (``profiled stored hot step``), and the stored path
   line gives the device ms ``R2``'s products take in it;
9. the robust path (after the byte witness) — the recovery ladder on the
   main path's step-0 values: ``RobustSolver`` healthy (bitwise the main
   path's step-0 solution), a transient ``precond:nan@3`` (recovered by
   ``recompute``, bitwise; a second solve under the schedule ``ok``), the
   same fault persistent (every rung, the last on the ``pairs`` kernels,
   status ``degraded`` as the reference's at m=6; an ``update_operator``
   after it still launches ``block_pair_gemm``), the ``"bf16"`` policy whose coarse factor is NaN on these
   values (recovered by ``f64-rebuild``, 13 iterations, within 1e-12 of
   f64's) and a server with ``recover=`` under a transient fault (the
   faulted column ``recovered``, its neighbours ``ok``).  Then
   ``python -m repro_torch.quickstart 9`` runs on the card as a child
   process beside the same run on the CPU: equal levels and iterations;
10. the march path (after the coefficient path) — ``repro_torch.sim``'s
   time march at m=32 on the device-assembled problem with the paper's
   greedy setting: ``SofteningScenario`` (rate ``MARCH_RATE``),
   ``MARCH_STEPS`` steps under ``frozen``, ``adaptive`` and ``resetup``
   in turns (each ``ok``, every step healthy; the adaptive march sets up
   at least twice and fewer times than ``resetup``), per mode the
   setups, segments, iterations per step and ms per step, then every
   kernel against its plain version on the hierarchy of the adaptive
   march's final fields (``march kernel case``).  ``march cpu vs cuda``
   runs ``python -m repro_torch.march``'s setting at m=5 (the
   reference's acceptance battery) on both: equal iterations, statuses,
   segments and setups, final states within 1e-10;
11. the scalar path (after the observability phase) — the scalar (AIJ)
   baseline (``core.scalar_path``) on the main path's m=32 setup: the
   cold expansion, ``recompute_scalar`` against ``gamg.recompute`` and
   the scalar hot solve against the blocked one, in turns (13
   iterations each, the solutions within 1e-6, ms of both), A0's SpMV
   blocked, 1x1 and through cuSPARSE CSR, both formats' bytes (A0 by
   the paper's formulas, ``EXPECT_A0_BYTES``) and Galerkin pair counts,
   a profiled scalar solve held to the launch record; the scalar solve
   on the CPU and on the card at m=7 (equal iterations, within 1e-12);
   the scalar PtAP chain at m=16 (within 1e-11 of the expanded blocked
   chain; the m=32 scalar plans' host symbolic would need tens of GB).
   Each of the four scalar entries (``SCALAR_KERNELS``: ``block_spmv``,
   ``fused_pair_gemm`` and ``block_seg_sum`` at 1x1 and the scalar-row
   ``fused_smoother``) must launch on the path; then every 1x1 and
   scalar-row case against its plain version (``scalar kernel case``)
   and the scalar smoother's identity step bitwise ``b -
   block_spmv(x)`` on every level;
12. the dist path (after the precision path) — ``python -m
   repro_torch.dist.selftest 32`` as child processes on the card
   (``repro_torch.dist``: row slabs, halo exchanges, the distributed PtAP
   and CG): NCCL at world size 1
   (recompute + solve, 13 iterations as the single-device card solve,
   the solution's difference from it, the hot step's wall beside the
   single-device one) and gloo at world size 4, the four ranks sharing
   the one card with every halo payload staged through host memory (a
   quarter of the rung per rank): level 0's halo ``ppermute``, the
   placement ``[sharded, sharded, sharded, replicated]``, 13 iterations
   and the solution within 1e-10 of the single-device solve, overlap on
   against off bitwise, the agglomerated placement against the sharded
   one (equal iterations), a ``halo:nan`` fault flagged ``nonfinite`` on
   every rank then a clean re-staging bitwise, a k=4 panel's per-column
   iterations equal to the single-device ``block_pcg``'s, and the
   messages and bytes of one V-cycle against ``dist_cycle_comm``.  Both
   children also run the coefficient program (``--coeff``:
   ``make_dist_coeff_solver``, each rank assembling its fine payload slab
   from two coefficient slabs with one ``block_seg_sum`` launch) on the
   inclusion fields and the warm march over the wire (``--march``: 3
   softening steps, each rank's x slab fed back as the next x0 slab).
   ``dist coeff <label>`` holds the coefficient solve to the
   single-device card coefficient solve (equal iterations, within
   1e-10), the rank slabs against the global assembly (bitwise, then the
   x slabs bitwise the value-stream program's; else the largest
   difference, within 1e-14, and equal iterations), one rank-assembly
   launch per rank a call, the k=4 panel through it (world 4: per-column
   iterations equal to the single-device panel's and vector solves'; the
   ``halo:nan`` fault flagged ``nonfinite`` on every rank), and an f32
   caller's repeat update (staged at f64, no rank operand
   restaged, its host-to-device bytes the two coefficient slabs, ``2 *
   epad * 8``); it prints rank 0's ``epad``, those bytes, and the hot
   step's wall beside the single-device coefficient solve's.  ``dist
   march <label>`` holds each step's iterations to the single-device
   ``gamg.make_coeff_solve``'s, the solutions within 1e-10, the last warm
   step to at most a cold one's, the rank operands staged once, and 0
   host-to-device bytes a step (the fields are made on the card), with
   the walls of both.  The slab applies and the rank assembly's
   ``block_seg_sum`` (its ms, byte bound and ``index_add_``'s ms) are
   held against their plain versions at those shapes (``dist kernel
   case``); the children's launches, counted around the dist calls only
   and summed over the ranks, are the ``dist`` column of the record,
   where ``block_spmv``, ``block_spmm``, ``block_pair_gemm`` and
   ``block_seg_sum`` must appear, and the coefficient program's own calls
   must launch ``block_seg_sum``, ``block_spmv`` and ``block_pair_gemm``.
   Their walls are printed, not read: four processes time-slicing one
   card say nothing of scaling;
13. the front doors (after the dist path) — the AMG entry points' torch
   twins as child processes on the card, each with its launches counted
   (``--front-door NAME M`` runs ``python -m repro_torch.NAME M``'s
   ``cli`` with the counts set to 0 just before it): ``serve_amg``,
   ``observe_amg`` and ``heterogeneous`` at m=12 in the reference
   examples' setting (device assembly, MIS, ``coarse_size=40``: levels
   ``[4752, 1212, 918, 66]``; every request converged, the tally equal
   to the analytic count, each coefficient update's host-to-device
   bytes the two fields, ``2 * 11^3 * 8``) and at m=7 beside the same
   twin run on the CPU in this process (levels, buckets and iterations
   equal); ``python -m repro_torch.dist.measure 5 2 1`` and ``5 2 2``
   (gloo ranks: one V-cycle's messages ``{14, 1, 15}``, the recompute's
   ``{6, 1, 7}`` with its power loop's body once, the model's 15
   messages and halo and gather bytes, the reference's numbers); and
   ``python -m repro_torch.amg_distributed`` at its default (8 gloo
   ranks at m=6 on the one card, MIS, ``coarse_size=30``) and at world
   1 (NCCL), each taking the single-device card solve's iterations.  The
   children's launches, summed, are the ``doors`` column of the record;
14. the LM phase — the LM models and the serving path
   (``repro_torch.models``, ``repro_torch.train.steps``), which launch no
   AMG kernel (the counts are set to 0 before it and must read 0 after:
   the record's ``lm`` column), all at f32 against ``LM_TOL`` (the
   reference's, elementwise): qwen2-0.5b at its full config (params drawn
   on the CPU, copied) with its 4 x 32-token prefill card against CPU and
   decode against prefill on the card, and falcon-mamba-7b at full width
   and ``LM_MAMBA_LAYERS`` layers (drawn on the card) with 70 tokens
   decoded against their prefill (past the selective scan's chunk of
   64; each decode step under CUDA's sync debug mode at "error": no
   step waits for the card), then at ``LM_MAMBA_CHECK_LAYERS`` layers
   card against CPU; both
   through the serve loop of ``examples/serve_lm.py`` (4 x (32 + 32)
   tokens) at f32 and bf16 with tok/s and peak memory (``lm full``
   lines); every arch at ``reduced()``, prefill and 3 decode steps with
   the cache, card against CPU (``lm reduced <arch> card vs cpu``); and
   ``python -m repro_torch.serve_lm`` as a ``--front-door`` child,
   whose greedy tokens must equal the same twin's on the CPU (``lm
   serve_lm``);
15. the train phase (last) — LM training (``repro_torch.train``:
   data, AdamW, the train step and its backward pass, checkpoints,
   restarts), again with no AMG kernel (the record's ``train`` column,
   0): qwen2-0.5b at its full config (``train full``: one f32 step at
   ``TRAIN_CHECK`` card against CPU, the loss and global norm within
   1e-5 relative and each gradient leaf within 1e-4 of its largest;
   ``TRAIN_BF16`` bf16 steps with ``examples/train_lm.py``'s optimizer,
   whose loss must fall, with ms a step, tok/s and peak memory; one
   profiled bf16 step; the step with the stacked layers indexed
   against unbound, in turns) and falcon-mamba-7b at full width and
   ``TRAIN_MAMBA_LAYERS`` layers (bf16 steps, every param moved; at
   ``LM_MAMBA_CHECK_LAYERS`` layers one f32 step over 70 tokens card
   against CPU, the scan's backward across chunks); every arch at
   ``reduced()`` card against CPU (``train reduced <arch> card vs
   cpu``); ``run_with_restarts`` at ``tests/test_fault_tolerance.py``'s
   settings (``train restart``: 2 restarts from steps 3 and 6, losses
   equal to the clean run at 1e-6, a corrupted newest checkpoint
   skipped); and as ``--front-door`` children ``python -m
   repro_torch.train_lm --steps 40`` (its loss falling), then ``--steps
   60`` in the same directory (resumed from step 40; ``train
   train_lm``), and ``python -m repro_torch.launch.train --arch
   qwen2-0.5b --steps 5``, its first loss within 1e-5 of the same twin's
   on the CPU (``train launch``);
16. the launch phase (last) — the launch layer (``repro_torch.launch``)
   as ``--front-door`` children: ``python -m repro_torch.launch.dryrun``
   for qwen2-0.5b and falcon-mamba-7b at their full configs over every
   shape on the ``single`` (256 devices), ``multi`` (512) and ``card``
   meshes, every row measured in this run (``--force``; falcon-mamba's
   ``train_4k`` and ``prefill_32k``, millions of aten ops traced whole,
   are traced at depths 1 and 2 and extrapolated), ``--probe`` for qwen2
   (each full row's FLOPs equal to its probe-corrected count within
   1e-9), ``--amg`` at m=21 (``LAUNCH_AMG_M``: the 256- and 512-rank
   stagings and the card row, the dist hot path at NCCL world 1, whose
   iterations must equal the single-device solve's, within 1e-10, and
   whose solution's true residual by the plain CPU product must be within
   the solve's tolerance; every launch of the child held against the
   kernel's plain version on its own inputs, ``KernelCheck``, one
   ``launch kernel check`` line a kernel) and ``python -m
   repro_torch.launch.roofline`` on the H100's constants.
   Every card row either ran (median ms and measured peak beside the
   trace's estimate) or is a SKIP with ``cell_applicable``'s reason or
   "exceeds one card"; no row may FAIL.  One ``launch`` line a row; the
   LM dry runs and the roofline launch no AMG kernel, the AMG rows'
   launches are the record's ``launch`` column.

The observability phase (after the stored path) profiles one hot step
through closures built under ``use("spans")``: every expected span
(``vcycle/level{i}/smooth|restrict|prolong``, ``vcycle/coarse``,
``recompute/level{i}/smoother_data|ptap``, ``recompute/coarse_chol`` and
the kernel families) in the trace with the device ms under it, and the
solution's SHA-256 equal to the off step's; a ``make_solve(obs=
"counters")`` and a ``make_block_solve(obs="counters")`` k=4 solve,
bitwise the off solves, with tallies equal to the analytic counts, the
extra device kernels a cycle of the tally and the modeled MB beside the
counted solve's device ms (``obs counters``); and the static profiled
hot step's device events beside PR 21's (``obs off``).

Every profiled hot step (static, tuned, stored, and one per precision) is
held to a witness: the library's kernel events in the profiler session
(by the ``__global__`` names of ``csrc/``) must number the launches the
library noted on the host across the step (``autotune.launch_record``);
a blind session's line names the launch whose event is missing (the
host's launch log against the events, in order), and the step is
profiled again in a child process (``--profile-witness``), three
sessions in all; the script fails when every one was blind.  The MIS and coefficient paths hold every
kernel against its plain version at their own shapes (``mis kernel case`` / ``coeff kernel case``
lines).  Last, ``chip_smoke.py --h2d-witness`` runs in a child process
(a fresh process, whose profiler records memcpy events): one profiler
session holds the coefficient path's four updates and, before and after
them, three 8 MiB control copies (``.to``, ``torch.as_tensor`` of an
array, ``torch.tensor`` of a list, the last out of the aten count's
sight).  Each control must read its size in the profiler's memcpy
bytes, and each update must move between its two per-element fields and
those plus 4 KB host to device by both the profiler and the aten count
(``repro_torch.obs.transfer``); the same session holds the second and
third steps of a frozen march segment and a second ``recompute_scalar``,
which must move 0 bytes by both.

After the main path it prints a ``coarse operators`` line: SHA-256 of the
setup's coarse operators and prolongators (all products of
``fused_pair_gemm``) and of the last hot-step solution, required equal to
``EXPECT_COARSE_SHA``.  It checks that each kernel ran on its path, then
holds every kernel
against its plain PyTorch version at the paths' shapes (max relative error
1e-12 at f64; kernels reorder sums), checks that ``block_spmm`` and the
panel ``fused_smoother`` are bitwise per column against ``block_spmv`` and
the vector step and that with ``dinv = I`` and ``coef = [0, 1]`` the
smoother's ``d'`` is bitwise ``b - block_spmv(x)`` on every level, times
kernel, plain version and a one-call PyTorch yardstick beside the kernel's
bound (device time per call: a batch of calls queued behind a sleep kernel
between CUDA events; the single-launch time, host enqueue included, beside
it), and compares the port on the CPU with the port on the card at m=7
(bitwise levels and aggregates, equal CG iterations, solutions within
1e-9, vector and k=4 panel solves) and runs ``heterogeneous.py`` at m=7 on
both (levels ``[882, 204]``, iterations 9, 10, 14, 17).  Every kernel case
carries ``floor_ms``: the empty kernel (``csrc/launch_floor.cu``) at the
case's grid, as the kernel library notes it for the case's one launch
(``autotune.launch_record``).  The ``launch floor`` and ``pbjacobi
cases`` lines give the pbjacobi cases' static and tuned
times beside their floors and byte bound, and require the outputs at every
``threads`` value to hash to ``EXPECT_PBJ_SHA`` (the first pbjacobi
kernel's).  For the tuned kernels it then launches
every ``threads`` candidate at the m=32 shapes and requires the output
bitwise equal to the 256-thread launch, times winner against default with
CUDA events, and runs a hot step and a k=16 panel solve static, tuned,
tuned, static (equal iterations, bitwise solutions), and profiles one
tuned hot step. Last, it sets the port up on the CPU at m=32 and compares
the card's aggregates with it: levels, nnzb and ``n_agg`` equal, and every
node in another aggregate traced back to greedy pass-2 ties within
``TIE_ULPS`` of the CPU's weights (the two operators differ by rounding;
m=7 stays bitwise). ``block_spmv``, ``block_spmm`` and ``fused_smoother``
give each block row a sub-warp of ``ell_rows.lanes(br, bc, kmax)`` lanes,
printed with each of their ``kernel case`` lines; a ``lanes sweep`` line
per case times every lanes value the C entries take beside the map's
choice.  Each ``fused_pair_gemm`` case line carries ``gather_bytes`` (valid
slots x lhs and rhs block bytes) and ``before_ms``, its static time before
the staged redesign.
The second-to-last line is the per-kernel JSON record (the f64 kernels
under their names, the f32 and bf16 instantiations as ``<name>_f32`` and
``<name>_bf16`` with the precision path's launches and cases; their
bounds take the datasheet's fp32 FLOP/s, the rate they compute at; the
scalar path's entries under their ``SCALAR_KERNELS`` names) and
the last line
``{"ok": true, "device": ...}``.  Any failure raises (exit code not 0).
Without a CUDA device, or outside a checkout, it exits with code 2 before
printing a result.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

REL_TOL = 1e-12          # kernel vs plain version, f64, scaled by max |plain|
SOLUTION_TOL = 1e-9      # port on CPU vs port on the card
MAIN_M = 32              # ElasticityConfig(m=32): the paper's one-device rung
EXPECT_LEVEL_ROWS = [95232, 7986, 5016, 114]
EXPECT_ITERS = 13        # the JAX reference's count on this configuration
CHECK_M, CHECK_COARSE = 7, 12
TIE_ULPS = 8             # m=32 aggregates: pass-2 ties that may flip
LANES = (1, 2, 4, 8, 16, 32)    # what the ELL kernels' C entries take
BUCKETS = (1, 2, 4, 8, 16)
BURSTS = (1, 3, 8, 5, 16, 21)   # 21 = a full 16 panel + 5 in an 8 panel
CHECKED_BURSTS = (3, 5)         # per column against dedicated solves
PANEL_KS = (16, 4)              # block_spmm cases
TUNE_K = 16                     # the tuned-vs-static panel solve
OMEGA = 0.6                     # pbjacobi cases (the autotuner's omega)
# quickstart's setting (device assembly, the MIS coarsener, coarse_size
# 40) at the largest m the reference's MIS reaches (ROADMAP Queue 3 item
# 5): the reference's levels, aggregates per level and iterations
MIS_M, MIS_COARSE = 12, 40
EXPECT_MIS_ROWS = [4752, 1212, 918, 66]
EXPECT_MIS_NAGG = [202, 153, 11]
EXPECT_MIS_ITERS = 9
# examples/heterogeneous.py: inclusion contrasts, and the reference's
# levels and iterations at m=7 (MIS, coarse_size 40)
CONTRASTS = (1.0, 10.0, 100.0, 1000.0)
HETERO_M, HETERO_COARSE = 7, 40
EXPECT_HETERO_ROWS = [882, 204]
EXPECT_HETERO_ITERS = [9, 10, 14, 17]
H2D_SLACK = 4096        # bytes a coefficient update may move beyond E, nu
H2D_FLAG = "--h2d-witness"      # the child process of h2d_check
PROFILE_FLAG = "--profile-witness"  # the child of a blind profiled step
PROFILE_TRIES = 3       # profiled-step sessions (the first in-process)
WARMUP_KERNELS = 16     # launches of a profiled step's warm-up
WINDOW_PAUSE_S = 0.02   # host pause between the profiled step and the
                        # edges of the recorded window
QUICKSTART_M = 9        # python -m repro_torch.quickstart's default m
# SHA-256 (first 16 hex digits) of the pbjacobi cases' outputs (L0, L1,
# L2 at the main path's dinv) as the first kernel produced them (omega
# read from device memory); every later kernel, at every threads value,
# must reproduce them (None: printed, not checked)
EXPECT_PBJ_SHA = {"L0": "e8fbc9c01e21ec0f", "L1": "77f796e092eb2dc0",
                  "L2": "2bd5d4b5cc866401"}
# SHA-256 (first 16 hex digits) of the card's m=32 setup operators and
# prolongators and of the last main-path hot-step solution, as the
# thread-per-element fused_pair_gemm produced them; any later kernel must
# reproduce them bit for bit (None: printed, not checked)
EXPECT_COARSE_SHA = {"A1": "1d2d80d209e5f844", "A2": "4564b2e3d97d46ba",
                     "A3": "ae5480626751045d", "P0": "242d9e8d4d6f8dbe",
                     "P1": "76983f98ab971769", "P2": "efe15001676b62a3",
                     "x": "6cfa8419b2e88538"}
# fused_pair_gemm static device ms per case before the staged redesign
# (NVIDIA H100 80GB HBM3, 700.00 W), shown beside each case's time
BEFORE_PAIR_GEMM_MS = {"level0 AP 813662x6": 0.3015,
                       "level0 R(AP) 143555x15": 0.2423,
                       "level1 AP 372548x4": 0.2888,
                       "level1 R(AP) 791472x6": 0.9601,
                       "level2 AP 136093x21": 0.4769,
                       "level2 R(AP) 536x409": 0.4204}

# Datasheet peaks of the card the port runs on, the H100 SXM ("NVIDIA H100
# 80GB HBM3"): HBM bytes/s and fp64 FLOP/s outside the tensor cores.
CARD = "H100 80GB HBM3"
PEAKS = (3.35e12, 34.0e12)
#: fp32 FLOP/s outside the tensor cores: the f32 and bf16 instantiations
#: compute at f32 (the datasheet's 67 TFLOP/s)
F32_FLOPS = 67.0e12

KERNELS = {
    "block_seg_sum": dict(
        source="src/repro_torch/kernels/csrc/block_seg_sum.cu",
        replaces="src/repro/kernels/block_seg_sum/block_seg_sum.py:49"),
    "block_spmv": dict(
        source="src/repro_torch/kernels/csrc/block_spmv.cu",
        replaces="src/repro/kernels/block_spmv/block_spmv.py:63"),
    "fused_smoother": dict(
        source="src/repro_torch/kernels/csrc/fused_smoother.cu",
        replaces="src/repro/kernels/fused_smoother/fused_smoother.py:74"),
    "fused_pair_gemm": dict(
        source="src/repro_torch/kernels/csrc/fused_pair_gemm.cu",
        replaces="src/repro/kernels/fused_pair_gemm/fused_pair_gemm.py:70"),
    "block_spmm": dict(
        source="src/repro_torch/kernels/csrc/block_spmm.cu",
        replaces="src/repro/kernels/block_spmm/block_spmm.py:49"),
    "block_pair_gemm": dict(
        source="src/repro_torch/kernels/csrc/block_pair_gemm.cu",
        replaces="src/repro/kernels/block_pair_gemm/block_pair_gemm.py:44"),
    "pbjacobi": dict(
        source="src/repro_torch/kernels/csrc/pbjacobi.cu",
        replaces="src/repro/kernels/pbjacobi/pbjacobi.py:35"),
}
#: the kernels of every hot step: assembly, recompute, solve
MAIN_KERNELS = ("block_seg_sum", "fused_pair_gemm", "fused_smoother",
                "block_spmv")
#: the kernels with a ``threads`` knob (the autotuner's families)
TUNED = ("block_spmv", "block_spmm", "pbjacobi", "fused_smoother",
         "fused_pair_gemm")
#: the precision path: the reduced-precision policies, and each one's
#: kernel-vs-plain tolerance of the largest term (the reference's own,
#: tests/test_kernels.py:41-48)
PRECISIONS = {"f32": 2e-5, "bf16": 5e-2}
PREC_BURST = 4           # requests of the precision path's serve burst
#: the obs phase: the kernel-family spans of a vector hot step, the panel
#: width of the counted panel solve, and the f64 static profiled hot
#: step's device events in PR 21's final run (PERF.md section 5)
KERNEL_SPANS = ("kernels/block_seg_sum", "kernels/fused_pair_gemm",
                "kernels/block_spmv", "kernels/fused_smoother",
                "apply_ell_t")
OBS_K = 4
PR21_HOT_EVENTS = 3778
#: the march phase at m=32 (softening rate, steps, StalenessConfig's
#: iter_drift / ref_window / coeff_rtol, the paper's setup setting) and
#: its CPU-vs-card check at m=5 (the reference's acceptance battery:
#: 8 steps, rtol 1e-10, coarse_size 8 with the MIS coarsener)
MARCH_RATE = 0.25
MARCH_STEPS = 6
MARCH_STALENESS = (2, 2, 0.25)
MARCH_SETUP = {"coarsener": "greedy", "coarse_size": 100}
MARCH_CHECK_M, MARCH_CHECK_STEPS = 5, 8
MARCH_TOL = 1e-10        # final state, CPU against the card
#: the scalar (AIJ) baseline: its 1x1 / scalar-row kernel entries (the
#: record's rows, each a subset of a family's launches: family and the
#: wrapper's ``launches_by_shape`` keys); the rung of its scalar PtAP chain
#: (the host symbolic of the scalar plans at m=32 would need tens of GB);
#: the chain's tolerance against the expanded blocked chain
#: (tests/test_scalar_chain.py); the CPU-vs-card check's m and tolerance;
#: A0's bytes by bcsr_matrix_bytes / csr_matrix_bytes at m=32
SCALAR_KERNELS = {
    "block_spmv_1x1": ("block_spmv", ((1, 1),)),
    "fused_smoother_scalar": ("fused_smoother", ((1, 3), (1, 6))),
    "fused_pair_gemm_1x1": ("fused_pair_gemm", ((1, 1, 1),)),
    "block_seg_sum_1x1": ("block_seg_sum", ((1, 1),)),
}
SCALAR_CHAIN_M = 16
SCALAR_CHAIN_TOL = 1e-11
SCALAR_CHECK_M, SCALAR_CPU_TOL = 7, 1e-12
EXPECT_A0_BYTES = {"bcsr": 61_363_736, "csr": 87_602_072}


def _ops():
    from repro_torch.kernels.block_pair_gemm import ops as pair
    from repro_torch.kernels.block_seg_sum import ops as seg
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.block_spmv import ops as spmv
    from repro_torch.kernels.fused_pair_gemm import ops as gemm
    from repro_torch.kernels.fused_smoother import ops as smooth
    from repro_torch.kernels.pbjacobi import ops as pbj
    return {"block_seg_sum": seg, "block_spmv": spmv,
            "fused_smoother": smooth, "fused_pair_gemm": gemm,
            "block_spmm": spmm, "block_pair_gemm": pair, "pbjacobi": pbj}


def reset_counts():
    for mod in _ops().values():
        mod.launches = 0
        mod.launches_by_dtype = dict.fromkeys(mod.launches_by_dtype, 0)
        if hasattr(mod, "launches_by_shape"):
            mod.launches_by_shape = dict.fromkeys(mod.launches_by_shape, 0)
        if hasattr(mod, "launches_by_body"):
            mod.launches_by_body = dict.fromkeys(mod.launches_by_body, 0)


def read_counts() -> dict:
    return {name: mod.launches for name, mod in _ops().items()}


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int = 15, warmup: int = 2) -> float:
    """Median milliseconds of one ``fn()`` between two CUDA events.  The
    card is idle when the first event is recorded, so a short kernel's
    number includes the host's time to enqueue it (kept beside the
    autotuner's ``device_ms`` as ``ms_single``)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------

def main_path(m: int, device, coarse_size: int | None = None,
              steps: int = 3, verbose: bool = True,
              precision: str = "f64",
              restriction: str = "transpose_free") -> dict:
    """Assemble, set up and run ``steps`` hot steps of the paper's loop
    through the port's entry points under the ``precision`` policy and
    ``restriction``; returns the objects and records."""
    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.core.gamg import GAMGSolver
    from repro_torch.fem.assemble import assemble_elasticity
    from repro_torch.robust.health import HEALTHY, STATUS_NAMES

    cfg = ElasticityConfig(m=m)
    if coarse_size is not None:
        cfg = ElasticityConfig(m=m, coarse_size=coarse_size)
    t0 = time.perf_counter()
    prob = assemble_elasticity(cfg.m, order=cfg.order, E=cfg.E, nu=cfg.nu,
                               path="host", device=device)
    sync(device)
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = GAMGSolver(prob.A, prob.B, theta=cfg.theta,
                        smoother=cfg.smoother, degree=cfg.degree,
                        coarse_size=cfg.coarse_size, coarsener="greedy",
                        rtol=cfg.rtol, maxiter=cfg.maxiter,
                        precision=precision, restriction=restriction)
    sync(device)
    t_setup = time.perf_counter() - t0
    stats = solver.setup_data.stats
    label = "" if precision == "f64" else f"{precision} "
    if verbose:
        print(f"{label}main path m={m}: n={prob.n} nnzb={prob.A.nnzb} "
              f"coo_inputs={prob.coo_plan.n_input} "
              f"assemble_s={t_asm:.3f} setup_s={t_setup:.3f} "
              f"level_rows={stats['level_rows']} "
              f"level_bs={stats['level_bs']}")
    records = []
    for step in range(steps):
        rec = {"step": step}
        c0 = read_counts()
        t0 = time.perf_counter()
        a_new = prob.reassemble(1.0 + 0.1 * step)
        sync(device)
        rec["reassemble_ms"] = 1e3 * (time.perf_counter() - t0)
        c1 = read_counts()
        t0 = time.perf_counter()
        solver.update_operator(a_new.data)
        sync(device)
        rec["update_operator_ms"] = 1e3 * (time.perf_counter() - t0)
        c2 = read_counts()
        t0 = time.perf_counter()
        res = solver.solve(prob.b)
        sync(device)
        rec["solve_ms"] = 1e3 * (time.perf_counter() - t0)
        c3 = read_counts()
        rec.update(iters=res.iters, relres=float(res.relres),
                   status=STATUS_NAMES[int(res.health.status)],
                   healthy=int(res.health.status) == HEALTHY,
                   launches={
                       "reassemble": _diff(c1, c0),
                       "update_operator": _diff(c2, c1),
                       "solve": _diff(c3, c2)})
        rec["x"] = res.x
        records.append(rec)
        a_data = a_new.data
        if verbose:
            shown = {k: (round(v, 3) if isinstance(v, float) and k != "relres"
                         else v) for k, v in rec.items() if k != "x"}
            print(f"{label}hot step " + json.dumps(shown))
    return dict(prob=prob, solver=solver, records=records, setup_s=t_setup,
                assemble_s=t_asm, a_data=a_data, precision=precision,
                restriction=restriction)


@functools.lru_cache(maxsize=1)
def library_kernels() -> dict:
    """The ``__global__`` kernels ``csrc/`` defines, each to the stem of
    the file that defines it (its family: ``spmv_kernel`` ->
    ``block_spmv``): the library's own kernels among a profiler's CUDA
    events."""
    names = {}
    for src in sorted((SRC / "repro_torch" / "kernels" / "csrc")
                      .glob("*.cu")):
        for name in re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                r"(\w+)\s*\(", src.read_text()):
            names[name] = src.stem
    return names


def _kernel_name(event_name: str) -> str:
    """The kernel's own name in a demangled signature (``void
    (anonymous namespace)::spmv_kernel<3, 3, double, double>(...)`` ->
    ``spmv_kernel``): the first identifier followed by ``<`` or ``(``."""
    m = re.search(r"(?:^|[\s:])(\w+)[<(]", event_name)
    return m.group(1) if m else event_name


def _entry_family(entry: str) -> str:
    """The family of a C entry point (``repro_fused_smoother_panel_f64``
    -> ``fused_smoother``)."""
    name = entry[len("repro_"):]
    return max((f for f in KERNELS if name.startswith(f)), key=len)


class LaunchLog:
    """The host's side of the witness: every C entry point the library
    launches inside the scope, in order, with its integer arguments (the
    shapes, lanes and threads), read where ``backend.launch`` calls the
    library.  Counts nothing and changes no launch."""

    def __enter__(self):
        from repro_torch.kernels import backend
        self._backend, self._launch = backend, backend.launch
        self.entries = []

        def logged(name, argtypes, *args):
            self.entries.append((_entry_family(name), tuple(
                v for t, v in zip(argtypes, args) if t is backend.I)))
            return self._launch(name, argtypes, *args)

        backend.launch = logged
        return self

    def __exit__(self, *exc):
        self._backend.launch = self._launch


def _witness(entries: list, events: list) -> dict:
    """The host's launches against the profiler's library events (in
    start order): per family, the counts that differ, and the first
    launch whose event is missing (its position, family and shape, and
    the launch before it).  With every launch seen, each event's device
    ms is that launch's, summed by the ELL products' shapes
    (``block_spmv`` / ``block_spmm``: family, nbr, kmax, br, bc, k)."""
    fams = library_kernels()
    dev = [fams[_kernel_name(e.name)] for e in events]
    host = [fam for fam, _ in entries]
    counts = {f: [host.count(f), dev.count(f)] for f in KERNELS}
    out = dict(by_kernel={f: c for f, c in counts.items() if c[0] != c[1]})
    if host != dev:
        i = next((i for i, (h, d) in enumerate(zip(host, dev)) if h != d),
                 min(len(host), len(dev)))
        out["first_missing"] = dict(
            position=i, of=len(host),
            launch=None if i >= len(host) else list(
                (host[i],) + entries[i][1]),
            before=None if i == 0 else list((host[i - 1],)
                                            + entries[i - 1][1]))
        return out
    by_shape = {}
    for (fam, ints), e in zip(entries, events):
        if fam in ("block_spmv", "block_spmm"):
            key = f"{fam} {tuple(ints[:4])}" + (
                f" k={ints[4]}" if fam == "block_spmm" else "")
            n, t = by_shape.get(key, (0, 0.0))
            by_shape[key] = (n + 1, t + e.device_time / 1e3)
    out["ell_ms_by_shape"] = {k: [n, t] for k, (n, t) in sorted(
        by_shape.items(), key=lambda kv: -kv[1][1])}
    return out


def step_phases(prob, solver, run: dict, walls: dict) -> None:
    """The profiled hot step: reassembly, ``update_operator`` and the
    solve, each timed on the host between synchronizations."""
    import torch
    for phase in ("reassemble", "update_operator", "solve"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if phase == "reassemble":
            a_new = prob.reassemble(1.3)
        elif phase == "update_operator":
            solver.update_operator(a_new.data)
            run["a_data"] = a_new.data
        else:
            solver.solve(prob.b)
        torch.cuda.synchronize()
        walls[phase] = 1e3 * (time.perf_counter() - t0)


def _profile_step(run: dict, top: int, phases=step_phases) -> tuple:
    """One more hot step (``phases``; the scalar path passes its solve)
    under ``torch.profiler``: the summary (walls,
    device busy time, idle share, the library's kernel events, the
    launches ``autotune.launch_record`` noted across the step and the
    ``_witness`` of the host's launch log against the events) and the
    ``top`` kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.autotune import launch_record

    prob, solver = run["prob"], run["solver"]
    walls = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) \
            as prof:
        # A session opened late in a process lost the first device
        # records of the step (the reassembly's block_seg_sum and the
        # torch kernels before it).  So the tracer starts on a warm-up
        # step whose records are dropped, and the step keeps a host pause
        # from each edge of the recorded window
        warm = torch.zeros(WARMUP_KERNELS, device="cuda")
        for i in range(WARMUP_KERNELS):
            warm[i:].add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(WINDOW_PAUSE_S)
        noted = launch_record()[0]
        with LaunchLog() as log:
            phases(prob, solver, run, walls)
        noted = launch_record()[0] - noted
        time.sleep(WINDOW_PAUSE_S)
        prof.step()
    # the device's records, less the step's own annotation
    # (``ProfilerStep*``, a device-side range the schedule adds around the
    # step's kernels)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")]
    ours = library_kernels()
    lib = sorted((e for e in kernels if _kernel_name(e.name) in ours),
                 key=lambda e: e.time_range.start)
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    wall_ms = sum(walls.values())
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time / 1e3)
    rows = [dict(name=name[:90], launches=n, device_ms=t,
                 share=t / busy_ms if busy_ms else 0.0)
            for name, (n, t) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])[:top]]
    summary = dict(wall_ms=walls, device_busy_ms=busy_ms,
                   device_events=len(kernels), library_events=len(lib),
                   library_launches=noted, logged_launches=len(log.entries),
                   idle_share=1.0 - busy_ms / wall_ms,
                   **_witness(log.entries, lib))
    return summary, rows


def profile_hot_step(run: dict, top: int = 12, label: str = "",
                     scalar: bool = False) -> dict:
    """One more hot step under ``torch.profiler``: device time by kernel
    and the card's idle share of the step's wall time, held to a witness.
    The library's kernel events in the session must number the launches
    the library noted on the host across the step
    (``autotune.launch_record``).  A session with fewer or more was blind
    (profiler records go missing once a process has run other work): the
    step is profiled again in a child process (``--profile-witness``, the
    same configuration, precision, restriction and tune mode),
    ``PROFILE_TRIES`` sessions in all; it fails when every one was blind.
    A blind session's line names the launch whose event is missing.
    ``scalar``: the step is one scalar solve on ``run["scalar_hier"]``
    (``scalar_solve_phases``)."""
    from repro_torch.kernels import backend
    spec = dict(label=label, top=top, precision=run["precision"],
                restriction=run.get("restriction", "transpose_free"),
                tune=backend.resolve_tune(), scalar=scalar)
    summary, rows = _profile_step(
        run, top, scalar_solve_phases if scalar else step_phases)
    attempt = 1
    while summary["library_events"] != summary["library_launches"]:
        print(f"profiled {label}hot step blind " + json.dumps(dict(
            attempt=attempt, library_events=summary["library_events"],
            library_launches=summary["library_launches"],
            device_events=summary["device_events"],
            by_kernel=summary["by_kernel"],
            first_missing=summary.get("first_missing"))))
        if attempt == PROFILE_TRIES:
            raise AssertionError(
                f"profiled {label}hot step: every one of {PROFILE_TRIES} "
                f"profiler sessions was blind (library kernel events != "
                f"library launches)")
        attempt += 1
        summary, rows = _profile_child(spec)
    summary["attempt"] = attempt            # > 1: a child's session
    print(f"profiled {label}hot step " + json.dumps(summary))
    if not 0.0 <= summary["idle_share"] < 1.0:
        raise AssertionError(f"profiled {label}hot step: device busy "
                             f"{summary['device_busy_ms']} ms against a "
                             f"wall of {sum(summary['wall_ms'].values())} "
                             f"ms")
    for row in rows:
        print(f"profile {label}kernel " + json.dumps(row))
    return summary


def _profile_child(spec: dict) -> tuple:
    """One ``--profile-witness`` child process; its summary and rows."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          PROFILE_FLAG, json.dumps(spec)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("profile witness ")]
    if out.returncode or not lines:
        raise AssertionError(f"profile witness exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    rec = json.loads(lines[-1][len("profile witness "):])
    return rec["summary"], rec["rows"]


def profile_witness(spec: dict) -> int:
    """``chip_smoke.py --profile-witness SPEC``, run by
    ``profile_hot_step`` in a process of its own: the main path's
    configuration at ``spec["precision"]``, ``spec["restriction"]`` and
    ``spec["tune"]`` (one hot step to warm it), then one profiled hot
    step (``spec["scalar"]``: one warm and one profiled scalar solve on
    the step's values); prints its summary and top kernels as one JSON
    line."""
    from repro_torch.kernels import backend
    backend.build_library()
    with tune_mode(spec["tune"]):
        run = main_path(MAIN_M, "cuda", steps=1, verbose=False,
                        precision=spec["precision"],
                        restriction=spec["restriction"])
        phases = step_phases
        if spec.get("scalar"):
            from repro_torch.core.scalar_path import recompute_scalar
            run["scalar_hier"] = recompute_scalar(
                run["solver"].setup_data, run["a_data"])
            scalar_solve_phases(run["prob"], run["solver"], run, {})
            phases = scalar_solve_phases
        summary, rows = _profile_step(run, spec["top"], phases)
    print("profile witness " + json.dumps(dict(summary=summary,
                                               rows=rows)))
    return 0


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def check_main_path(run: dict) -> None:
    stats = run["solver"].setup_data.stats
    if stats["level_rows"] != EXPECT_LEVEL_ROWS:
        raise AssertionError(f"level_rows {stats['level_rows']} != "
                             f"{EXPECT_LEVEL_ROWS}")
    for rec in run["records"]:
        if not rec["healthy"]:
            raise AssertionError(f"step {rec['step']}: status "
                                 f"{rec['status']}")
        if rec["iters"] != EXPECT_ITERS:
            raise AssertionError(f"step {rec['step']}: {rec['iters']} CG "
                                 f"iterations, expected {EXPECT_ITERS}")
        want = {"reassemble": ["block_seg_sum"],
                "update_operator": ["fused_pair_gemm", "block_seg_sum"],
                "solve": ["block_spmv", "fused_smoother"]}
        for phase, names in want.items():
            for name in names:
                if rec["launches"][phase][name] <= 0:
                    raise AssertionError(
                        f"step {rec['step']}: {name} did not launch during "
                        f"{phase}")


def _sha(t) -> str:
    arr = t.detach().contiguous().cpu().numpy()
    h = hashlib.sha256(f"{arr.dtype} {arr.shape}".encode())
    h.update(arr.tobytes())
    return h.hexdigest()[:16]


def coarse_fingerprint(run: dict) -> dict:
    """SHA-256 of the setup's coarse operators (A1.., the coarsest one
    last), its prolongators (P0..) and the last hot-step solution: every
    one of them runs through ``fused_pair_gemm``, so a kernel that moves a
    single rounding changes a hash."""
    setupd = run["solver"].setup_data
    out = {f"A{li}": _sha(ls.A0.data)
           for li, ls in enumerate(setupd.levels) if li}
    out[f"A{len(setupd.levels)}"] = _sha(setupd.coarse_struct.data)
    out.update({f"P{li}": _sha(ls.P.data)
                for li, ls in enumerate(setupd.levels)})
    out["x"] = _sha(run["records"][-1]["x"])
    return out


def check_fingerprint(run: dict) -> dict:
    got = coarse_fingerprint(run)
    if EXPECT_COARSE_SHA is not None and got != EXPECT_COARSE_SHA:
        differ = sorted(k for k in got if got[k] != EXPECT_COARSE_SHA.get(k))
        raise AssertionError(f"coarse operators not bitwise the expected "
                             f"ones: {differ} differ ({got})")
    return dict(sha256_16=got, checked=EXPECT_COARSE_SHA is not None)


class PathCounts:
    """Kernel launches of one path: the sum of the count deltas around the
    path's own calls (checks made in between do not count), by family
    (``total``) and by scalar-baseline entry (``entries``,
    ``SCALAR_KERNELS``)."""

    def __init__(self):
        self.total = {name: 0 for name in KERNELS}
        self.entries = dict.fromkeys(SCALAR_KERNELS, 0)

    def run(self, fn):
        c0, e0 = read_counts(), _scalar_entry_counts()
        out = fn()
        delta = _diff(read_counts(), c0)
        for k, v in delta.items():
            self.total[k] += v
        for k, v in _diff(_scalar_entry_counts(), e0).items():
            self.entries[k] += v
        return out, delta


def _rel(got, want) -> float:
    """max |got - want| / max |want| of two tensors, or of two tuples of
    tensors taken together, on any devices."""
    import torch
    if isinstance(got, tuple):
        got, want = (torch.cat([t.reshape(-1) for t in v]) for v in (got,
                                                                     want))
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err / scale if scale else err


def serve_path(run: dict, device, expect_iters: int,
               verbose: bool = True) -> dict:
    """The solve server on the main path's setup: bursts of requests in
    bucketed panels, an operator update and a burst of ``b``.  Returns
    the path's kernel launches."""
    import numpy as np
    import torch

    from repro_torch.core.gamg import hier_solve
    from repro_torch.multirhs import AMGSolveServer

    prob, setupd = run["prob"], run["solver"].setup_data
    counts = PathCounts()
    reset_counts()
    server, _ = counts.run(lambda: AMGSolveServer(
        setupd, run["a_data"], buckets=BUCKETS, rtol=1e-8, maxiter=200))
    rng = np.random.default_rng(0)
    n_reports, vector_ms = 0, []
    plan = [(burst, [rng.standard_normal(prob.n) for _ in range(burst)])
            for burst in BURSTS]
    b_host = prob.b.cpu().numpy()
    plan.append(("update", [b_host] * 4))
    for burst, rhs in plan:
        if burst == "update":
            a_new = prob.reassemble(1.2).data
            counts.run(lambda: server.update_operator(a_new))
        sync(device)
        t0 = time.perf_counter()
        reports, delta = counts.run(lambda: server.serve(rhs))
        wall_ms = 1e3 * (time.perf_counter() - t0)
        n_reports += len(reports)
        its = [r.iters for r in reports]
        # flush solves chunks of up to BUCKETS[-1] requests, one panel each
        panels = [r.k_bucket for r in reports[::BUCKETS[-1]]]
        line = dict(burst=burst, requests=len(rhs), buckets=panels,
                    iters=[min(its), max(its)], wall_ms=wall_ms,
                    ms_per_request=wall_ms / len(rhs),
                    launches={k: delta[k] for k in ("block_spmm",
                                                    "fused_smoother",
                                                    "block_spmv")})
        bad = [r for r in reports if r.status != "ok" or not r.converged]
        if bad:
            raise AssertionError(f"burst {burst}: {len(bad)} reports not ok:"
                                 f" {[(r.request_id, r.status) for r in bad]}")
        if burst == "update" and its != [expect_iters] * len(rhs):
            raise AssertionError(f"post-update burst: iterations {its}, "
                                 f"expected {expect_iters} on every column")
        if burst in CHECKED_BURSTS:
            for r, b in zip(reports, rhs):
                bt = torch.as_tensor(b, device=device)
                sync(device)
                t0 = time.perf_counter()
                v = hier_solve(setupd, server.hierarchy, bt, rtol=1e-8,
                               maxiter=200)
                sync(device)
                vector_ms.append(1e3 * (time.perf_counter() - t0))
                rel = _rel(torch.as_tensor(r.x), v.x)
                if v.iters != r.iters or not rel <= SOLUTION_TOL:
                    raise AssertionError(
                        f"burst {burst} request {r.request_id}: panel "
                        f"{r.iters} iterations, vector {v.iters}; solutions "
                        f"differ by {rel:.3e}")
            line["vector_check"] = "iterations equal, solutions within 1e-9"
        if verbose:
            print("serve burst " + json.dumps(line))
    want = sum(BURSTS) + 4
    if n_reports != want:
        raise AssertionError(f"serve: {n_reports} reports, expected {want}")
    if verbose:
        print("serve path " + json.dumps(dict(
            reports=n_reports, stats=server.stats,
            vector_solve_ms_median=statistics.median(vector_ms),
            launches=counts.total)))
    return counts.total


def pairs_path(run: dict, device, expect_iters: int,
               verbose: bool = True) -> dict:
    """One ``update_operator`` on the "pairs" SpGEMM path at the values of
    the current fused hierarchy, held against it and solved; then the
    fused recompute again, for its peak memory.  Returns the path's
    kernel launches."""
    import torch
    prob, solver = run["prob"], run["solver"]
    a = run["a_data"]
    fused = solver.hierarchy
    cuda = torch.device(device).type == "cuda"
    counts = PathCounts()
    reset_counts()

    def recompute(path):
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        os.environ["REPRO_TORCH_SPGEMM_PATH"] = path
        t0 = time.perf_counter()
        try:
            _, delta = counts.run(lambda: solver.update_operator(a))
        finally:
            del os.environ["REPRO_TORCH_SPGEMM_PATH"]
        sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base if cuda else None
        return dict(ms=ms, peak_bytes_above_live=peak, launches=delta)

    pairs = recompute("pairs")
    hier = solver.hierarchy
    errs = {"coarse_chol": _rel(hier.coarse_chol, fused.coarse_chol)}
    for li, (p, f) in enumerate(zip(hier.levels, fused.levels)):
        errs[f"level{li} a_ell.data"] = _rel(p.a_ell.data, f.a_ell.data)
        errs[f"level{li} dinv"] = _rel(p.dinv, f.dinv)
        errs[f"level{li} lam_max"] = _rel(p.lam_max, f.lam_max)
    worst = max(errs.values())
    if not worst <= REL_TOL:
        raise AssertionError(f"pairs vs fused hierarchy: {errs}")
    res, _ = counts.run(lambda: solver.solve(prob.b))
    if res.iters != expect_iters or int(res.health.status) != 0:
        raise AssertionError(f"pairs hierarchy: {res.iters} iterations, "
                             f"status {int(res.health.status)}")
    del hier
    fused_rec = recompute("fused")
    if verbose:
        print("pairs path " + json.dumps(dict(
            pairs=pairs, fused=fused_rec, max_rel_err=worst, iters=res.iters,
            launches=counts.total)))
    return counts.total


def read_counts_at(dt: str) -> dict:
    """Kernel launches at payload dtype ``dt`` ("f64", "f32", "bf16")."""
    return {name: mod.launches_by_dtype[dt] for name, mod in _ops().items()}


def hierarchy_bytes(hier) -> int:
    """Device bytes the numeric hierarchy holds (operators, transfers,
    ``dinv``, the coarse factor and the Krylov copy of the finest
    operator; the structure-only plans are not counted)."""
    ts = [hier.coarse_chol]
    for lv in hier.levels:
        ts += [lv.a_ell.data, lv.a_ell.indices, lv.a_ell.mask, lv.p_ell.data,
               lv.p_ell.indices, lv.p_ell.mask, lv.dinv, lv.lam_max]
        if lv.r_ell is not None:
            ts += [lv.r_ell.data, lv.r_ell.indices, lv.r_ell.mask]
    if hier.a_fine_ell is not None:
        f = hier.a_fine_ell
        ts += [f.data, f.indices, f.mask]
    seen, total = set(), 0
    for t in ts:
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def precision_path(prec: str, f64_run: dict, peaks: tuple,
                   device="cuda", m: int = MAIN_M) -> tuple:
    """The main and serve paths under the reduced-precision policy
    ``prec`` on ``ElasticityConfig(m=32)`` (greedy, ``coarse_size=100``):
    setup, 3 hot steps and a profiled one, an ``update_operator`` with the
    hierarchy's peak memory, a burst of ``PREC_BURST`` requests through
    ``AMGSolveServer`` and one ``pairs`` recompute; then the autotuner's
    sweep of ``pbjacobi`` at each level's ``dinv`` (its only caller), every
    kernel at this dtype against its plain version, the bitwise contracts
    and every ``threads`` candidate bitwise.  Returns the path's launches
    at this dtype, the kernel checks and the launches of a hot step.  On
    the CPU (a rehearsal at a small ``m``) it skips what needs the card:
    the level check, profile, memory, timings and bitwise contracts."""
    import numpy as np
    import torch

    from repro_torch.kernels import backend
    from repro_torch.kernels.pbjacobi import ops as pbj
    from repro_torch.multirhs import AMGSolveServer
    from repro_torch.robust.health import STATUS_NAMES

    dtype = backend.resolve_precision(prec).hierarchy_dtype
    dt = backend.PAYLOADS[dtype]
    t_path = time.perf_counter()
    reset_counts()
    cuda = torch.device(device).type == "cuda"
    run = main_path(m, device, precision=prec)
    solver, prob = run["solver"], run["prob"]
    setupd, hier = solver.setup_data, solver.hierarchy
    stats = setupd.stats
    if cuda and stats["level_rows"] != EXPECT_LEVEL_ROWS:
        raise AssertionError(f"{prec}: level_rows {stats['level_rows']} != "
                             f"{EXPECT_LEVEL_ROWS}")
    payloads = {f"level{li}": dict(
        a_ell=str(lv.a_ell.data.dtype), p_ell=str(lv.p_ell.data.dtype),
        dinv=str(lv.dinv.dtype)) for li, lv in enumerate(hier.levels)}
    payloads["coarse_chol"] = str(hier.coarse_chol.dtype)
    payloads["a_fine_ell"] = str(hier.a_fine_ell.data.dtype)
    if {v for lv in hier.levels for v in (lv.a_ell.data.dtype,
                                          lv.p_ell.data.dtype,
                                          lv.dinv.dtype)} != {dtype} \
            or hier.coarse_chol.dtype != dtype \
            or hier.a_fine_ell.data.dtype != torch.float64:
        raise AssertionError(f"{prec}: payload dtypes {payloads}")
    steps = []
    for rec in run["records"]:
        if prec == "f32" and not (rec["healthy"]
                                  and rec["relres"] <= 1e-8):
            raise AssertionError(f"{prec} step {rec['step']}: status "
                                 f"{rec['status']}, relres {rec['relres']}")
        steps.append(dict(step=rec["step"], iters=rec["iters"],
                          relres=rec["relres"], status=rec["status"],
                          reassemble_ms=rec["reassemble_ms"],
                          update_operator_ms=rec["update_operator_ms"],
                          solve_ms=rec["solve_ms"]))
    x64 = f64_run["records"][-1]["x"]
    x = run["records"][-1]["x"]
    rel_x = _rel(x, x64) if bool(torch.isfinite(x).all()) else float("nan")
    print(f"{prec} precision " + json.dumps(dict(
        policy=setupd.precision.describe(), level_rows=stats["level_rows"],
        payloads=payloads, steps=steps, solution_rel_diff_vs_f64=rel_x)))
    prof = profile_hot_step(run, label=f"{prec} ") if cuda else {}
    # the hierarchy's bytes, and the peak above the live set during an
    # update_operator, beside the f64 run's
    sync(device)
    base = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    solver.update_operator(run["a_data"])
    sync(device)
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    memory = dict(hierarchy_bytes=hierarchy_bytes(solver.hierarchy),
                  f64_hierarchy_bytes=hierarchy_bytes(
                      f64_run["solver"].hierarchy),
                  update_operator_peak_bytes_above_live=peak)
    print(f"{prec} memory " + json.dumps(memory))

    # one burst through the server (fine values at f64, panels at f64)
    server = AMGSolveServer(setupd, run["a_data"], buckets=BUCKETS,
                            rtol=1e-8, maxiter=200)
    fine = server.hierarchy.a_fine_ell.data
    if fine.dtype != torch.float64 or not torch.equal(
            fine, setupd.levels[0].a_ell_plan.build(run["a_data"]).data):
        raise AssertionError(f"{prec}: the server's Krylov operator is not "
                             f"the f64 fine values")
    rng = np.random.default_rng(0)
    rhs = [prob.b.cpu().numpy()] + [rng.standard_normal(prob.n)
                                    for _ in range(PREC_BURST - 1)]
    sync(device)
    t0 = time.perf_counter()
    reports = server.serve(rhs)
    serve_ms = 1e3 * (time.perf_counter() - t0)
    if len(reports) != PREC_BURST or (prec == "f32" and any(
            r.status != "ok" or not r.converged for r in reports)):
        raise AssertionError(f"{prec} serve: "
                             f"{[(r.iters, r.status) for r in reports]}")
    print(f"{prec} serve burst " + json.dumps(dict(
        requests=len(rhs), buckets=sorted({r.k_bucket for r in reports}),
        iters=[r.iters for r in reports],
        status=[r.status for r in reports], wall_ms=serve_ms)))

    # one recompute on the pairs path, against the fused hierarchy
    fused = solver.hierarchy
    os.environ["REPRO_TORCH_SPGEMM_PATH"] = "pairs"
    try:
        sync(device)
        t0 = time.perf_counter()
        solver.update_operator(run["a_data"])
        sync(device)
        pairs_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        del os.environ["REPRO_TORCH_SPGEMM_PATH"]
    errs = {f"level{li}": _rel(p.a_ell.data, f.a_ell.data)
            for li, (p, f) in enumerate(zip(solver.hierarchy.levels,
                                            fused.levels))}
    errs["coarse"] = _rel(solver.hierarchy.coarse_chol.float().nan_to_num(),
                          fused.coarse_chol.float().nan_to_num())
    tol = PRECISIONS[prec]
    if not max(v for k, v in errs.items() if k != "coarse") <= tol:
        raise AssertionError(f"{prec} pairs vs fused operators: {errs}")
    res = solver.solve(prob.b)
    print(f"{prec} pairs path " + json.dumps(dict(
        ms=pairs_ms, rel_err_vs_fused=errs, iters=res.iters,
        relres=float(res.relres),
        status=STATUS_NAMES[int(res.health.status)])))

    # the autotuner: pbjacobi (its only caller) at each level's dinv,
    # swept at this dtype into the cache
    with tune_mode("sweep"):
        for lv in solver.hierarchy.levels:
            n = lv.dinv.shape[0] * lv.dinv.shape[1]
            pbj.pbjacobi_apply(lv.dinv, torch.zeros(n, **_like(lv.dinv)),
                               torch.zeros(n, **_like(lv.dinv)), OMEGA)
    sync(device)
    launches = read_counts_at(dt)
    print(f"{prec} precision path launches " + json.dumps(launches))
    if cuda:
        check_path_launches(f"{prec} precision", launches, tuple(KERNELS))

    # every kernel at this dtype against its plain version (the stored
    # restrictions of the f64 run cast to it among them), the bitwise
    # contracts, every threads candidate
    r_ells = f64_run.get("r_ells", ())
    cases = build_cases(run, device, dtype, extra_ells=r_ells)
    if cuda:
        attach_floors(cases)
    per = check_kernels(cases, (peaks[0], F32_FLOPS), timed=cuda,
                        label=f"{prec} ", tol=tol)
    if cuda:
        print(f"{prec} bitwise per column "
              + json.dumps(check_bitwise(run, device, dtype, r_ells)))
    print(f"{prec} threads bitwise "
          + json.dumps(check_threads_bitwise(cases)))
    per_step = run["records"][-1]["launches"]
    print(f"{prec} precision path done " + json.dumps(dict(
        seconds=time.perf_counter() - t_path,
        device_busy_ms=prof.get("device_busy_ms"),
        idle_share=prof.get("idle_share"))))
    return launches, per, {k: per_step["update_operator"][k]
                           + per_step["solve"][k] for k in KERNELS}


def _like(t) -> dict:
    return dict(dtype=t.dtype, device=t.device)


def h2d_witness() -> int:
    """``chip_smoke.py --h2d-witness``, run by ``h2d_check`` in a process
    of its own: the profiler records memcpy events in a fresh process and
    may not once a process has run other profiled work.  One profiler
    session, opened before any other work, holds a ``record_function``
    range for each of three control copies, each of the coefficient
    path's four updates (``ElasticityConfig(m=32)`` as built), the second
    and third steps of a frozen march segment on that problem, a second
    ``recompute_scalar`` on its setup and the three controls again; prints one JSON line of the bytes each range
    moved host to device by the profiler's memcpy events and by
    ``obs.transfer.count_h2d``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.core.scalar_path import recompute_scalar
    from repro_torch.fem.assemble import inclusion_fields
    from repro_torch.kernels import backend
    from repro_torch.obs.transfer import count_h2d
    from repro_torch.sim import (MarchConfig, SofteningScenario,
                                 StalenessConfig, init_carry, make_segment)
    from repro_torch.sim.driver import _setup_from_fields

    backend.build_library()
    n = 2 ** 20
    host, arr, lst = torch.ones(n, dtype=torch.float64), np.ones(n), \
        [1.0] * n
    # the aten count sees the first, and (in the torch versions tried) the
    # second; the third copies inside the constructor, out of its sight
    controls = {
        "to": lambda: host.to("cuda"),
        "as_tensor": lambda: torch.as_tensor(arr, device="cuda"),
        "tensor": lambda: torch.tensor(lst, dtype=torch.float64,
                                       device="cuda")}
    aten = {}

    def ranged(name, fn):
        torch.cuda.synchronize()
        with record_function(f"h2d {name}"):
            aten[name] = count_h2d(fn)[1]
            torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k, fn in controls.items():
            ranged(f"control {k}", fn)
        prob, solver = ElasticityConfig(m=MAIN_M).build(device="cuda")
        for c in CONTRASTS:
            E, nu = inclusion_fields(prob.mesh, E_inclusion=c)
            ranged(f"update {c}", lambda: solver.update_coefficients(E, nu))
        # a frozen march segment: its first step (outside the ranges) puts
        # the setup's index arrays on the card; the next two copy nothing
        scen = SofteningScenario.build(prob, rate=MARCH_RATE)
        cfg = MarchConfig(n_steps=3, seg_len=8, staleness=StalenessConfig(
            iter_drift=10**6, ref_window=1, coeff_rtol=10**6))
        carry = init_carry(scen, prob.b)
        E, nu, _ = scen.step_fields(carry.scen, carry.x, carry.step)
        seg = make_segment(_setup_from_fields(prob, E, nu, MARCH_SETUP),
                           prob.assembler, scen, cfg)
        _, carry, _, _ = seg(prob.b, carry, 1)
        ranged("march segment steps 2-3",
               lambda: seg(prob.b, carry, cfg.n_steps))
        # the scalar baseline: the first recompute_scalar (outside the
        # ranges) expands the structures and puts their index arrays on
        # the card; the second copies nothing
        sd = solver.setup_data
        recompute_scalar(sd, prob.A.data)
        ranged("scalar recompute 2", lambda: recompute_scalar(
            sd, prob.A.data))
        for k, fn in controls.items():
            ranged(f"control {k} after", fn)
    by_range, outside = _h2d_by_range(prof)
    print("h2d witness " + json.dumps(dict(
        control_bytes=n * 8, n_elements=prob.mesh.n_elements,
        outside_ranges=outside,
        ranges={k: dict(aten=v, profiler=by_range.get(f"h2d {k}", 0))
                for k, v in aten.items()})))
    return 0


def _h2d_by_range(prof) -> tuple:
    """Host-to-device memcpy bytes of a profiler session by the
    ``record_function`` range whose host span holds the copy's runtime
    call (joined on the correlation id), and the bytes outside every
    range."""
    events = _trace(prof)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("h2d ")]
    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})}
    out, outside = {}, 0
    for e in events:
        if e.get("cat") != "gpu_memcpy" or "HtoD" not in e.get("name", ""):
            continue
        if "bytes" not in e.get("args", {}):
            raise AssertionError(f"memcpy event without bytes: {e}")
        ts = calls.get(e["args"].get("correlation"), e["ts"])
        hit = [r["name"] for r in ranges
               if r["ts"] <= ts <= r["ts"] + r["dur"]]
        if hit:
            out[hit[0]] = out.get(hit[0], 0) + int(e["args"]["bytes"])
        else:
            outside += int(e["args"]["bytes"])
    return out, outside


def _h2d_witness_run() -> dict:
    """One ``h2d_witness`` child process; its record."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          H2D_FLAG], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("h2d witness ")]
    if out.returncode or not lines:
        raise AssertionError(f"h2d witness exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(lines[-1][len("h2d witness "):])


def h2d_check(tries: int = 3) -> dict:
    """Runs ``h2d_witness`` in a child process and holds its numbers: each
    control read by the profiler at its size, before and after the
    updates (a witness that reads 0 fails), the ``to`` control by the
    aten count too, and each update between the two fields and the two
    fields plus ``H2D_SLACK`` bytes by both counts.  A child whose
    profiler missed a control copy measured nothing, so another child
    runs (at most ``tries`` in all); the updates are held only in a child
    whose every control read its size.  The march segment's second and
    third steps and the second ``recompute_scalar`` must move 0 bytes by
    both counts."""
    for attempt in range(1, tries + 1):
        rec = _h2d_witness_run()
        size = rec["control_bytes"]
        blind = [k for k, got in rec["ranges"].items()
                 if k.startswith("control") and got["profiler"] != size]
        if not blind:
            break
        print("h2d witness blind " + json.dumps(dict(
            attempt=attempt, controls={k: rec["ranges"][k] for k in blind})))
    else:
        raise AssertionError(f"h2d witness: the profiler missed control "
                             f"copies in {tries} child processes: {blind}")
    rec["attempts"] = attempt
    ranges = rec["ranges"]
    fields = 2 * rec["n_elements"] * 8
    for name, got in ranges.items():
        if name.startswith("control"):
            if name.startswith("control to") and got["aten"] != size:
                raise AssertionError(f"h2d {name}: the aten count read "
                                     f"{got['aten']} bytes of {size}")
        elif name.startswith(("march", "scalar")):
            if got["profiler"] or got["aten"]:
                raise AssertionError(f"h2d {name}: {got} bytes host to "
                                     f"device; expected 0")
        elif not all(fields <= got[k] <= fields + H2D_SLACK
                     for k in ("profiler", "aten")):
            raise AssertionError(f"h2d {name}: {got} bytes host to device;"
                                 f" expected {fields} to "
                                 f"{fields + H2D_SLACK}")
    return rec


def _trace(prof) -> list:
    """The events of a profiler's chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _mis_problem(device, m: int = MIS_M, coarse_size: int = MIS_COARSE):
    """Quickstart's setting: device assembly, cold setup with the MIS
    coarsener; returns the problem, the solver and the seconds taken."""
    from repro_torch.core.gamg import GAMGSolver
    from repro_torch.fem.assemble import assemble_elasticity
    sync(device)
    t0 = time.perf_counter()
    prob = assemble_elasticity(m, device=device)
    solver = GAMGSolver(prob.A, prob.B, coarse_size=coarse_size,
                        coarsener="mis", rtol=1e-8, maxiter=200)
    sync(device)
    return prob, solver, time.perf_counter() - t0


def _edge_margins(A, theta: float, edges) -> list:
    """For each ``(i, j)`` edge, how far block (i, j) or (j, i) of ``A``
    lies from the strength threshold ``theta * sqrt(|a_ii| |a_jj|)``, in
    ulps of the threshold (the nearer of the two directions)."""
    import numpy as np
    norms = A.block_norms().cpu().numpy()
    rows = A.row_of_nnz()
    cols = A.indices.astype(np.int64)
    diag = np.full(A.nbr, np.inf)
    on = rows == cols
    diag[rows[on]] = norms[on]
    out = []
    for i, j in edges:
        best = np.inf
        for a, b in ((i, j), (j, i)):
            hit = np.flatnonzero((rows == a) & (cols == b))
            if len(hit):
                thr = theta * np.sqrt(diag[a] * diag[b])
                ulps = abs(norms[hit[0]] - thr) / (np.finfo(float).eps * thr)
                best = min(best, float(ulps))
        out.append(dict(edge=[int(i), int(j)], margin_ulps=best))
    return out


def _aggregates_card_vs_cpu(card, cpu) -> list:
    """Level by level, the card's MIS aggregates against the CPU's: equal,
    or every strength edge the two graphs disagree on printed with its
    margin to the threshold; a margin above ``TIE_ULPS``, or equal graphs
    with other aggregates, fails."""
    import numpy as np

    from repro_torch.core.strength import strength_graph
    out = []
    for li, (a, b) in enumerate(zip(cpu.levels, card.levels)):
        if np.array_equal(a.aggr.node_to_agg, b.aggr.node_to_agg):
            out.append(dict(level=li, equal=True))
            continue
        ga, gb = (strength_graph(ls.A0, cpu.theta) for ls in (a, b))
        ea, eb = ({(int(r), int(c)) for r, c in zip(
            np.repeat(np.arange(g.n), np.diff(g.indptr)), g.indices)}
            for g in (ga, gb))
        edges = sorted({tuple(sorted(e)) for e in ea ^ eb})
        margins = _edge_margins(a.A0, cpu.theta, edges)
        print("mis strength edges card vs cpu " + json.dumps(dict(
            level=li, edges=margins)))
        worst = max((m["margin_ulps"] for m in margins), default=None)
        if worst is None or worst > TIE_ULPS:
            raise AssertionError(
                f"level {li}: MIS aggregates differ card vs CPU; strength "
                f"graphs differ by {len(edges)} edges, largest margin "
                f"{worst} ulps (limit {TIE_ULPS})")
        out.append(dict(level=li, equal=False, edges=len(edges),
                        max_margin_ulps=worst))
    return out


def mis_path(device="cuda", verbose: bool = True) -> tuple:
    """Quickstart's setting on the card at m=12: device assembly, the MIS
    cold setup, 3 hot steps; levels, aggregates per level and iterations
    are the reference's, the aggregates equal the port's on the CPU, and
    the same 3 steps on the CPU setup give the same iterations and
    solutions within ``SOLUTION_TOL``.  Every kernel of the path is held
    against its plain version at the path's own shapes.  Returns the
    path's kernel launches and the kernel checks."""
    from repro_torch.robust.health import HEALTHY
    counts = PathCounts()
    reset_counts()
    (prob, solver, setup_s), _ = counts.run(lambda: _mis_problem(device))
    sd = solver.setup_data
    n_agg = [ls.aggr.n_agg for ls in sd.levels]
    if sd.stats["level_rows"] != EXPECT_MIS_ROWS or n_agg != EXPECT_MIS_NAGG:
        raise AssertionError(f"mis path: levels {sd.stats['level_rows']}, "
                             f"n_agg {n_agg}; expected {EXPECT_MIS_ROWS}, "
                             f"{EXPECT_MIS_NAGG}")
    steps, xs = [], []
    for step in range(3):
        t0 = time.perf_counter()
        a = counts.run(lambda: prob.reassemble(1.0 + 0.1 * step))[0]
        counts.run(lambda: solver.update_operator(a.data))
        res, _ = counts.run(lambda: solver.solve(prob.b))
        sync(device)
        steps.append(dict(iters=res.iters, relres=float(res.relres),
                          step_ms=1e3 * (time.perf_counter() - t0)))
        xs.append(res.x)
        if res.iters != EXPECT_MIS_ITERS or \
                int(res.health.status) != HEALTHY:
            raise AssertionError(f"mis path step {step}: {res.iters} "
                                 f"iterations (expected {EXPECT_MIS_ITERS}),"
                                 f" status {int(res.health.status)}")
    per = check_kernels(build_cases(dict(prob=prob, solver=solver), device),
                        PEAKS, timed=False, label="mis ")
    cpu_prob, cpu, cpu_s = _mis_problem("cpu")
    if cpu.setup_data.stats["level_rows"] != sd.stats["level_rows"]:
        raise AssertionError(f"mis path: CPU levels "
                             f"{cpu.setup_data.stats['level_rows']}")
    agg = _aggregates_card_vs_cpu(sd, cpu.setup_data)
    for step, x in enumerate(xs):
        a = cpu_prob.reassemble(1.0 + 0.1 * step)
        cpu.update_operator(a.data)
        res = cpu.solve(cpu_prob.b)
        rel = _rel(x, res.x)
        steps[step].update(cpu_iters=res.iters, rel_diff_cpu=rel)
        if res.iters != steps[step]["iters"] or not rel <= SOLUTION_TOL:
            raise AssertionError(f"mis path step {step}: {res.iters} "
                                 f"iterations on the CPU, solutions differ "
                                 f"by {rel:.3e} (limit {SOLUTION_TOL})")
    if verbose:
        print("mis path " + json.dumps(dict(
            m=MIS_M, coarse_size=MIS_COARSE, level_rows=sd.stats["level_rows"],
            n_agg=n_agg, mis_rounds=sd.stats["mis_rounds"],
            cold_setup_s=setup_s, cpu_setup_s=cpu_s,
            cpu_mis_rounds=cpu.setup_data.stats["mis_rounds"],
            aggregates_card_vs_cpu=agg, steps=steps,
            kernel_cases={k: v["cases"] for k, v in per.items()},
            launches=counts.total)))
    return counts.total, per


def coefficient_path(device="cuda", verbose: bool = True) -> tuple:
    """``ElasticityConfig(m=32)`` as built (device assembly, greedy,
    coarse_size 100, the assembler bound; the main path's levels), then
    ``heterogeneous.py``'s four inclusion contrasts through
    ``update_coefficients`` and a solve each, and a server's
    ``update_coefficients`` and burst.  Every kernel of the path is held
    against its plain version on the last update's hierarchy (the bytes
    an update moves are ``h2d_check``'s).  Returns the path's kernel
    launches and the kernel checks."""
    import numpy as np

    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.fem.assemble import assemble_elasticity, \
        inclusion_fields
    from repro_torch.multirhs import AMGSolveServer
    from repro_torch.robust.health import HEALTHY

    cfg = ElasticityConfig(m=MAIN_M)
    counts = PathCounts()
    reset_counts()
    t0 = time.perf_counter()
    (prob, solver), _ = counts.run(lambda: cfg.build(device=device))
    sync(device)
    build_s = time.perf_counter() - t0
    if prob.assembler is None or solver.assembler is not prob.assembler:
        raise AssertionError("coefficient path: no bound device assembler")
    if solver.setup_data.stats["level_rows"] != EXPECT_LEVEL_ROWS:
        raise AssertionError(f"coefficient path: levels "
                             f"{solver.setup_data.stats['level_rows']}, "
                             f"expected {EXPECT_LEVEL_ROWS}")
    host = assemble_elasticity(cfg.m, order=cfg.order, E=cfg.E, nu=cfg.nu,
                               path="host", device=device)
    a_rel = _rel(prob.A.data, host.A.data)
    del host
    if not a_rel <= REL_TOL:
        raise AssertionError(f"device-assembled A vs host path: {a_rel:.3e}")
    steps = []
    for contrast in CONTRASTS:
        E, nu = inclusion_fields(prob.mesh, E_inclusion=contrast)
        sync(device)
        t0 = time.perf_counter()
        counts.run(lambda: solver.update_coefficients(E, nu))
        sync(device)
        upd_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        res, _ = counts.run(lambda: solver.solve(prob.b))
        sync(device)
        solve_ms = 1e3 * (time.perf_counter() - t0)
        if int(res.health.status) != HEALTHY or not bool(res.converged):
            raise AssertionError(f"contrast {contrast}: status "
                                 f"{int(res.health.status)}, converged "
                                 f"{bool(res.converged)}")
        steps.append(dict(contrast=contrast, iters=res.iters,
                          relres=float(res.relres), update_ms=upd_ms,
                          solve_ms=solve_ms))
    per = check_kernels(build_cases(dict(prob=prob, solver=solver), device),
                        PEAKS, timed=False, label="coeff ")
    srv, _ = counts.run(lambda: AMGSolveServer(
        solver.setup_data, prob.A.data, buckets=BUCKETS,
        assembler=prob.assembler))
    E, nu = inclusion_fields(prob.mesh, E_inclusion=CONTRASTS[-1])
    counts.run(lambda: srv.update_coefficients(E, nu))
    rng = np.random.default_rng(19)
    rhs = [prob.b.cpu().numpy()] + [rng.standard_normal(prob.n)
                                    for _ in range(3)]
    reports, _ = counts.run(lambda: srv.serve(rhs))
    bad = [(r.request_id, r.status) for r in reports
           if r.status != "ok" or not r.converged]
    if bad or reports[0].iters != steps[-1]["iters"]:
        raise AssertionError(f"coefficient server: reports not ok {bad}, or "
                             f"b took {reports[0].iters} iterations against "
                             f"the solver's {steps[-1]['iters']}")
    if verbose:
        print("coefficient path " + json.dumps(dict(
            m=MAIN_M, level_rows=solver.setup_data.stats["level_rows"],
            build_s=build_s, device_vs_host_A_rel=a_rel,
            value_stream_bytes=int(prob.values.numel() * 8), steps=steps,
            server=dict(reports=len(reports),
                        iters=[r.iters for r in reports],
                        stats={k: srv.stats[k] for k in (
                            "coefficient_updates", "recomputes",
                            "batches")},
                        coeff_update_s=srv.metrics()
                        .coeff_update_seconds.snapshot()["sum"]),
            kernel_cases={k: v["cases"] for k, v in per.items()},
            launches=counts.total)))
    return counts.total, per


# ---------------------------------------------------------------------------
# The stored restriction
# ---------------------------------------------------------------------------

def stored_path(run: dict, device="cuda", verbose: bool = True) -> tuple:
    """The main path's configuration with ``restriction="stored"``: setup,
    the main path's 3 hot steps in turns with the transpose-free solver's
    (transpose-free first, then stored first, then transpose-free first;
    13 iterations each, the stored solution within ``REL_TOL`` of the
    transpose-free one of the same step) and a burst of ``PREC_BURST``
    requests through ``AMGSolveServer``, so ``block_spmv`` and
    ``block_spmm`` run on the 6x3 blocks of ``R0``; between them one
    profiled stored hot step, with the device ms of the last ``R``'s
    products in it.  The transpose-free solver ends at the values it
    started from.
    Prints the levels and every ``R``'s shape and fill.  Returns the
    path's launches and its ``(tag, r_ell)`` pairs."""
    import numpy as np
    import torch

    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.core.gamg import GAMGSolver
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.block_spmv import ops as spmv
    from repro_torch.multirhs import AMGSolveServer
    from repro_torch.robust.health import HEALTHY

    cfg = ElasticityConfig(m=MAIN_M)
    prob = run["prob"]
    counts = PathCounts()
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    solver, _ = counts.run(lambda: GAMGSolver(
        prob.A, prob.B, theta=cfg.theta, smoother=cfg.smoother,
        degree=cfg.degree, coarse_size=cfg.coarse_size, coarsener="greedy",
        rtol=cfg.rtol, maxiter=cfg.maxiter, restriction="stored"))
    sync(device)
    setup_s = time.perf_counter() - t0
    sd = solver.setup_data
    if sd.stats["level_rows"] != EXPECT_LEVEL_ROWS:
        raise AssertionError(f"stored path: levels {sd.stats['level_rows']}"
                             f", expected {EXPECT_LEVEL_ROWS}")
    r_ells = [(f"R{li}", ls.r_ell) for li, ls in enumerate(sd.levels)]
    shapes = {tag: dict(shape=list(ell.data.shape),
                        fill=float(ell.mask.float().mean()))
              for tag, ell in r_ells}
    if tuple(sd.levels[0].r_ell.data.shape[2:]) != (6, 3):
        raise AssertionError(f"stored path: R0 blocks {shapes['R0']}")
    tf = run["solver"]

    def hot_step(slv, scale):
        sync(device)
        t0 = time.perf_counter()
        a_new = prob.reassemble(scale)
        slv.update_operator(a_new.data)
        res = slv.solve(prob.b)
        sync(device)
        return res, 1e3 * (time.perf_counter() - t0), a_new

    steps = []
    for step in range(len(run["records"])):
        scale = 1.0 + 0.1 * step
        order = ("tf", "stored") if step % 2 == 0 else ("stored", "tf")
        got = {}
        for name in order:
            if name == "stored":
                got[name], _ = counts.run(
                    lambda: hot_step(solver, scale))
            else:
                got[name] = hot_step(tf, scale)
        (res, ms, a_new), (ref, tf_ms, _) = got["stored"], got["tf"]
        rel = _rel(res.x, ref.x)
        steps.append(dict(step=step, order=list(order), iters=res.iters,
                          relres=float(res.relres),
                          rel_diff_vs_transpose_free=rel, stored_ms=ms,
                          transpose_free_ms=tf_ms))
        if res.iters != EXPECT_ITERS or int(res.health.status) != HEALTHY \
                or res.iters != ref.iters or not rel <= REL_TOL:
            raise AssertionError(f"stored path step {step}: {steps[-1]}")
    prof = profile_hot_step(dict(prob=prob, solver=solver, precision="f64",
                                 restriction="stored"), label="stored ")
    r2 = str(tuple(r_ells[-1][1].data.shape))
    r2_rows = [v for key, v in prof["ell_ms_by_shape"].items()
               if key.split(" ", 1)[1].startswith(r2)]
    r2_ms = sum(t for _, t in r2_rows)
    r2_share = dict(shape=r2, launches=sum(n for n, _ in r2_rows),
                    device_ms=r2_ms,
                    share=r2_ms / prof["device_busy_ms"])
    tf.update_operator(run["a_data"])
    rng = np.random.default_rng(23)
    rhs = [prob.b.cpu().numpy()] + [rng.standard_normal(prob.n)
                                    for _ in range(PREC_BURST - 1)]
    server, _ = counts.run(lambda: AMGSolveServer(sd, a_new.data,
                                                  buckets=BUCKETS))
    reports, _ = counts.run(lambda: server.serve(rhs))
    if any(r.status != "ok" or not r.converged for r in reports) \
            or reports[0].iters != EXPECT_ITERS:
        raise AssertionError(f"stored serve: "
                             f"{[(r.iters, r.status) for r in reports]}")
    by_shape = {"block_spmv": spmv.launches_by_shape[(6, 3)],
                "block_spmm": spmm.launches_by_shape[(6, 3)]}
    if torch.device(device).type == "cuda":     # the CPU runs no kernel
        check_path_launches("stored", counts.total,
                            ("block_spmv", "block_spmm"))
        if min(by_shape.values()) <= 0:
            raise AssertionError(f"stored path: 6x3 launches {by_shape}")
    if verbose:
        print("stored path " + json.dumps(dict(
            m=MAIN_M, level_rows=sd.stats["level_rows"], setup_s=setup_s,
            R=shapes, steps=steps,
            serve=dict(requests=len(rhs), iters=[r.iters for r in reports],
                       buckets=sorted({r.k_bucket for r in reports})),
            launches_6x3=by_shape, r2_in_profiled_step=r2_share,
            launches=counts.total)))
    return counts.total, r_ells


# ---------------------------------------------------------------------------
# The scalar (AIJ) baseline
# ---------------------------------------------------------------------------

def scalar_solve_phases(prob, solver, run: dict, walls: dict) -> None:
    """The profiled scalar step: one ``gamg.hier_solve`` on the scalar
    hierarchy ``run["scalar_hier"]`` (the main path's setup and ``b``),
    timed on the host between synchronizations."""
    from repro_torch.core import gamg
    sync("cuda")
    t0 = time.perf_counter()
    run["scalar_res"] = gamg.hier_solve(
        solver.setup_data, run["scalar_hier"], prob.b, rtol=solver.rtol,
        maxiter=solver.maxiter)
    sync("cuda")
    walls["solve"] = 1e3 * (time.perf_counter() - t0)


def _timed(fn, device="cuda") -> tuple:
    """``fn()`` and its host ms between synchronizations."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, 1e3 * (time.perf_counter() - t0)


def _in_turns(fns: dict, rounds: int = 2) -> tuple:
    """Each ``fns[name]()`` ``2 * rounds`` times in turns (a, b, b, a,
    ...): the last result of each, the median host ms of each and every
    host ms of each in the order taken."""
    names, out, ms = list(fns), {}, {name: [] for name in fns}
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for name in order + order[::-1]:
            out[name], t = _timed(fns[name])
            ms[name].append(t)
    return out, {name: statistics.median(v) for name, v in ms.items()}, ms


def pair_counts(setupd) -> list:
    """Each Galerkin product's pairs in the blocked plan and in the scalar
    plan of the expanded operators, from the blocked structures alone:
    the expansion keeps every structural entry, so a block pair is
    ``br * bk * bc`` scalar pairs."""
    return [dict(level=li, product=tag, blocked=sp.npairs,
                 scalar=sp.npairs * sp.br * sp.bk * sp.bc)
            for li, ls in enumerate(setupd.levels)
            for tag, sp in (("AP", ls.ptap_cache.ap_plan),
                            ("R(AP)", ls.ptap_cache.ac_plan))]


def scalar_byte_counts(setupd, hier_b, hier_s) -> dict:
    """The two formats' bytes: every level operator by the paper's
    formulas (``bcsr_matrix_bytes`` / ``csr_matrix_bytes``) and the
    device bytes of the two numeric hierarchies (``hierarchy_bytes``)."""
    from repro_torch.core.scalar_csr import bcsr_matrix_bytes, \
        csr_matrix_bytes
    ops = [ls.A0 for ls in setupd.levels]
    levels = [dict(level=li, bcsr=bcsr_matrix_bytes(A),
                   csr=csr_matrix_bytes(A),
                   ratio=csr_matrix_bytes(A) / bcsr_matrix_bytes(A))
              for li, A in enumerate(ops)]
    if {"bcsr": levels[0]["bcsr"], "csr": levels[0]["csr"]} != \
            EXPECT_A0_BYTES:
        raise AssertionError(f"A0 bytes {levels[0]}, expected "
                             f"{EXPECT_A0_BYTES}")
    hb, hs = hierarchy_bytes(hier_b), hierarchy_bytes(hier_s)
    return dict(operators=levels, hierarchy_blocked=hb, hierarchy_scalar=hs,
                hierarchy_ratio=hs / hb)


def scalar_cases(hier_s, device) -> list:
    """``block_spmv`` at 1x1 on every scalar ``A``, ``P`` and ``R`` of the
    scalar hierarchy (``ell_cases``: valid entries in the bound, padded
    slots and fill on the line, cuSPARSE CSR the yardstick), and the
    scalar-row smoother step on every level; both rows of their own in the
    record."""
    import torch

    from repro_torch.kernels.autotune import DEFAULT_THREADS
    from repro_torch.kernels.ell_rows import lanes
    from repro_torch.kernels.fused_smoother import ops as smooth
    from repro_torch.kernels.fused_smoother.ref import \
        smoother_step_scalar_ref

    gen = torch.Generator(device=device).manual_seed(3)
    f64 = dict(dtype=torch.float64, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, **f64)

    cases = []
    for li, lv in enumerate(hier_s.levels):
        for tag, ell in (("A", lv.a_ell), ("P", lv.p_ell), ("R", lv.r_ell)):
            cases += ell_cases(f"{tag}{li}s", ell, randn, 8, padded=True,
                               panel_ks=(), record="block_spmv_1x1")
        a = lv.a_ell
        nbr, bs = lv.dinv.shape[:2]
        nnz = int(a.mask.sum())
        b, x, d = (randn(nbr, bs) for _ in range(3))
        args = (a.indices, a.data, lv.dinv, b, x, d,
                torch.tensor([0.3, 0.7], **f64))
        cases.append(Case(
            "fused_smoother",
            f"A{li}s scalar rows ({a.nbr},{a.kmax},1,1) nodes of {bs}",
            lambda threads=None, args=args: smooth.smoother_step_scalar_ell(
                *args, threads=threads),
            lambda args=args: smoother_step_scalar_ref(*args),
            nbytes=nnz * (8 + 4) + nbr * bs * bs * 8 + 5 * nbr * bs * 8,
            flops=2 * nnz + 2 * nbr * bs * bs + 4 * nbr * bs,
            lanes=lanes(1, 1, a.kmax),
            at_lanes=lambda n, args=args: smooth.launch_scalar_lanes(
                *args, n, DEFAULT_THREADS),
            extra=dict(valid_blocks=nnz, padded_blocks=a.nbr * a.kmax),
            record="fused_smoother_scalar"))
    return cases


def check_scalar_identity(hier_s, device) -> int:
    """With ``dinv = I`` and ``coef = [0, 1]`` the scalar-row step's
    ``d'`` is bitwise ``b - block_spmv(x)`` at 1x1, on every level."""
    import torch

    from repro_torch.kernels.block_spmv import ops as spmv
    from repro_torch.kernels.fused_smoother import ops as smooth
    gen = torch.Generator(device=device).manual_seed(4)
    f64 = dict(dtype=torch.float64, device=device)
    for li, lv in enumerate(hier_s.levels):
        a = lv.a_ell
        nbr, bs = lv.dinv.shape[:2]
        b, x, d = (torch.randn(nbr, bs, generator=gen, **f64)
                   for _ in range(3))
        eye = torch.eye(bs, **f64).expand(nbr, bs, bs).contiguous()
        _, dn = smooth.smoother_step_scalar_ell(
            a.indices, a.data, eye, b, x, d, torch.tensor([0.0, 1.0], **f64))
        res = b.reshape(-1) - spmv.block_spmv_ell(
            a.indices, a.data, x.reshape(-1, 1)).reshape(-1)
        if not torch.equal(dn.reshape(-1), res):
            raise AssertionError(f"identity scalar smoother A{li}s: d' not "
                                 f"bitwise b - block_spmv(x)")
    return len(hier_s.levels)


def scalar_cpu_vs_cuda(devices=("cpu", "cuda")) -> dict:
    """The scalar solve at m=7 (greedy, coarse_size 12, host assembly) on
    the CPU and on the card: equal levels and iterations (the blocked
    solve's too), solutions within ``SCALAR_CPU_TOL``."""
    from repro_torch.core import gamg
    from repro_torch.core.scalar_path import recompute_scalar
    from repro_torch.fem.assemble import assemble_elasticity
    got = {}
    for dev in devices:
        prob = assemble_elasticity(SCALAR_CHECK_M, path="host", device=dev)
        sd = gamg.setup(prob.A, prob.B, coarse_size=CHECK_COARSE,
                        coarsener="greedy")
        res = gamg.hier_solve(sd, recompute_scalar(sd, prob.A.data), prob.b)
        blocked = gamg.hier_solve(sd, gamg.recompute(sd, prob.A.data),
                                  prob.b)
        got[dev] = (sd.stats["level_rows"], res, blocked.iters)
    (rows_c, rc, bc), (rows_g, rg, bg) = got[devices[0]], got[devices[1]]
    rel = _rel(rg.x, rc.x)
    out = dict(m=SCALAR_CHECK_M, level_rows=rows_c, iters=[rc.iters,
                                                           rg.iters],
               blocked_iters=[bc, bg], rel_diff=rel)
    if rows_c != rows_g or not rc.iters == rg.iters == bc == bg \
            or not rel <= SCALAR_CPU_TOL:
        raise AssertionError(f"scalar cpu vs cuda: {out}")
    return out


def scalar_chain_phase(counts: PathCounts, device="cuda") -> tuple:
    """The scalar PtAP chain at ``SCALAR_CHAIN_M`` (the paper's setting,
    greedy, host assembly): its cold build (host symbolic of the scalar
    plans), its outputs against the expansion of the blocked chain's per
    level (``SCALAR_CHAIN_TOL``), both chains' ms in turns and both
    formats' pair counts.  The chain's build and runs count in
    ``counts``.  Returns the line and the chain's stages and expanded fine
    payload (``galerkin_cases``' inputs)."""
    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.core import gamg
    from repro_torch.core.block_csr import BlockCSR
    from repro_torch.core.ptap import ptap_numeric_data
    from repro_torch.core.scalar_csr import expand_bcsr
    from repro_torch.core.scalar_path import build_scalar_ptap_chain
    from repro_torch.fem.assemble import assemble_elasticity

    cfg = ElasticityConfig(m=SCALAR_CHAIN_M)
    prob = assemble_elasticity(cfg.m, order=cfg.order, E=cfg.E, nu=cfg.nu,
                               path="host", device=device)
    sd = gamg.setup(prob.A, prob.B, theta=cfg.theta,
                    coarse_size=cfg.coarse_size, coarsener="greedy")
    chain, build_ms = _timed(
        _counted(counts, lambda: build_scalar_ptap_chain(sd)), device)

    def blocked():
        a, outs = prob.A.data, []
        for ls in sd.levels:
            a = ptap_numeric_data(ls.ptap_cache, a, ls.P.data)
            outs.append(a)
        return outs

    outs, ms, _ = _in_turns({
        "blocked": blocked,
        "scalar": _counted(counts, lambda: chain(prob.A.data))})
    rel = []
    for ls, b_out, s_out in zip(sd.levels, outs["blocked"], outs["scalar"]):
        cache = ls.ptap_cache
        want = expand_bcsr(BlockCSR.from_arrays(
            cache.ac_plan.indptr, cache.ac_plan.indices, b_out,
            cache.n_coarse)).data
        rel.append(_rel(s_out, want))
    pairs = [dict(level=li, product=tag, blocked=bp.npairs,
                  scalar=sp.npairs,
                  expected=bp.npairs * bp.br * bp.bk * bp.bc)
             for li, (ls, (cs, _)) in enumerate(zip(sd.levels, chain.stages))
             for tag, bp, sp in (("AP", ls.ptap_cache.ap_plan,
                                  cs.ap_plan),
                                 ("R(AP)", ls.ptap_cache.ac_plan,
                                  cs.ac_plan))]
    line = dict(m=SCALAR_CHAIN_M, level_rows=sd.stats["level_rows"],
                cold_build_s=build_ms / 1e3, rel_vs_expanded_blocked=rel,
                blocked_chain_ms=ms["blocked"], scalar_chain_ms=ms["scalar"],
                ratio=ms["scalar"] / ms["blocked"], pairs=pairs,
                scalar_tile_plans=[
                    [sp.tile_rows, sp.pair_kmax, sp.tile_identity]
                    for cs, _ in chain.stages
                    for sp in (cs.ap_plan, cs.ac_plan)])
    if not all(r <= SCALAR_CHAIN_TOL for r in rel) or any(
            p["scalar"] != p["expected"] for p in pairs):
        raise AssertionError(f"scalar chain: {line}")
    return line, chain.stages, chain.expand_fine(prob.A.data)


def _counted(counts: PathCounts, fn):
    """``fn`` with its launches counted in ``counts``."""
    return lambda: counts.run(fn)[0]


def scalar_path(run: dict, peaks: tuple, device="cuda") -> tuple:
    """The scalar (AIJ) baseline on the main path's m=32 setup and values:
    the cold expansion, ``recompute_scalar`` against ``gamg.recompute``
    (in turns), the scalar hot solve on ``b`` against the blocked one (in
    turns, every wall printed: equal iterations, ``EXPECT_ITERS``; relres;
    the solutions' difference), A0's SpMV three ways (blocked
    ``block_spmv``, 1x1 ``block_spmv``, cuSPARSE CSR), both formats'
    bytes and pair counts, one profiled scalar solve, then the CPU-vs-card
    scalar solve at ``SCALAR_CHECK_M`` and the scalar PtAP chain at
    ``SCALAR_CHAIN_M``.  The path's launches are those of its own calls
    only: the scalar levels, ``recompute_scalar``, the scalar solves and
    the scalar chain (not the blocked comparators, the timing loops, the
    checks or the profiled solve).  Then every 1x1 and scalar-row case
    against its plain version and the identity-residual check.  Returns
    ``(launches of the blocked instantiations by family, launches by
    scalar entry, launches per scalar hot step, per)``."""
    import torch

    from repro_torch.core import gamg
    from repro_torch.core.scalar_path import recompute_scalar, \
        scalar_levels
    from repro_torch.kernels.autotune import device_ms
    from repro_torch.kernels.block_spmv import ops as spmv

    prob, solver = run["prob"], run["solver"]
    sd, a = solver.setup_data, run["a_data"]
    kw = dict(rtol=solver.rtol, maxiter=solver.maxiter)
    t_phase = time.perf_counter()
    counts = PathCounts()
    _, cold_ms = _timed(_counted(counts, lambda: scalar_levels(sd)))
    _, first_ms = _timed(_counted(counts, lambda: recompute_scalar(sd, a)))
    hiers, rec_ms, _ = _in_turns({
        "blocked": lambda: gamg.recompute(sd, a),
        "scalar": _counted(counts, lambda: recompute_scalar(sd, a))})
    hier_b, hier_s = hiers["blocked"], hiers["scalar"]
    e0 = dict(counts.entries)
    counts.run(lambda: gamg.hier_solve(sd, recompute_scalar(sd, a), prob.b,
                                       **kw))
    per_step = _diff(counts.entries, e0)
    res, solve_ms, walls = _in_turns({
        "blocked": lambda: gamg.hier_solve(sd, hier_b, prob.b, **kw),
        "scalar": _counted(counts, lambda: gamg.hier_solve(
            sd, hier_s, prob.b, **kw))})
    rb, rs = res["blocked"], res["scalar"]
    rel = _rel(rs.x, rb.x)
    solve = dict(iters=[rb.iters, rs.iters],
                 relres=[float(rb.relres), float(rs.relres)],
                 rel_diff=rel, blocked_ms=solve_ms["blocked"],
                 scalar_ms=solve_ms["scalar"], walls_ms=walls)
    if not rb.iters == rs.iters == EXPECT_ITERS or not rel <= 1e-6 \
            or not (rb.converged and rs.converged):
        raise AssertionError(f"scalar solve: {solve}")
    a0b, a0s = hier_b.levels[0].a_ell, hier_s.levels[0].a_ell
    x = torch.randn(a0b.nbc * a0b.bc, dtype=torch.float64, device=device,
                    generator=torch.Generator(device=device).manual_seed(5))
    csr = _scalar_csr(a0b)
    spmv_ms = dict(
        blocked_3x3=device_ms(lambda: spmv.block_spmv(a0b, x)),
        scalar_1x1=device_ms(lambda: spmv.block_spmv(a0s, x)),
        cusparse_csr=device_ms(lambda: torch.mv(csr, x)))
    if _rel(spmv.block_spmv(a0s, x), spmv.block_spmv(a0b, x)) > REL_TOL:
        raise AssertionError("scalar A0 SpMV disagrees with the blocked one")
    spmv_ms["scalar_over_blocked"] = spmv_ms["scalar_1x1"] / \
        spmv_ms["blocked_3x3"]
    run["scalar_hier"] = hier_s
    prof = profile_hot_step(run, label="scalar ", scalar=True)
    print("scalar path " + json.dumps(dict(
        m=MAIN_M, level_rows=sd.stats["level_rows"],
        cold_expansion_ms=cold_ms, first_recompute_scalar_ms=first_ms,
        recompute_ms=rec_ms, solve=solve, a0_spmv_device_ms=spmv_ms,
        bytes=scalar_byte_counts(sd, hier_b, hier_s),
        pairs_m32=pair_counts(sd),
        scalar_levels=[dict(a=list(lv.a_ell.data.shape[:2]),
                            p=list(lv.p_ell.data.shape[:2]),
                            r=list(lv.r_ell.data.shape[:2]),
                            dinv=list(lv.dinv.shape))
                       for lv in hier_s.levels],
        profiled=dict(device_busy_ms=prof["device_busy_ms"],
                      idle_share=prof["idle_share"],
                      library_events=prof["library_events"],
                      library_launches=prof["library_launches"]))))
    print("scalar cpu vs cuda " + json.dumps(scalar_cpu_vs_cuda(
        ("cpu", device))))
    line, stages, s_fine = scalar_chain_phase(counts, device)
    print("scalar chain " + json.dumps(line))
    # each family's row counts its blocked instantiations; the 1x1 and
    # scalar-row launches are the entries' own rows
    blocked = dict(counts.total)
    for rec, (fam, _) in SCALAR_KERNELS.items():
        blocked[fam] -= counts.entries[rec]
    print("scalar path launches " + json.dumps(dict(
        blocked_families=blocked, entries=counts.entries,
        per_scalar_hot_step=per_step,
        driven_s=time.perf_counter() - t_phase)))
    if torch.device(device).type == "cuda":     # the CPU runs no kernel
        for rec, n in counts.entries.items():
            if n <= 0:
                raise AssertionError(f"{rec} did not launch on the scalar "
                                     f"path")
    cases = scalar_cases(hier_s, device) + galerkin_cases(
        stages, s_fine, device, scalar=True)
    attach_floors(cases)
    per = check_kernels(cases, peaks, label="scalar ")
    print("scalar identity smoother " + json.dumps(dict(
        levels_bitwise=check_scalar_identity(hier_s, device),
        phase_s=time.perf_counter() - t_phase)))
    return blocked, counts.entries, per_step, per


def _scalar_entry_counts() -> dict:
    """Launches of the scalar baseline's entries (``SCALAR_KERNELS``),
    from the wrappers' ``launches_by_shape``."""
    ops = _ops()
    return {rec: sum(ops[fam].launches_by_shape[k] for k in keys)
            for rec, (fam, keys) in SCALAR_KERNELS.items()}


# ---------------------------------------------------------------------------
# The robustness layer: fault schedules and the recovery ladder
# ---------------------------------------------------------------------------

#: the ladder's outcomes at m=32; the persistent fault's status is the
#: reference's on the same schedule (tests/test_torch_robust.py, m=6)
ROBUST_EXPECT = {
    "healthy": ("ok", ()),
    "transient": ("recovered", ("recompute",)),
    "persistent": ("degraded", ("recompute", "re-setup", "reference-path")),
    "bf16": ("recovered", ("recompute", "re-setup", "f64-rebuild")),
}


def robust_path(run: dict, device="cuda", verbose: bool = True) -> dict:
    """The recovery ladder on the main path's step-0 values (``b``,
    ``ElasticityConfig(m=32)``, greedy): (a) ``RobustSolver`` healthy, its
    solution bitwise the main path's step 0; (b) a transient
    ``precond:nan@3``: recovered by the recompute rung, bitwise (a), and
    a second solve under the schedule ``ok`` on the rung's closures; (c)
    the same fault persistent: every rung runs and the status is the
    reference's, the last rung on the ``pairs`` Galerkin kernels
    (``block_pair_gemm`` launches, and launches again in a later
    ``update_operator``); (d) the ``"bf16"`` policy, whose
    coarse factor is NaN on these values: recovered by the f64 rebuild,
    13 iterations, within ``REL_TOL`` of (a); (e) ``AMGSolveServer(
    recover=...)`` under a transient fault: the faulted column recovered
    by its retry, the others ok.  Returns the path's launches."""
    import numpy as np
    import torch

    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.kernels.block_pair_gemm import ops as pair
    from repro_torch.multirhs import AMGSolveServer
    from repro_torch.robust import inject
    from repro_torch.robust.recover import RecoveryPolicy, RobustSolver

    cfg = ElasticityConfig(m=MAIN_M)
    prob = run["prob"]
    opts = dict(theta=cfg.theta, smoother=cfg.smoother, degree=cfg.degree,
                coarse_size=cfg.coarse_size, coarsener="greedy",
                rtol=cfg.rtol, maxiter=cfg.maxiter)
    x_main = run["records"][0]["x"]
    counts = PathCounts()
    reset_counts()
    A0 = counts.run(lambda: prob.reassemble(1.0))[0]
    out = {}

    def ladder(case, schedule=None, **kw):
        """A ``RobustSolver`` set up under ``schedule`` (the reference's
        schedules bind at trace time, so a faulted solver is built under
        its schedule) and its first solve; returns the solver and the
        outcome."""
        with inject.active(schedule):
            sync(device)
            t0 = time.perf_counter()
            solver, _ = counts.run(lambda: RobustSolver(A0, prob.B,
                                                        **opts, **kw))
            sync(device)
            t1 = time.perf_counter()
            pairs0 = pair.launches
            res, _ = counts.run(lambda: solver.solve(prob.b))
            sync(device)
        rec = dict(status=res.status, attempts=list(res.attempts),
                   iters=res.result.iters, relres=float(res.result.relres),
                   setup_s=t1 - t0, ms=1e3 * (time.perf_counter() - t1),
                   pair_gemm_launches=pair.launches - pairs0)
        if (res.status, tuple(res.attempts)) != ROBUST_EXPECT[case]:
            raise AssertionError(f"robust {case}: {rec}, expected "
                                 f"{ROBUST_EXPECT[case]}")
        if res.status == "failed" and bool(res.x.any()):
            raise AssertionError(f"robust {case}: a failed x is not zero")
        out[case] = rec
        return solver, res

    _, a = ladder("healthy")
    if a.result.iters != EXPECT_ITERS or not torch.equal(a.x, x_main):
        raise AssertionError(f"robust healthy: {a.result.iters} iterations,"
                             f" x bitwise the main path's step 0: "
                             f"{torch.equal(a.x, x_main)}")
    transient = inject.parse_schedule("precond:nan@3")
    rs, b = ladder("transient", transient)
    if b.result.iters != EXPECT_ITERS or not torch.equal(b.x, a.x):
        raise AssertionError(f"robust transient: {b.result.iters} "
                             f"iterations, x bitwise (a): "
                             f"{torch.equal(b.x, a.x)}")
    # the rung's rebuilt closures stay clean of the transient fault
    with inject.active(transient):
        again, _ = counts.run(lambda: rs.solve(prob.b))
    out["transient"]["second_solve"] = again.status
    if again.status != "ok" or not torch.equal(again.x, a.x):
        raise AssertionError(f"robust transient, second solve: "
                             f"{again.status}, x bitwise (a): "
                             f"{torch.equal(again.x, a.x)}")
    rs, c = ladder("persistent",
                   inject.parse_schedule("precond:nan@3:persistent"))
    cuda = torch.device(device).type == "cuda"
    if (cuda and out["persistent"]["pair_gemm_launches"] <= 0) \
            or not bool(torch.isfinite(c.x).all()):
        raise AssertionError(f"robust persistent: {out['persistent']}")
    # ... and keep the reference-path rung's Galerkin path afterwards
    pairs0 = pair.launches
    counts.run(lambda: rs.update_operator(A0.data))
    sync(device)
    out["persistent"]["update_pair_gemm_launches"] = n = \
        pair.launches - pairs0
    if cuda and n <= 0:
        raise AssertionError(f"robust persistent: update_operator after "
                             f"the reference-path rung launched no "
                             f"block_pair_gemm")
    _, d = ladder("bf16", precision="bf16")
    out["bf16"]["rel_diff_vs_f64"] = rel = _rel(d.x, a.x)
    if d.result.iters != EXPECT_ITERS or not rel <= REL_TOL:
        raise AssertionError(f"robust bf16: {out['bf16']}")
    rng = np.random.default_rng(5)
    rhs = [prob.b.cpu().numpy()] + [rng.standard_normal(prob.n)
                                    for _ in range(PREC_BURST - 1)]
    srv, _ = counts.run(lambda: AMGSolveServer(
        run["solver"].setup_data, A0.data, buckets=BUCKETS,
        recover=RecoveryPolicy()))
    with inject.active(inject.parse_schedule("precond:nan@3")):
        reports, _ = counts.run(lambda: srv.serve(rhs))
    status = [r.status for r in reports]
    rel0 = _rel(torch.as_tensor(reports[0].x), a.x)
    out["server"] = dict(status=status, iters=[r.iters for r in reports],
                         recovered=srv.stats["recovered"],
                         retry_s=srv.metrics().registry.histogram(
                             "server/retry_seconds").snapshot()["sum"],
                         rel_diff_b_vs_a=rel0)
    if status != ["recovered"] + ["ok"] * (PREC_BURST - 1) \
            or not all(r.converged for r in reports) \
            or reports[0].iters != EXPECT_ITERS or not rel0 <= SOLUTION_TOL:
        raise AssertionError(f"robust server: {out['server']}")
    if verbose:
        print("robust path " + json.dumps(dict(
            m=MAIN_M, **out, launches=counts.total)))
    return counts.total


# ---------------------------------------------------------------------------
# The torch quickstart
# ---------------------------------------------------------------------------

def quickstart_phase(m: int = QUICKSTART_M) -> dict:
    """``python -m repro_torch.quickstart m`` on the card as a child
    process, beside the same run on the CPU in this process: both
    converge, with equal levels and per-step iterations."""
    from repro_torch import quickstart
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.quickstart", str(m)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env)
    try:
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            cpu = quickstart.main(m, device="cpu")
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    card_s = time.perf_counter() - t0
    lines = stdout.strip().splitlines()
    if child.returncode or not lines:
        raise AssertionError(f"quickstart exited {child.returncode}:\n"
                             f"{stdout[-2000:]}\n{stderr[-4000:]}")
    card = json.loads(lines[-1])
    if not card["converged"] or not card["device"].startswith("cuda") or \
            (card["level_rows"], card["iters"]) != (cpu["level_rows"],
                                                    cpu["iters"]):
        raise AssertionError(f"quickstart m={m}: card {card}, cpu {cpu}")
    return dict(card=card, cpu=cpu, wall_s=card_s,
                steps=[ln for ln in lines if ln.startswith("step ")])


def check_path_launches(name: str, launches: dict, kernels) -> None:
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"{k} did not launch on the {name} path")


# ---------------------------------------------------------------------------
# Kernel vs plain version at the main path's shapes
# ---------------------------------------------------------------------------

class Case:
    """One kernel call at a main-path shape: the wrapper, the plain version
    and an optional one-call PyTorch yardstick on the same inputs.  A
    tuned kernel's ``run`` takes ``threads=`` (None resolves it)."""

    def __init__(self, kernel, label, run, plain, nbytes, flops,
                 library=None, lanes=None, at_lanes=None, extra=None,
                 record=None):
        self.kernel, self.label = kernel, label
        # the record's row the case adds to (default: its family's; the
        # scalar baseline's entries have rows of their own)
        self.record = record or kernel
        self.run, self.plain, self.library = run, plain, library
        self.nbytes, self.flops = nbytes, flops
        # printed with the case (fused_pair_gemm: gather bytes, the time
        # before the redesign)
        self.extra = extra or {}
        # the ELL kernels (block_spmv, block_spmm, fused_smoother): the
        # map's lanes, and the kernel at any lanes (256 threads) for the
        # sweep of the map's choice
        self.lanes, self.at_lanes = lanes, at_lanes
        # the empty kernel's device ms at this case's grid
        self.floor_ms = None


def _unique_count(idx, mask=None) -> int:
    import torch
    sel = idx if mask is None else idx[mask]
    return int(torch.unique(sel).numel())


def build_cases(run: dict, device, dtype=None, extra_ells=()) -> list:
    """Every kernel at the run's shapes, at payload ``dtype`` (default f64:
    the run's hierarchy holds its payloads at the run's policy dtype);
    ``block_spmv`` and ``block_spmm`` also on each ``(tag, ell)`` of
    ``extra_ells`` (the stored restrictions ``R0``.., cast to ``dtype``),
    whose bound, like every ELL case's, counts the valid blocks only;
    their lines add the padded slots and the fill.
    Below f64 the COO stream (assembled at the Krylov dtype, f64) is left
    out, the Galerkin products run at the policy's kernel accumulator (f32
    for bf16) and ``block_pair_gemm`` at bf16 keeps its products at that
    accumulator, as the pairs path does.  The scalar-CSR yardsticks
    (cuSPARSE through ``torch.mv`` / ``torch.sparse.mm``) take every
    payload dtype on the card."""
    import torch

    from repro_torch.core.block_csr import device_array
    from repro_torch.core.gamg import _at
    from repro_torch.kernels.autotune import DEFAULT_THREADS
    from repro_torch.kernels.block_seg_sum import ops as seg
    from repro_torch.kernels.block_seg_sum.ref import block_seg_sum_ref
    from repro_torch.kernels.ell_rows import lanes
    from repro_torch.kernels.fused_smoother import ops as smooth
    from repro_torch.kernels.fused_smoother.ref import smoother_step_ref
    from repro_torch.kernels.pbjacobi import ops as pbj
    from repro_torch.kernels.pbjacobi.ref import pbjacobi_update_ref

    prob, solver = run["prob"], run["solver"]
    setupd, hier = solver.setup_data, solver.hierarchy
    gen = torch.Generator(device=device).manual_seed(0)
    dtype = dtype or torch.float64
    f64 = dict(dtype=dtype, device=device)
    es = torch.empty((), dtype=dtype).element_size()   # payload bytes

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           device=device).to(dtype)

    cases = []
    # --- block_seg_sum: the COO reassembly stream (f64 only) -------------
    plan = prob.coo_plan
    if dtype == torch.float64:
        vals = (prob.values * 1.2).contiguous()
        offs = device_array(plan, "offsets", device, torch.int32)
        perm = device_array(plan, "perm", device, torch.int32)
        kept = vals[device_array(plan, "keep", device)]
        slot_of_kept = torch.empty_like(device_array(plan, "keep", device))
        slot_of_kept[device_array(plan, "order", device)] = device_array(
            plan, "out_idx_sorted", device)
        n_kept = int(perm.numel())
        cases.append(Case(
            "block_seg_sum", f"coo stream {n_kept}x3x3 -> {plan.nnzb}",
            lambda: seg.block_seg_sum(vals, offs, perm),
            lambda: block_seg_sum_ref(vals, offs, perm),
            nbytes=n_kept * (72 + 4) + offs.numel() * 4 + plan.nnzb * 72,
            flops=n_kept * 9,
            library=lambda: torch.zeros((plan.nnzb, 3, 3), **f64)
            .index_add_(0, slot_of_kept, kept)))

    # --- block_spmv and fused_smoother on every level operator, block_spmv
    # on every prolongator --------------------------------------------------
    for li, lv in enumerate(hier.levels):
        for tag, ell in (("A", lv.a_ell), ("P", lv.p_ell)):
            cases += ell_cases(f"{tag}{li}", ell, randn, es)
        a = lv.a_ell
        bs = a.br
        nnz = int(a.mask.sum())
        nl = lanes(bs, bs, a.kmax)
        coef = torch.tensor([0.3, 0.7], **f64)
        for k in (None, PANEL_KS[0]):
            cols = () if k is None else (k,)
            b, x, d = (randn(a.nbr, bs, *cols) for _ in range(3))
            args = (a.indices, a.data, lv.dinv, b, x, d, coef)
            cases.append(Case(
                "fused_smoother", f"A{li} ({a.nbr},{a.kmax},{bs},{bs})"
                + ("" if k is None else f" k={k}"),
                lambda threads=None, args=args, a=a:
                smooth.smoother_step_ell(*args, threads=threads,
                                         lengths=a.lengths),
                lambda args=args: smoother_step_ref(*args),
                nbytes=nnz * (bs * bs * es + 4) + a.nbr * bs * bs * es
                + 5 * a.nbr * bs * (k or 1) * es,
                flops=(k or 1) * (2 * nnz * bs * bs + 2 * a.nbr * bs * bs
                                  + 4 * a.nbr * bs),
                lanes=nl, at_lanes=lambda n, args=args, a=a:
                smooth.launch_lanes(*args, n, DEFAULT_THREADS,
                                    lengths=a.lengths)))
        # pbjacobi at the level's dinv shape; torch.baddbmm computes the
        # same x + omega * dinv @ r in one call
        r, x = randn(a.nbr, bs), randn(a.nbr, bs)
        cases.append(Case(
            "pbjacobi", f"L{li} dinv ({a.nbr},{bs},{bs})",
            lambda threads=None, lv=lv, r=r, x=x: pbj.pbjacobi_update(
                lv.dinv, r, x, OMEGA, threads=threads),
            lambda lv=lv, r=r, x=x: pbjacobi_update_ref(lv.dinv, r, x,
                                                        OMEGA),
            nbytes=a.nbr * bs * bs * es + 3 * a.nbr * bs * es,
            flops=a.nbr * bs * (2 * bs + 2),
            library=lambda lv=lv, r=r, x=x: torch.baddbmm(
                x[..., None], lv.dinv, r[..., None], alpha=OMEGA)[..., 0],
            extra=dict(nbr=a.nbr, bs=bs)))

    # --- the Galerkin products of every level -------------------------------
    cases += galerkin_cases(
        [(ls.ptap_cache, ls.P.data.to(dtype)) for ls in setupd.levels],
        prob.A.data.to(dtype), device, dtype)
    # --- the stored restrictions (6x3 at level 0) ---------------------------
    for tag, ell in extra_ells:
        cases += ell_cases(tag, _at(ell, dtype), randn, es, padded=True)
    return cases


def ell_cases(name, ell, randn, es, padded=False, panel_ks=PANEL_KS,
              record=None) -> list:
    """``block_spmv`` and ``block_spmm`` (``panel_ks``) on ``ell``, inputs
    from ``randn``, payloads of ``es`` bytes; the bound counts the valid
    blocks, which is all the product needs.  ``padded`` cases (the stored
    ``R``, the scalar operators, whose rows are ragged) also carry their
    valid and padded blocks and fill, so the padding the kernel reads
    shows as its gap to the bound.  ``record``: the record's row of the
    ``block_spmv`` cases (default the family's)."""
    import torch

    from repro_torch.kernels.autotune import DEFAULT_THREADS
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.block_spmm.ref import block_spmm_ell_ref
    from repro_torch.kernels.block_spmv import ops as spmv
    from repro_torch.kernels.block_spmv.ref import block_spmv_ell_ref
    from repro_torch.kernels.ell_rows import lanes

    cases = []
    nnz = blocks = int(ell.mask.sum())
    slots = ell.nbr * ell.kmax
    extra = dict(valid_blocks=nnz, padded_blocks=slots,
                 fill=nnz / slots) if padded else None
    x = randn(ell.nbc, ell.bc)
    csr = _scalar_csr(ell)
    xf = x.reshape(-1)
    nl = lanes(ell.br, ell.bc, ell.kmax)
    shape = f"{name} ({ell.nbr},{ell.kmax},{ell.br},{ell.bc})"
    cases.append(Case(
        "block_spmv", shape,
        lambda threads=None, ell=ell, x=x: spmv.block_spmv_ell(
            ell.indices, ell.data, x, threads=threads),
        lambda ell=ell, x=x: block_spmv_ell_ref(ell.indices, ell.data, x),
        nbytes=blocks * (ell.br * ell.bc * es + 4) + x.numel() * es
        + ell.nbr * ell.br * es,
        flops=2 * blocks * ell.br * ell.bc,
        library=lambda csr=csr, xf=xf: torch.mv(csr, xf), lanes=nl,
        at_lanes=lambda n, ell=ell, x=x: spmv.launch_lanes(
            ell.indices, ell.data, x, n, DEFAULT_THREADS),
        extra=extra, record=record))
    for k in panel_ks:
        X = randn(ell.nbc, ell.bc, k)
        Xf = X.reshape(ell.nbc * ell.bc, k)
        cases.append(Case(
            "block_spmm", f"{shape} k={k}",
            lambda threads=None, ell=ell, X=X: spmm.block_spmm_ell(
                ell.indices, ell.data, X, threads=threads),
            lambda ell=ell, X=X: block_spmm_ell_ref(ell.indices, ell.data,
                                                    X),
            nbytes=blocks * (ell.br * ell.bc * es + 4)
            + X.numel() * es + ell.nbr * ell.br * k * es,
            flops=2 * blocks * ell.br * ell.bc * k,
            library=lambda csr=csr, Xf=Xf: torch.sparse.mm(csr, Xf),
            lanes=nl, at_lanes=lambda n, ell=ell, X=X: spmm.launch_lanes(
                ell.indices, ell.data, X, n, DEFAULT_THREADS),
            extra=None if extra is None else dict(extra)))
    return cases


def galerkin_cases(stages, a_data, device, dtype=None,
                   scalar: bool = False) -> list:
    """``fused_pair_gemm`` on both Galerkin products of every ``(cache,
    p_data)`` stage of a PtAP chain fed ``a_data``, the ``block_seg_sum``
    row-split combine where rows split and ``block_pair_gemm`` on the
    "pairs" path's operands, at payload ``dtype`` (default f64; bf16 runs
    at the policy's f32 accumulator and ``block_pair_gemm`` keeps its
    products there, as the pairs path does).  ``scalar``: the 1x1 stages
    of the scalar chain (labels ``level<i>s``, the records'
    ``<family>_1x1`` rows, no ``block_pair_gemm``, which has no 1x1
    instantiation).  Each bound counts the distinct operand blocks, the
    plan and one output block per tile row."""
    import torch

    from repro_torch.core.block_csr import device_array
    from repro_torch.core.ptap import ptap_numeric_data
    from repro_torch.core.spgemm import spgemm_numeric_data
    from repro_torch.kernels.block_pair_gemm import ops as pair
    from repro_torch.kernels.block_pair_gemm.ref import block_pair_gemm_ref
    from repro_torch.kernels.block_seg_sum import ops as seg
    from repro_torch.kernels.block_seg_sum.ref import block_seg_sum_ref
    from repro_torch.kernels.fused_pair_gemm import ops as gemm
    from repro_torch.kernels.fused_pair_gemm.ref import fused_pair_gemm_ref

    dtype = dtype or torch.float64
    f64 = dict(dtype=dtype, device=device)
    es = torch.empty((), dtype=dtype).element_size()   # payload bytes
    bf16 = dtype == torch.bfloat16
    acc = torch.float32 if bf16 else None       # the policy's accumulator
    acc_es = 4 if bf16 else es
    lvl = "s" if scalar else ""
    cases = []
    for li, (cache, p_data) in enumerate(stages):
        r_data = p_data[device_array(cache, "r_perm", device)].transpose(
            1, 2).contiguous()
        ap = spgemm_numeric_data(cache.ap_plan, a_data, p_data,
                                 accum_dtype=acc)
        for tag, sp, lhs_data, rhs_data in (("AP", cache.ap_plan, a_data,
                                             p_data),
                                            ("R(AP)", cache.ac_plan, r_data,
                                             ap)):
            ta = device_array(sp, "tile_pair_a", device, torch.int32)
            tb = device_array(sp, "tile_pair_b", device, torch.int32)
            tm = device_array(sp, "tile_mask", device, torch.bool)
            gargs = (lhs_data, rhs_data, ta, tb, tm)
            lhs = torch.where(tm[..., None, None], lhs_data[ta.long()],
                              torch.zeros((), **f64))
            rhs = rhs_data[tb.long()]
            br, bk, bc = sp.br, sp.bk, sp.bc
            if not scalar:
                # the "pairs" path's operands: one gathered block per pair;
                # bf16 products stay at the f32 accumulator
                plhs = lhs_data[device_array(sp, "pair_a", device)]
                prhs = rhs_data[device_array(sp, "pair_b", device)]
                pkw = dict(accum_dtype=acc, out_dtype=acc) if bf16 else {}
                cases.append(Case(
                    "block_pair_gemm",
                    f"level{li} {tag} {sp.npairs} pairs ({br},{bk},{bc})",
                    lambda plhs=plhs, prhs=prhs, pkw=pkw:
                    pair.block_pair_gemm(plhs, prhs, **pkw),
                    lambda plhs=plhs, prhs=prhs, pkw=pkw:
                    block_pair_gemm_ref(plhs, prhs, **pkw),
                    nbytes=sp.npairs * ((br * bk + bk * bc) * es
                                        + br * bc * acc_es),
                    flops=2 * sp.npairs * br * bk * bc,
                    library=lambda plhs=plhs, prhs=prhs: torch.bmm(plhs,
                                                                   prhs)))
            nbytes = (_unique_count(ta, tm) * br * bk * es
                      + _unique_count(tb, tm) * bk * bc * es
                      + ta.numel() * 9 + sp.tile_rows * br * bc * es)
            # what the tile plan gathers when every pair reads its own
            # blocks: valid slots x (lhs + rhs block bytes)
            gather = int(tm.sum()) * (br * bk + bk * bc) * es
            key = f"level{li}{lvl} {tag} {sp.tile_rows}x{sp.pair_kmax}"
            cases.append(Case(
                "fused_pair_gemm",
                f"{key} ({br},{bk},{bc})",
                lambda threads=None, gargs=gargs: gemm.fused_pair_gemm(
                    *gargs, threads=threads, accum_dtype=acc),
                lambda gargs=gargs: fused_pair_gemm_ref(*gargs,
                                                        accum_dtype=acc),
                nbytes=nbytes, flops=2 * sp.npairs * br * bk * bc,
                library=lambda lhs=lhs, rhs=rhs: torch.einsum(
                    "skij,skjl->sil", lhs, rhs),
                extra=dict(gather_bytes=gather, before_ms=(
                    BEFORE_PAIR_GEMM_MS.get(key)
                    if dtype == torch.float64 else None)),
                record="fused_pair_gemm_1x1" if scalar else None))
            if not sp.tile_identity:
                part = gemm.fused_pair_gemm(*gargs, accum_dtype=acc)
                toffs = device_array(sp, "tile_offsets", device, torch.int32)
                tseg = device_array(sp, "tile_seg", device)
                cases.append(Case(
                    "block_seg_sum",
                    f"level{li}{lvl} {tag} combine {sp.tile_rows} -> "
                    f"{sp.nnzb} ({br},{bc})",
                    lambda part=part, toffs=toffs: seg.block_seg_sum(
                        part, toffs, accum_dtype=acc),
                    lambda part=part, toffs=toffs: block_seg_sum_ref(
                        part, toffs, accum_dtype=acc),
                    nbytes=part.numel() * es + toffs.numel() * 4
                    + sp.nnzb * br * bc * es,
                    flops=part.numel(),
                    library=lambda part=part, tseg=tseg, sp=sp, br=br,
                    bc=bc: torch.zeros((sp.nnzb, br, bc), **f64)
                    .index_add_(0, tseg, part),
                    record="block_seg_sum_1x1" if scalar else None))
        a_data = ptap_numeric_data(cache, a_data, p_data, accum_dtype=acc)
    return cases


def _scalar_csr(ell):
    """cuSPARSE's operand for the yardstick: the ELL operator expanded to
    scalar CSR (the paper's scalar AIJ baseline)."""
    import torch
    r, k = torch.nonzero(ell.mask, as_tuple=True)
    br, bc = ell.br, ell.bc
    a = torch.arange(br, device=r.device)
    b = torch.arange(bc, device=r.device)
    rows = (r[:, None, None] * br + a[None, :, None]).expand(-1, br, bc)
    cols = (ell.indices[r, k].long()[:, None, None] * bc
            + b[None, None, :]).expand(-1, br, bc)
    vals = ell.data[r, k]
    coo = torch.sparse_coo_tensor(
        torch.stack([rows.reshape(-1), cols.reshape(-1)]), vals.reshape(-1),
        (ell.nbr * br, ell.nbc * bc))
    return coo.coalesce().to_sparse_csr()


def check_bitwise(run: dict, device, dtype=None, extra_ells=()) -> dict:
    """Each column of ``block_spmm`` is bitwise ``block_spmv`` of that
    column, on every level operator and prolongator at every panel width;
    a width-1 panel is bitwise the vector apply; each column of the panel
    smoother step is bitwise the vector step; and with ``dinv = I`` and
    ``coef = [0, 1]`` the smoother's ``d'`` is bitwise ``b -
    block_spmv(x)``, vector and each panel column, on every level; at
    payload ``dtype`` (default f64, the run's hierarchy at its policy's).
    The ``block_spmm`` columns and the width-1 apply also on each ``(tag,
    ell)`` of ``extra_ells`` (the stored restrictions, cast to
    ``dtype``)."""
    import torch

    from repro_torch.core.gamg import _at
    from repro_torch.core.spmv import apply_ell
    from repro_torch.kernels.block_spmm import ops as spmm
    from repro_torch.kernels.block_spmv import ops as spmv
    from repro_torch.kernels.fused_smoother import ops as smooth

    gen = torch.Generator(device=device).manual_seed(1)
    dtype = dtype or torch.float64
    f64 = dict(dtype=dtype, device=device)
    checked = dict(spmm_columns=0, apply_width1=0, smoother_columns=0,
                   identity_residuals=0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           device=device).to(dtype)

    def same(got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bitwise equal (max diff "
                                 f"{float((got - want).abs().max()):.3e})")

    def columns(name, ell):
        for k in PANEL_KS + (1,):
            X = randn(ell.nbc, ell.bc, k)
            Y = spmm.block_spmm_ell(ell.indices, ell.data, X)
            for j in range(k):
                same(Y[:, :, j], spmv.block_spmv_ell(
                    ell.indices, ell.data, X[:, :, j].contiguous()),
                    f"block_spmm {name} k={k} column {j}")
                checked["spmm_columns"] += 1
        x = randn(ell.nbc * ell.bc)
        same(apply_ell(ell, x[:, None])[:, 0], apply_ell(ell, x),
             f"width-1 panel apply {name}")
        checked["apply_width1"] += 1

    for tag, ell in extra_ells:
        columns(tag, _at(ell, dtype))
    for li, lv in enumerate(run["solver"].hierarchy.levels):
        for tag, ell in (("A", lv.a_ell), ("P", lv.p_ell)):
            columns(f"{tag}{li}", ell)
        a, bs, k = lv.a_ell, lv.a_ell.br, PANEL_KS[0]
        b, x, d = (randn(a.nbr, bs, k) for _ in range(3))
        coef = torch.tensor([0.3, 0.7], **f64)
        xp, dp = smooth.smoother_step_ell(a.indices, a.data, lv.dinv, b, x,
                                          d, coef)
        for j in range(k):
            xv, dv = smooth.smoother_step_ell(
                a.indices, a.data, lv.dinv,
                *(v[:, :, j].contiguous() for v in (b, x, d)), coef)
            same(xp[:, :, j], xv, f"panel smoother A{li} column {j} x'")
            same(dp[:, :, j], dv, f"panel smoother A{li} column {j} d'")
            checked["smoother_columns"] += 1
        eye = torch.eye(bs, **f64).expand(a.nbr, bs, bs).contiguous()
        step = torch.tensor([0.0, 1.0], **f64)
        _, dp = smooth.smoother_step_ell(a.indices, a.data, eye, b, x, d,
                                         step)
        for j in range(k):
            bj, xj, dj = (v[:, :, j].contiguous() for v in (b, x, d))
            res = bj - spmv.block_spmv_ell(a.indices, a.data, xj)
            same(dp[:, :, j], res, f"identity smoother A{li} column {j} d' "
                 f"against b - A x")
            if j == 0:
                same(smooth.smoother_step_ell(a.indices, a.data, eye, bj, xj,
                                              dj, step)[1], res,
                     f"identity smoother A{li} vector d' against b - A x")
                checked["identity_residuals"] += 1
            checked["identity_residuals"] += 1
    return checked


def check_kernels(cases: list, peaks: tuple, timed: bool = True,
                  label: str = "", tol: float = REL_TOL) -> dict:
    """Hold every case's kernel against its plain version (max error
    within ``tol`` of the largest term); time it.  Each case's line starts
    with ``label`` (the path, where it is not the main one)."""
    import torch

    from repro_torch.kernels.autotune import device_ms
    bw, fp = peaks

    def zero():
        return dict(cases=0, max_abs_err=0.0, max_rel_err=0.0, ms=0.0,
                    ms_single=0.0, plain_ms=0.0, bound_ms=0.0, floor_ms=0.0,
                    library_ms=0.0, library_all=True, bytes=0, flops=0)
    per = {name: zero() for name in KERNELS}
    for c in cases:
        got, want = c.run(), c.plain()
        if isinstance(got, tuple):
            got, want = torch.cat([g.reshape(-1) for g in got]), \
                torch.cat([w.reshape(-1) for w in want])
        sync(got.device)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 0.0
        rel = err / scale if scale else err
        if not rel <= tol:
            raise AssertionError(f"{label}{c.kernel} {c.label}: max rel err "
                                 f"{rel:.3e} > {tol}")
        row = per.setdefault(c.record, zero())
        row["cases"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["max_rel_err"] = max(row["max_rel_err"], rel)
        bound = 1e3 * max(c.nbytes / bw, c.flops / fp)
        row["bound_ms"] += bound
        row["bytes"] += c.nbytes
        row["flops"] += c.flops
        row["floor_ms"] += c.floor_ms or 0.0
        line = dict(kernel=c.kernel, case=c.label, max_abs_err=err,
                    max_rel_err=rel, bound_ms=bound, floor_ms=c.floor_ms,
                    bytes=c.nbytes)
        if c.record != c.kernel:
            line["entry"] = c.record
        if c.lanes is not None:
            line["lanes"] = c.lanes
        line.update(c.extra)
        if timed:
            k_ms, p_ms = device_ms(c.run), device_ms(c.plain)
            l_ms = device_ms(c.library) if c.library is not None else None
            s_ms = time_ms(c.run)
            row["ms"] += k_ms
            row["ms_single"] += s_ms
            row["plain_ms"] += p_ms
            if l_ms is None:
                row["library_all"] = False
            else:
                row["library_ms"] += l_ms
            line.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                        ms_single=s_ms)
        print(f"{label}kernel case " + json.dumps(line))
    return per


def fold_errors(per: dict, other: dict) -> None:
    """The largest errors of another path's kernel checks into ``per``
    (the record's times stay the main path's cases')."""
    for name, row in other.items():
        for key in ("max_abs_err", "max_rel_err"):
            per[name][key] = max(per[name][key], row[key])


def attach_floors(cases: list) -> None:
    """Each case's launch geometry, as the kernel library notes it for the
    one launch a call makes (``autotune.launch_record``), and the empty
    kernel's time at that geometry (``extra["grid"]``, ``floor_ms``)."""
    import torch

    from repro_torch.kernels.autotune import launch_floor_ms, launch_record
    for c in cases:
        torch.cuda.synchronize()
        before = launch_record()[0]
        c.run()
        torch.cuda.synchronize()
        launches, blocks, threads = launch_record()
        if launches - before != 1:
            raise AssertionError(f"{c.kernel} {c.label}: "
                                 f"{launches - before} library launches in "
                                 f"one call")
        c.extra["grid"] = [blocks, threads]
        c.floor_ms = launch_floor_ms(blocks, threads)


def lanes_sweep(cases: list) -> None:
    """``block_spmv``, ``block_spmm`` and ``fused_smoother`` at every lanes
    value a C entry takes, at the paths' shapes and 256 threads: each held
    against the plain version, timed with CUDA events beside the map's
    choice (the map is no knob; this shows what it leaves on the table)."""
    from repro_torch.kernels.autotune import device_ms
    for c in cases:
        if c.at_lanes is None:
            continue
        want = c.plain()
        ms = {}
        for n in LANES:
            rel = _rel(c.at_lanes(n), want)
            if not rel <= REL_TOL:
                raise AssertionError(f"{c.kernel} {c.label} lanes={n}: max "
                                     f"rel err {rel:.3e} > {REL_TOL}")
            ms[n] = device_ms(lambda n=n: c.at_lanes(n))
        best = min(ms, key=ms.get)
        print("lanes sweep " + json.dumps(dict(
            kernel=c.kernel, case=c.label, map=c.lanes, ms_by_lanes=ms,
            best=best, map_over_best=ms[c.lanes] / ms[best])))


def copy_bandwidth() -> float:
    """Measured bytes/s of a large device-to-device ``copy_``."""
    import torch
    src = torch.empty(2 ** 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    return 2 * src.numel() * 4 / (ms * 1e-3)


# ---------------------------------------------------------------------------
# The tune path: the autotuner's threads knob
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tune_mode(mode: str):
    """``REPRO_TORCH_TUNE`` set to ``mode`` inside the block."""
    old = os.environ.get("REPRO_TORCH_TUNE")
    os.environ["REPRO_TORCH_TUNE"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_TORCH_TUNE"]
        else:
            os.environ["REPRO_TORCH_TUNE"] = old


class SignatureLog:
    """Inside the block, every ``(family, signature)`` the tuned wrappers
    resolve, with the value it resolved to (``autotune.resolve_param`` is
    wrapped and restored on exit)."""

    def __init__(self):
        from repro_torch.kernels import autotune
        self.autotune = autotune
        self.seen = {}

    def __enter__(self):
        at = self.autotune
        self._orig = orig = at.resolve_param

        def logged(family, signature, name, requested, default,
                   device="cuda"):
            value = orig(family, signature, name, requested, default,
                         device=device)
            self.seen[at.entry_key(family, signature)] = (
                family, dict(signature), value)
            return value
        at.resolve_param = logged
        return self

    def __exit__(self, *exc):
        self.autotune.resolve_param = self._orig


def tune_path(run: dict, sigs: dict, device, verbose: bool = True):
    """Sweep every logged ``(family, signature)`` and ``pbjacobi`` at each
    level's ``dinv`` shape on ``device`` into the cache, check that every
    winner reads back, then the CLI's ``smoke`` round trip.  Returns the
    path's kernel launches and the winners by entry key."""
    import torch

    from repro_torch.kernels import autotune
    from repro_torch.kernels.autotune.__main__ import main as tune_cli

    todo = {k: (fam, sig) for k, (fam, sig, _) in sigs.items()}
    for lv in run["solver"].hierarchy.levels:
        nbr, bs = lv.dinv.shape[0], lv.dinv.shape[1]
        sig = autotune.signature(lv.dinv.dtype, nbr * bs, bs=bs)
        todo[autotune.entry_key("pbjacobi", sig)] = ("pbjacobi", sig)
    counts = PathCounts()
    reset_counts()
    winners = {}
    for key, (family, sig) in sorted(todo.items()):
        t0 = time.perf_counter()
        won, _ = counts.run(lambda: autotune.sweep(family, sig,
                                                   device=device))
        winners[key] = won["params"]["threads"]
        if verbose:
            print("tune sweep " + json.dumps(dict(
                family=family, signature=sig, table_us=won["table"],
                winner=won["params"], best_us=won["best_us"],
                sweep_s=time.perf_counter() - t0)))
    autotune.clear_memo()
    for key, (family, sig) in todo.items():
        got = autotune.lookup(family, sig, "threads", device)
        if got != winners[key]:
            raise AssertionError(f"cache round trip {key}: recorded "
                                 f"{winners[key]}, read {got}")
    with tune_mode("cache"):
        rc, _ = counts.run(lambda: tune_cli(
            ["smoke", "--device", torch.device(device).type]))
    if rc != 0:
        raise AssertionError(f"autotune CLI smoke exited {rc}")
    if verbose:
        print("tune path " + json.dumps(dict(
            signatures=len(todo), cache=str(autotune.cache_path()),
            launches=counts.total)))
    return counts.total, winners


def check_threads_bitwise(cases: list) -> dict:
    """Every ``threads`` candidate of each tuned kernel, at the paths'
    shapes, bitwise equal to the 256-thread launch: no kernel shares data
    across threads, so the block size changes nothing but speed."""
    import torch
    from repro_torch.kernels import autotune
    checked = {name: 0 for name in TUNED}
    for c in cases:
        if c.kernel not in TUNED:
            continue
        want = c.run(threads=autotune.DEFAULT_THREADS)
        for t in autotune.CANDIDATES[c.kernel]["threads"]:
            got = c.run(threads=t)
            pairs = zip(got, want) if isinstance(got, tuple) else \
                [(got, want)]
            for g, w in pairs:
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"{c.kernel} {c.label}: threads={t} differs from "
                        f"the 256-thread launch")
            checked[c.kernel] += 1
    for name, n in checked.items():
        if n == 0:
            raise AssertionError(f"{name}: no threads candidate checked")
    return checked


def tuned_vs_static_kernels(cases: list, verbose: bool = True) -> list:
    """Each tuned case at the cached winner against the static 256-thread
    launch, device times with CUDA events in turns (static, tuned, tuned,
    static; each number the mean of its two medians).  ``beyond_margin``
    marks a winner slower than 256 by more than the sweep's
    ``EVENT_MARGIN`` (the sweep ran on synthetic operands, these on the
    paths' own)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.autotune import device_ms
    rows = []
    for c in cases:
        if c.kernel not in TUNED:
            continue
        with tune_mode("cache"), SignatureLog() as log:
            c.run()
        (_, sig, won), = log.seen.values()
        static = lambda c=c: c.run(threads=autotune.DEFAULT_THREADS)
        tuned = lambda c=c, won=won: c.run(threads=won)
        s1, t1, t2, s2 = (device_ms(static), device_ms(tuned),
                          device_ms(tuned), device_ms(static))
        row = dict(kernel=c.kernel, case=c.label, items=sig["items"],
                   threads=won, static_ms=(s1 + s2) / 2,
                   tuned_ms=(t1 + t2) / 2, static_pair=[s1, s2],
                   tuned_pair=[t1, t2],
                   beyond_margin=t1 + t2 > (s1 + s2) * (
                       1 + autotune.EVENT_MARGIN))
        if c.extra.get("before_ms") is not None:
            row["before_ms"] = c.extra["before_ms"]
        rows.append(row)
        if verbose:
            print("tune kernel " + json.dumps(row))
    return rows


def pbjacobi_phase(cases: list, peaks: tuple) -> dict:
    """The pbjacobi cases (each level's dinv): every ``threads`` candidate
    bitwise the 256-thread launch, whose SHA-256 must equal
    ``EXPECT_PBJ_SHA``; static and tuned device ms beside the byte bound
    and the empty kernel's time at the kernel's grid and at the first
    kernel's (one thread per element, 256 a CTA)."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels.autotune import device_ms, launch_floor_ms
    shas, rows, floors = {}, [], []
    for c in (c for c in cases if c.kernel == "pbjacobi"):
        level = c.label.split()[0]
        want = c.run(threads=autotune.DEFAULT_THREADS)
        for t in autotune.CANDIDATES["pbjacobi"]["threads"]:
            if not torch.equal(c.run(threads=t), want):
                raise AssertionError(f"pbjacobi {c.label}: threads={t} "
                                     f"differs from 256")
        shas[level] = _sha(want)
        nbr, bs = c.extra["nbr"], c.extra["bs"]
        first = -(-nbr * bs // autotune.DEFAULT_THREADS)
        floors.append(dict(case=level, grid=c.extra["grid"],
                           floor_ms=c.floor_ms,
                           first_grid=[first, autotune.DEFAULT_THREADS],
                           first_floor_ms=launch_floor_ms(
                               first, autotune.DEFAULT_THREADS)))
        static = device_ms(lambda c=c: c.run(threads=autotune
                                             .DEFAULT_THREADS))
        with tune_mode("cache"):
            tuned = device_ms(c.run)
        rows.append(dict(case=c.label, static_ms=static, tuned_ms=tuned,
                         bound_ms=1e3 * c.nbytes / peaks[0],
                         floor_ms=c.floor_ms, bytes=c.nbytes))
    print("launch floor " + json.dumps(floors))
    out = dict(cases=rows, sha256_16=shas,
               checked=EXPECT_PBJ_SHA is not None,
               sum_static_ms=sum(r["static_ms"] for r in rows),
               sum_tuned_ms=sum(r["tuned_ms"] for r in rows),
               sum_floor_ms=sum(r["floor_ms"] for r in rows),
               sum_bound_ms=sum(r["bound_ms"] for r in rows))
    print("pbjacobi cases " + json.dumps(out))
    if EXPECT_PBJ_SHA is not None and shas != EXPECT_PBJ_SHA:
        raise AssertionError(f"pbjacobi outputs not bitwise the first "
                             f"kernel's: {shas} against {EXPECT_PBJ_SHA}")
    return out


def tuned_vs_static_steps(run: dict, device, expect_iters: int,
                          verbose: bool = True) -> dict:
    """One hot step (reassembly, ``update_operator``, solve) and one
    k=16 panel solve with the static launch and with the cached winners,
    in turns: static, tuned, tuned, static.  Iterations must be equal
    (``expect_iters`` on the hot step) and the solutions bitwise equal."""
    import numpy as np
    import torch
    prob, solver = run["prob"], run["solver"]
    B = torch.as_tensor(np.random.default_rng(TUNE_K).standard_normal(
        (prob.n, TUNE_K)), device=device)
    out = []
    for mode in ("off", "cache", "cache", "off"):
        with tune_mode(mode):
            sync(device)
            t0 = time.perf_counter()
            a_new = prob.reassemble(1.1)
            solver.update_operator(a_new.data)
            res = solver.solve(prob.b)
            sync(device)
            step_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            panel = solver.solve_many(B)
            sync(device)
            panel_ms = 1e3 * (time.perf_counter() - t0)
        out.append(dict(mode=mode, step_ms=step_ms, iters=res.iters,
                        x=res.x, panel_ms=panel_ms,
                        panel_iters=panel.iters.tolist(), X=panel.x))
    run["a_data"] = a_new.data
    base = out[0]
    for o in out:
        if o["iters"] != expect_iters or o["iters"] != base["iters"]:
            raise AssertionError(f"hot step ({o['mode']}): {o['iters']} "
                                 f"iterations, static {base['iters']}")
        if o["panel_iters"] != base["panel_iters"]:
            raise AssertionError(f"k={TUNE_K} panel ({o['mode']}): "
                                 f"iterations {o['panel_iters']}, static "
                                 f"{base['panel_iters']}")
        for key in ("x", "X"):
            if not torch.equal(o[key], base[key]):
                raise AssertionError(
                    f"{key} ({o['mode']}) not bitwise the static run's "
                    f"(rel {_rel(o[key], base[key]):.3e})")
    summary = dict(order=[o["mode"] for o in out],
                   step_ms=[o["step_ms"] for o in out],
                   panel_ms=[o["panel_ms"] for o in out],
                   iters=base["iters"], panel_iters=base["panel_iters"],
                   solutions="bitwise equal")
    if verbose:
        print("tune steps " + json.dumps(summary))
    return summary


def resolve_cost_us(run: dict, calls: int = 20000) -> dict:
    """Host microseconds per ``resolve_param`` of one level-0 launch
    signature, in each mode (the port resolves at every launch)."""
    from repro_torch.kernels import autotune
    a = run["solver"].hierarchy.levels[0].a_ell
    sig = autotune.signature(a.data.dtype, a.nbr, br=a.br, bc=a.bc,
                             kmax=a.kmax)
    cost = {}
    for mode in ("off", "cache"):
        with tune_mode(mode):
            t0 = time.perf_counter()
            for _ in range(calls):
                autotune.resolve_param("block_spmv", sig, "threads", None,
                                       autotune.DEFAULT_THREADS,
                                       device=a.data.device)
            cost[mode] = 1e6 * (time.perf_counter() - t0) / calls
    return cost


# ---------------------------------------------------------------------------
# The port on the CPU against the port on the card
# ---------------------------------------------------------------------------

def cpu_vs_cuda(m: int, coarse_size: int) -> dict:
    import numpy as np
    import torch
    cpu = main_path(m, "cpu", coarse_size=coarse_size, verbose=False)
    gpu = main_path(m, "cuda", coarse_size=coarse_size, verbose=False)
    s_cpu, s_gpu = cpu["solver"].setup_data, gpu["solver"].setup_data
    if s_cpu.stats["level_rows"] != s_gpu.stats["level_rows"]:
        raise AssertionError(f"levels differ: {s_cpu.stats['level_rows']} vs"
                             f" {s_gpu.stats['level_rows']}")
    for li, (a, b) in enumerate(zip(s_cpu.levels, s_gpu.levels)):
        if not np.array_equal(a.aggr.node_to_agg, b.aggr.node_to_agg):
            raise AssertionError(f"level {li}: aggregates differ")
    out = dict(level_rows=s_cpu.stats["level_rows"],
               level_bs=s_cpu.stats["level_bs"], iters=[], rel_diff=[])
    for rc, rg in zip(cpu["records"], gpu["records"]):
        if rc["iters"] != rg["iters"]:
            raise AssertionError(f"step {rc['step']}: {rc['iters']} CG "
                                 f"iterations on CPU, {rg['iters']} on CUDA")
        xc, xg = rc["x"], rg["x"].cpu()
        rel = float(torch.linalg.vector_norm(xc - xg)
                    / torch.linalg.vector_norm(xc))
        if not rel <= SOLUTION_TOL:
            raise AssertionError(f"step {rc['step']}: solutions differ by "
                                 f"{rel:.3e}")
        out["iters"].append(rc["iters"])
        out["rel_diff"].append(rel)
    # one k=4 panel solve on each side
    B = np.random.default_rng(4).standard_normal((cpu["prob"].n, 4))
    pc = cpu["solver"].solve_many(torch.as_tensor(B))
    pg = gpu["solver"].solve_many(torch.as_tensor(B, device="cuda"))
    if not torch.equal(pc.iters, pg.iters.cpu()):
        raise AssertionError(f"k=4 panel: iterations {pc.iters.tolist()} on "
                             f"CPU, {pg.iters.tolist()} on CUDA")
    rel = _rel(pg.x, pc.x)
    if not rel <= SOLUTION_TOL:
        raise AssertionError(f"k=4 panel: solutions differ by {rel:.3e}")
    out.update(panel_iters=pc.iters.tolist(), panel_rel_diff=rel)
    return out


def hetero_cpu_vs_cuda(devices=("cpu", "cuda")) -> dict:
    """``examples/heterogeneous.py`` at m=7 (device assembly, MIS,
    coarse_size 40) on the CPU and on the card: the reference's levels
    and iterations on both, equal aggregates, solutions within 1e-9."""
    import numpy as np
    import torch

    from repro_torch.core.gamg import GAMGSolver
    from repro_torch.fem.assemble import assemble_elasticity, \
        inclusion_fields
    runs = []
    for d in devices:
        prob = assemble_elasticity(HETERO_M, device=d)
        solver = GAMGSolver(prob.A, prob.B, coarse_size=HETERO_COARSE,
                            rtol=1e-8, maxiter=100)
        solver.bind_assembler(prob.assembler)
        iters, xs = [], []
        for contrast in CONTRASTS:
            solver.update_coefficients(*inclusion_fields(
                prob.mesh, E_inclusion=contrast))
            res = solver.solve(prob.b)
            iters.append(res.iters)
            xs.append(res.x.cpu())
        sd = solver.setup_data
        runs.append((sd, iters, xs))
        if sd.stats["level_rows"] != EXPECT_HETERO_ROWS or \
                iters != EXPECT_HETERO_ITERS:
            raise AssertionError(
                f"heterogeneous m={HETERO_M} on {d}: levels "
                f"{sd.stats['level_rows']}, iterations {iters}; expected "
                f"{EXPECT_HETERO_ROWS}, {EXPECT_HETERO_ITERS}")
    (s_cpu, iters, x_cpu), (s_gpu, _, x_gpu) = runs
    for li, (a, b) in enumerate(zip(s_cpu.levels, s_gpu.levels)):
        if not np.array_equal(a.aggr.node_to_agg, b.aggr.node_to_agg):
            raise AssertionError(f"heterogeneous level {li}: aggregates "
                                 f"differ")
    rel = [float(torch.linalg.vector_norm(c - g) / torch.linalg.vector_norm(c))
           for c, g in zip(x_cpu, x_gpu)]
    if not max(rel) <= SOLUTION_TOL:
        raise AssertionError(f"heterogeneous: solutions differ by {rel}")
    return dict(level_rows=s_cpu.stats["level_rows"], iters=iters,
                rel_diff=rel)


def aggregates_vs_cpu(run: dict) -> dict:
    """The card's m=32 setup against the port's on the CPU: levels, nnzb
    and ``n_agg`` equal; where a level's aggregates differ, every
    difference traced back to greedy pass-2 ties within ``TIE_ULPS``,
    judged by the CPU's weights (``trace_tie_flips``)."""
    import numpy as np

    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.core import gamg
    from repro_torch.core.aggregation import trace_tie_flips
    from repro_torch.core.strength import strength_graph
    from repro_torch.fem.assemble import assemble_elasticity

    cfg = ElasticityConfig(m=MAIN_M)
    t0 = time.perf_counter()
    prob = assemble_elasticity(cfg.m, order=cfg.order, E=cfg.E, nu=cfg.nu,
                               path="host", device="cpu")
    cpu = gamg.setup(prob.A, prob.B, theta=cfg.theta,
                     coarse_size=cfg.coarse_size, coarsener="greedy")
    setup_s = time.perf_counter() - t0
    card = run["solver"].setup_data
    for key in ("level_rows", "level_nnzb", "level_bs"):
        if cpu.stats[key] != card.stats[key]:
            raise AssertionError(f"m={MAIN_M} {key}: CPU {cpu.stats[key]}, "
                                 f"card {card.stats[key]}")
    tol = TIE_ULPS * float(np.finfo(np.float64).eps)
    levels = []
    for li, (a, b) in enumerate(zip(cpu.levels, card.levels)):
        if a.aggr.n_agg != b.aggr.n_agg:
            raise AssertionError(f"m={MAIN_M} level {li}: n_agg "
                                 f"{a.aggr.n_agg} on CPU, {b.aggr.n_agg} "
                                 f"on the card")
        if np.array_equal(a.aggr.node_to_agg, b.aggr.node_to_agg):
            levels.append(dict(level=li, differing_nodes=0))
            continue
        out = trace_tie_flips(strength_graph(a.A0, cpu.theta),
                              strength_graph(b.A0, card.theta),
                              -(-cpu.nns_dim // a.A0.br), tol)
        levels.append(dict(level=li, **out))
        if not (out["same_edges"] and out["traced"]):
            raise AssertionError(f"m={MAIN_M} level {li}: aggregates differ "
                                 f"beyond pass-2 ties within {TIE_ULPS} "
                                 f"ulps: {out}")
    return dict(cpu_setup_s=setup_s, tie_rtol=tol, levels=levels,
                differing_nodes=sum(lv["differing_nodes"] for lv in levels),
                max_tie_gap=max(lv.get("max_tie_gap", 0.0)
                                for lv in levels))


# ---------------------------------------------------------------------------
# Observability and the time march
# ---------------------------------------------------------------------------

def expected_spans(n_smoothed: int) -> set:
    """The span names of a vector hot step (reassembly, recompute, solve)
    on a hierarchy of ``n_smoothed`` smoothed levels."""
    names = {"vcycle/coarse", "recompute/coarse_chol"} | set(KERNEL_SPANS)
    for li in range(n_smoothed):
        names |= {f"vcycle/level{li}/{s}"
                  for s in ("smooth", "restrict", "prolong")}
        names |= {f"recompute/level{li}/{s}"
                  for s in ("smoother_data", "ptap")}
    return names


def _profiled(fn) -> tuple:
    """``fn()`` under ``torch.profiler``, after a dropped warm-up step and
    a host pause on each side of the recorded window (as
    ``_profile_step``): its result, the device kernel events and the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) \
            as prof:
        warm = torch.zeros(WARMUP_KERNELS, device="cuda")
        for i in range(WARMUP_KERNELS):
            warm[i:].add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(WINDOW_PAUSE_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAUSE_S)
        prof.step()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")]
    return out, kernels, prof


def _device_ms_by_range(prof, names) -> dict:
    """Device ms of the kernels launched inside each ``record_function``
    range named in ``names`` (every instance summed), by the launch's
    runtime call (joined on the correlation id) falling in the range's
    host span: the library's kernels are launched from C, outside any
    aten op, so the profiler's op tree does not hold them."""
    import bisect
    events = _trace(prof)
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            spans.setdefault(e["name"], []).append((e["ts"],
                                                    e["ts"] + e["dur"]))
    for v in spans.values():
        v.sort()
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    out = {name: 0.0 for name in spans}
    for k in events:
        if k.get("cat") != "kernel":
            continue
        ts = launched.get(k.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for name, iv in spans.items():
            i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                out[name] += k["dur"] / 1e3
    return out


def _expect_tally(tally, cycles: int, n_smoothed: int, label: str) -> None:
    """The reference's analytic counts (``tests/test_obs.py``): one
    operator apply, one V-cycle and one coarse solve a cycle, a visit and
    two smoother applications a smoothed level a cycle."""
    got = dict(precond=int(tally.precond_applies),
               op=int(tally.operator_applies),
               coarse=int(tally.coarse_solves),
               level_visits=tally.level_visits.tolist(),
               smoother=tally.smoother_applies.tolist())
    want = dict(precond=cycles, op=cycles, coarse=cycles,
                level_visits=[cycles] * n_smoothed,
                smoother=[2 * cycles] * n_smoothed)
    if got != want:
        raise AssertionError(f"obs counters {label}: tally {got}, the "
                             f"analytic counts are {want}")


def obs_phase(run: dict, hot: dict) -> dict:
    """The observability layer on the main path's m=32 setup.

    spans: one hot step (reassembly, recompute, solve) profiled through
    closures built under ``use("spans")``: every expected span name in
    the trace, the device ms under each, and the solution's SHA-256 equal
    to the same step's under ``"off"``.  counters: a
    ``make_solve(obs="counters")`` vector solve and a
    ``make_block_solve(obs="counters")`` solve at k=4, bitwise the off
    solves, their tallies equal to the analytic counts, the extra device
    kernels a cycle costs (profiled off and counted solves), and the
    modeled MB beside the counted solve's device time.  off: the static
    profiled hot step's device events beside PR 21's."""
    import numpy as np
    import torch

    from repro_torch.core import gamg
    from repro_torch.multirhs.block_krylov import make_block_solve
    from repro_torch.obs import trace

    prob, solver = run["prob"], run["solver"]
    sd = solver.setup_data
    nl = len(sd.levels)
    kw = dict(rtol=solver.rtol, maxiter=solver.maxiter)
    a = prob.reassemble(1.3).data              # the profiled step's values
    with trace.use("off"):
        off_rec, off_solve = gamg.make_recompute(sd), gamg.make_solve(sd,
                                                                      **kw)
        hier = off_rec(a)
        off = off_solve(hier, prob.b)
    with trace.use("spans"):
        rec, solve = gamg.make_recompute(sd), gamg.make_solve(sd, **kw)
        solve(rec(a), prob.b)                  # the closures bind "spans"

        def step():
            return solve(rec(prob.reassemble(1.3).data), prob.b)

        res, kernels, prof = _profiled(step)
    want = expected_spans(nl)
    by_span = _device_ms_by_range(prof, want)
    missing = sorted(want - set(by_span))
    same = _sha(res.x) == _sha(off.x) and res.iters == off.iters
    print("obs spans " + json.dumps(dict(
        expected=len(want), found=len(by_span), missing=missing,
        iters=res.iters, sha=_sha(res.x), off_sha=_sha(off.x),
        bitwise_off=same, device_events=len(kernels),
        device_busy_ms=sum(e.device_time for e in kernels) / 1e3,
        device_ms_by_span=dict(sorted(by_span.items())))))
    if missing or not same:
        raise AssertionError(f"obs spans: missing {missing}, solution "
                             f"bitwise the off solve's: {same}")

    counted = gamg.make_solve(sd, obs="counters", **kw)
    res_c = counted(hier, prob.b)
    cycles = off.iters + 1
    _expect_tally(res_c.counters, cycles, nl, "vector")
    if not (torch.equal(res_c.x, off.x) and res_c.iters == off.iters):
        raise AssertionError("obs counters: the counted solve is not "
                             "bitwise the off solve")
    B = torch.as_tensor(np.random.default_rng(22).standard_normal(
        (prob.n, OBS_K)), device="cuda")
    B[:, 0] = prob.b
    off_p = make_block_solve(sd, obs="off", **kw)(hier, B)
    cnt_p = make_block_solve(sd, obs="counters", **kw)(hier, B)
    _expect_tally(cnt_p.counters, int(off_p.iters.max()) + 1, nl, "panel")
    if not (torch.equal(cnt_p.x, off_p.x)
            and torch.equal(cnt_p.iters, off_p.iters)):
        raise AssertionError("obs counters: the counted k=4 panel is not "
                             "bitwise the off panel")
    _, k_off, _ = _profiled(lambda: off_solve(hier, prob.b))
    res_p, k_cnt, _ = _profiled(lambda: counted(hier, prob.b))
    busy_ms = sum(e.device_time for e in k_cnt) / 1e3
    modeled = float(res_p.counters.modeled_bytes)
    out = dict(
        vector=trace.describe_tally(res_c.counters),
        panel=trace.describe_tally(cnt_p.counters), iters=off.iters,
        panel_iters=off_p.iters.tolist(), bitwise_off=True,
        off_solve_device_events=len(k_off),
        counted_solve_device_events=len(k_cnt),
        extra_kernels_per_iteration=(len(k_cnt) - len(k_off)) / cycles,
        modeled_MB=modeled / 1e6, counted_solve_device_ms=busy_ms,
        off_solve_device_ms=sum(e.device_time for e in k_off) / 1e3,
        modeled_GB_per_s=modeled / (busy_ms * 1e-3) / 1e9)
    print("obs counters " + json.dumps(out))
    print("obs off " + json.dumps(dict(
        hot_step_device_events=hot["device_events"],
        pr21_device_events=PR21_HOT_EVENTS,
        equal=hot["device_events"] == PR21_HOT_EVENTS,
        library_events=hot["library_events"])))
    return out


def _march_cfg(n_steps: int, rtol: float = 1e-8):
    from repro_torch.sim import MarchConfig, StalenessConfig
    return MarchConfig(n_steps=n_steps, seg_len=8, rtol=rtol, maxiter=400,
                       staleness=StalenessConfig(*MARCH_STALENESS))


def _segments(res) -> list:
    return [f"{s.steps}@setup{s.setup_id}({s.reason})" for s in res.segments]


def march_phase(device="cuda") -> tuple:
    """The time march at m=32: ``SofteningScenario`` (rate
    ``MARCH_RATE``) on the device-assembled problem, the paper's greedy
    setting, ``MARCH_STEPS`` steps under ``frozen``, ``adaptive`` and
    ``resetup`` in turns.  Each mode must end ``ok`` with every step
    healthy, and the adaptive march must rebuild at least once and set up
    fewer times than ``resetup``.  Then one setup at the adaptive march's
    final fields (timed) and every kernel against its plain version on
    that hierarchy (``march kernel case`` lines).  Returns the path's
    launches and the kernel checks."""
    import types

    import torch

    from repro_torch.core import gamg
    from repro_torch.fem.assemble import assemble_elasticity
    from repro_torch.robust.health import HEALTHY
    from repro_torch.sim import SofteningScenario, march
    from repro_torch.sim.driver import _setup_from_fields

    counts = PathCounts()
    prob, _ = counts.run(lambda: assemble_elasticity(MAIN_M, path="device",
                                                     device=device))
    scen = SofteningScenario.build(prob, rate=MARCH_RATE)
    cfg = _march_cfg(MARCH_STEPS)
    runs = {}
    for mode in ("frozen", "adaptive", "resetup"):
        sync(device)
        t0 = time.perf_counter()
        res, _ = counts.run(lambda: march(prob, scen, cfg, mode=mode,
                                          setup_opts=MARCH_SETUP))
        sync(device)
        wall = time.perf_counter() - t0
        runs[mode] = res
        print("march " + json.dumps(dict(
            mode=mode, m=MAIN_M, status=res.status, setups=res.n_setups,
            segments=_segments(res), iters=res.iters.tolist(),
            total_iters=res.total_iters, wall_s=wall,
            ms_per_step=1e3 * wall / max(res.steps_done, 1),
            max_relres=float(res.relres.max()),
            coeff_drift=res.coeff_drift.tolist())))
        if res.status != "ok" or res.steps_done != MARCH_STEPS or not (
                res.step_status == HEALTHY).all():
            raise AssertionError(f"march {mode}: status {res.status}, "
                                 f"{res.steps_done} steps, statuses "
                                 f"{res.step_status.tolist()}")
    frozen, adaptive, resetup = (runs[k] for k in ("frozen", "adaptive",
                                                   "resetup"))
    if not 2 <= adaptive.n_setups < resetup.n_setups:
        raise AssertionError(f"march: adaptive set up {adaptive.n_setups} "
                             f"times, resetup {resetup.n_setups}")
    rel = float(torch.linalg.vector_norm(adaptive.x - resetup.x)
                / torch.linalg.vector_norm(resetup.x))
    sync(device)
    t0 = time.perf_counter()
    sd = _setup_from_fields(prob, adaptive.E, adaptive.nu, MARCH_SETUP)
    sync(device)
    setup_s = time.perf_counter() - t0
    hier = gamg.recompute(sd, prob.assembler.coo_data(adaptive.E,
                                                      adaptive.nu))
    step_ms = march_step_ms(prob, scen, sd)
    print("march compare " + json.dumps(dict(
        rate=MARCH_RATE, n_steps=MARCH_STEPS, staleness=MARCH_STALENESS,
        setup_opts=MARCH_SETUP,
        setups={k: r.n_setups for k, r in runs.items()},
        adaptive_vs_resetup_rel=rel,
        total_iters={k: r.total_iters for k, r in runs.items()},
        setup_s_at_final_fields=setup_s, frozen_step_ms=step_ms,
        level_rows=sd.stats["level_rows"], launches=counts.total)))
    solver = types.SimpleNamespace(setup_data=sd, hierarchy=hier)
    per = check_kernels(build_cases(dict(prob=prob, solver=solver), device),
                        PEAKS, timed=False, label="march ")
    return counts.total, per


def march_step_ms(prob, scen, sd, steps: int = 4) -> list:
    """Host ms of each step of a frozen segment on ``sd`` (after one
    warm step; a ``torch.cuda.synchronize()`` closes each): a march step
    apart from its setups."""
    from repro_torch.sim import init_carry, make_segment
    from repro_torch.sim.driver import MarchConfig, StalenessConfig
    cfg = MarchConfig(n_steps=steps + 1, seg_len=1, rtol=1e-8,
                      maxiter=400, staleness=StalenessConfig(
                          iter_drift=10**6, ref_window=1,
                          coeff_rtol=10**6))
    seg = make_segment(sd, prob.assembler, scen, cfg)
    carry = init_carry(scen, prob.b)
    out = []
    for i in range(steps + 1):
        sync(prob.b.device)
        t0 = time.perf_counter()
        _, carry, _, _ = seg(prob.b, carry, cfg.n_steps)
        sync(prob.b.device)
        if i:
            out.append(1e3 * (time.perf_counter() - t0))
    return out


def march_cpu_vs_cuda(devices=("cpu", "cuda")) -> dict:
    """``python -m repro_torch.march``'s setting (the reference's
    acceptance battery, ``tests/test_march.py``) at m=5 on the CPU and on
    the card, rtol 1e-10: per mode equal iterations per step, statuses,
    segments and setups, and final states within ``MARCH_TOL``."""
    from repro_torch.fem.assemble import assemble_elasticity
    from repro_torch.sim import SofteningScenario, march

    cfg = _march_cfg(MARCH_CHECK_STEPS, rtol=1e-10)
    runs = {}
    for dev in devices:
        prob = assemble_elasticity(MARCH_CHECK_M, device=dev)
        scen = SofteningScenario.build(prob, rate=MARCH_RATE)
        runs[dev] = {mode: march(prob, scen, cfg, mode=mode,
                                 setup_opts={"coarse_size": 8})
                     for mode in ("frozen", "adaptive", "resetup")}
    cpu, gpu = (runs[d] for d in devices)
    out = {}
    for mode, rc in cpu.items():
        rg = gpu[mode]
        same = (rc.iters.tolist() == rg.iters.tolist()
                and rc.step_status.tolist() == rg.step_status.tolist()
                and _segments(rc) == _segments(rg)
                and rc.n_setups == rg.n_setups and rc.status == rg.status
                == "ok")
        rel = _rel(rg.x, rc.x)
        out[mode] = dict(iters=rc.iters.tolist(), setups=rc.n_setups,
                         segments=_segments(rc), equal=same, x_rel=rel)
        if not same or not rel <= MARCH_TOL:
            raise AssertionError(
                f"march {mode} m={MARCH_CHECK_M}: CPU {rc.iters.tolist()} "
                f"{_segments(rc)}, card {rg.iters.tolist()} "
                f"{_segments(rg)}; x differs by {rel:.3e}")
    out["adaptive_vs_resetup_rel"] = _rel(cpu["adaptive"].x,
                                          cpu["resetup"].x)
    return out


# ---------------------------------------------------------------------------

class Children:
    """Every command of ``cmds`` started at once, each in a session of its
    own (``PYTHONPATH`` the checkout's ``src``); leaving the block kills
    every session still running."""

    def __init__(self, cmds: dict):
        self.cmds = cmds
        self.t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(SRC))
        self.procs = {k: subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True, cwd=ROOT, env=env)
            for k, cmd in cmds.items()}

    def wait(self, timeout: float) -> tuple:
        """Each child's ``CompletedProcess`` and the seconds from the start
        to its end, by label."""
        done, secs = {}, {}
        for k, proc in self.procs.items():
            left = max(1.0, timeout - (time.perf_counter() - self.t0))
            out, err = proc.communicate(timeout=left)
            done[k] = subprocess.CompletedProcess(self.cmds[k],
                                                  proc.returncode, out, err)
            secs[k] = time.perf_counter() - self.t0
        return done, secs

    def __enter__(self) -> "Children":
        return self

    def __exit__(self, *exc) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.communicate()


#: the dist path: the selftest's runs at the main path's m (world size,
#: backend and sections), each child's time limit in seconds, and its
#: solution's tolerance against the single-device card solve
DIST_RUNS = {
    "nccl world 1": ["--world", "1", "--backend", "nccl", "--coeff",
                     "--march"],
    "gloo world 4": ["--world", "4", "--backend", "gloo", "--k", "4",
                     "--mrhs", "--agg", "--overlap", "--fault", "--coeff",
                     "--march"],
}
DIST_TIMEOUT_S = 420
DIST_TOL = 1e-10
#: the families the coefficient program must launch in its own calls
DIST_COEFF_KERNELS = ("block_seg_sum", "block_spmv", "block_pair_gemm")
#: the families the dist path must launch (the tail's fused kernels run
#: only in the agglomerated section)
DIST_KERNELS = ("block_spmv", "block_spmm", "block_pair_gemm",
                "block_seg_sum", "fused_smoother", "fused_pair_gemm")


#: the front doors phase: the AMG twins' card runs at the MIS setting's
#: largest held m and their CPU-vs-card check at m=7; the message counts
#: of ``python -m repro.dist.measure 5 2 pc`` (pc = 1, 2) with level 0's
#: modeled halo bytes at each pc and level 1's gather bytes; the
#: distributed twin's runs (``python -m repro_torch.amg_distributed``
#: argv); and the families each child must launch
DOOR_FLAG = "--front-door"      # a twin's card child, its launches counted
DOORS = ("serve_amg", "observe_amg", "heterogeneous")
DOORS_M, DOORS_CHECK_M = MIS_M, 7
DOORS_TIMEOUT_S = 420
EXPECT_MEASURE = dict(cycle={"ppermute": 14, "all_gather": 1, "msgs": 15},
                      recompute={"ppermute": 6, "all_gather": 1, "msgs": 7},
                      model_msgs=15, halo_bytes={1: 15072, 2: 7536},
                      gather_bytes=336)
DISTRIBUTED_RUNS = {"gloo world 8 (default)": [], "nccl world 1": ["1"]}
STAGE_KERNELS = ("block_spmv", "block_pair_gemm", "block_seg_sum")
DOOR_KERNELS = {"serve_amg": MAIN_KERNELS + ("block_spmm",),
                "observe_amg": MAIN_KERNELS + ("block_spmm",),
                "heterogeneous": MAIN_KERNELS,
                "dist.measure": STAGE_KERNELS,
                "amg_distributed": STAGE_KERNELS}


def _check_dist(label: str, res: dict) -> dict:
    """Hold one selftest run's result to the dist path's expectations;
    returns the line's summary."""
    world = res["world"]
    want = dict(levels=EXPECT_LEVEL_ROWS, iters=EXPECT_ITERS,
                iters_single=EXPECT_ITERS, status=["healthy"] * world,
                repeat_bitwise=True, span=[1] + [0] * (world - 1))
    bad = {k: res.get(k) for k, v in want.items() if res.get(k) != v}
    if res["rel_single"] > DIST_TOL or not res["cycle"]["agree"]:
        bad.update(rel_single=res["rel_single"], cycle=res["cycle"])
    out = dict(m=res["m"], world=world, backend=res["backend"],
               iters=res["iters"], iters_single=res["iters_single"],
               rel_single=res["rel_single"], wall_ms=res["wall_ms"],
               single_ms=res["single_ms"], setup_s=res["setup_s"],
               staging_s=res["staging_s"], rank_args_s=res["rank_args_s"],
               halo=res["halo"],
               widths=res["widths"], s2_halo=res["s2_halo"],
               placement=res["placement"], cycle=res["cycle"],
               warm=res["warm"], staged_bytes=res["staged_bytes"],
               launches=res["launches"])
    if world > 1:
        sharded = ["sharded"] * (len(EXPECT_LEVEL_ROWS) - 1)
        if res["halo"] != "ppermute":
            bad["halo"] = res["halo"]
        if res["placement"] != sharded + ["replicated"]:
            bad["placement"] = res["placement"]
        agg = res["agg"]
        if agg["iters"] != agg["iters_sharded"] or agg["placement"] != \
                ["sharded"] + ["replicated"] * len(sharded):
            bad["agg"] = agg
        if not res["overlap"]["bitwise"]:
            bad["overlap"] = res["overlap"]
        fault = res["fault"]
        if fault["status"] != ["nonfinite"] * world or not fault["finite"] \
                or not fault["restage_bitwise"]:
            bad["fault"] = fault
        if res["mrhs"]["iters"] != res["mrhs"]["iters_single"]:
            bad["mrhs"] = res["mrhs"]
        out.update(cut=f"{world} ranks on one card: each rank holds a "
                       f"quarter of the one-device rung",
                   agg=agg, overlap=res["overlap"], fault=fault,
                   mrhs=res["mrhs"])
    if bad:
        raise AssertionError(f"dist path {label}: {bad}")
    return out


def _check_dist_coeff(label: str, res: dict) -> tuple:
    """Hold a run's COEFF and MARCH sections to the dist path's
    expectations; returns the ``dist coeff`` and ``dist march`` lines."""
    world, c, mr = res["world"], res["coeff"], res["march"]
    bad = {}
    if c["iters"] != c["iters_single"] or c["rel_single"] > DIST_TOL \
            or c["status"] != ["healthy"] * world:
        bad["single"] = {k: c[k] for k in ("iters", "iters_single",
                                           "rel_single", "status")}
    # bitwise slabs give bitwise x slabs; otherwise the selftest held the
    # slabs to SLAB_TOL and equal iterations
    if c["slab_bitwise"] and not c["x_bitwise"] \
            or c["iters_value"] != c["iters"]:
        bad["value_stream"] = {k: c[k] for k in (
            "slab_bitwise", "slab_rel", "x_bitwise", "iters_value")}
    if c["assemble_launches"] != world:
        bad["assemble_launches"] = c["assemble_launches"]
    f32 = c["f32_update"]
    if f32["h2d_bytes"] != c["coeff_bytes"] or f32["restaged"] \
            or f32["dtype"] != "float64":
        bad["f32_update"] = f32
    if "mrhs" in c and not (c["mrhs"]["iters"] == c["mrhs"]["iters_single"]
                            == c["mrhs"]["iters_vector"]):
        bad["mrhs"] = c["mrhs"]
    if "fault" in c and (c["fault"]["status"] != ["nonfinite"] * world
                         or not c["fault"]["finite"]):
        bad["fault"] = c["fault"]
    steps = mr["steps"]
    if mr["iters"] != mr["iters_single"] \
            or any(r["rel_single"] > DIST_TOL for r in steps) \
            or mr["h2d_bytes"] != [0] * len(steps) \
            or mr["staged"] != [1] * world \
            or mr["iters"][-1] > mr["iters_cold_last"]:
        bad["march"] = mr
    if not any(r["name"].startswith("rank assembly")
               for r in res.get("kernel_cases", [])):
        bad["kernel_cases"] = "no rank assembly case"
    if bad:
        raise AssertionError(f"dist coefficient program {label}: {bad}")
    check_path_launches(f"dist coeff {label}", c["launches"],
                        DIST_COEFF_KERNELS)
    check_path_launches(f"dist march {label}", mr["launches"],
                        DIST_COEFF_KERNELS)
    coeff = dict(
        world=world, iters=c["iters"], iters_single=c["iters_single"],
        rel_single=c["rel_single"], slab_bitwise=c["slab_bitwise"],
        slab_rel=c["slab_rel"], x_bitwise=c["x_bitwise"],
        epad=c["epad"], coeff_bytes_a_step=c["coeff_bytes"],
        h2d_bytes_a_step=f32["h2d_bytes"],
        assemble_launches=c["assemble_launches"],
        wall_ms=c["wall_ms"], single_ms=c["single_ms"],
        mrhs=c.get("mrhs"), fault=c.get("fault"), launches=c["launches"])
    march = dict(
        world=world, iters=mr["iters"], iters_single=mr["iters_single"],
        iters_cold_last=mr["iters_cold_last"],
        rel_single=[r["rel_single"] for r in steps],
        h2d_bytes=mr["h2d_bytes"], epad=mr["epad"], staged=mr["staged"],
        wall_ms=[r["wall_ms"] for r in steps],
        single_ms=[r["single_ms"] for r in steps])
    return coeff, march


def dist_path(m: int = MAIN_M) -> dict:
    """The dist path: the selftest's runs (``DIST_RUNS``) as child
    processes on the card; returns their kernel launches by family,
    summed over the runs and the ranks."""
    launches = dict.fromkeys(KERNELS, 0)
    for label, extra in DIST_RUNS.items():
        cmd = [sys.executable, "-m", "repro_torch.dist.selftest", str(m),
               "--device", "cuda", *extra]
        with Children({label: cmd}) as kid:
            done, secs = kid.wait(DIST_TIMEOUT_S)
        out = done[label]
        lines = out.stdout.splitlines()
        if out.returncode != 0 or not lines or lines[-1] != "OK":
            raise AssertionError(
                f"dist path {label}: exit {out.returncode}\n"
                f"{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
        res = json.loads(next(ln for ln in lines
                              if ln.startswith("dist result "))
                         [len("dist result "):])
        line = _check_dist(label, res)
        line["child_s"] = secs[label]
        print(f"dist path {label} " + json.dumps(line))
        coeff, march = _check_dist_coeff(label, res)
        print(f"dist coeff {label} " + json.dumps(coeff))
        print(f"dist march {label} " + json.dumps(march))
        for row in res.get("kernel_cases", []):
            print(f"dist kernel case {label} " + json.dumps(row))
        for k, v in res["launches"].items():
            launches[k] += v
    check_path_launches("dist", launches, DIST_KERNELS)
    return launches


def _failed(label: str, out) -> AssertionError:
    return AssertionError(f"front door {label}: exit {out.returncode}\n"
                          f"{out.stdout[-3000:]}\n{out.stderr[-6000:]}")


#: each kernel's counted wrappers (the functions of its ``ops`` module
#: that launch it) with their plain versions (its ``ref`` module)
WRAPPERS = {
    "block_seg_sum": (("block_seg_sum", "block_seg_sum_ref"),),
    "block_spmv": (("block_spmv_ell", "block_spmv_ell_ref"),),
    "fused_smoother": (("smoother_step_ell", "smoother_step_ref"),
                       ("smoother_step_scalar_ell",
                        "smoother_step_scalar_ref")),
    "fused_pair_gemm": (("fused_pair_gemm", "fused_pair_gemm_ref"),),
    "block_spmm": (("block_spmm_ell", "block_spmm_ell_ref"),),
    "block_pair_gemm": (("block_pair_gemm", "block_pair_gemm_ref"),),
    "pbjacobi": (("pbjacobi_update", "pbjacobi_update_ref"),),
}
#: the pair GEMMs' plain versions run in slices of this many pairs (tile
#: slots for ``fused_pair_gemm``), each independent of the others: at
#: m=21 one call's pair products are GBs, the plain version's gathers as
#: many again
CHECK_CHUNK = 1 << 20
#: ``--front-door NAME --check-kernels ...``: the child holds its launches
#: against the plain versions (``KernelCheck``)
KERNEL_CHECK_FLAG = "--check-kernels"


def _sig(value):
    """What a call's signature keeps of an argument: a tensor's shape and
    dtype, any other value as it is."""
    import torch
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), value.dtype
    return value


class KernelCheck:
    """Every kernel launch of a scope held against the kernel's plain
    version on the launch's own inputs.  Each wrapper of ``WRAPPERS`` is
    replaced for the scope; the first call on the card of each signature
    (wrapper, argument shapes, dtypes and other values) runs the plain
    version on the same card tensors as soon as the kernel has returned
    (before the caller can touch them; the pair GEMMs in ``CHECK_CHUNK``
    slices), the largest error within its dtype's tolerance of the largest
    term.  ``through`` counts the launches made inside the replaced
    wrappers: equal to the launch counts, every launch of the scope had a
    checked signature.  The plain versions launch no kernel."""

    def __init__(self):
        self.rows, self.seen = {}, set()
        self.through = dict.fromkeys(KERNELS, 0)
        self._saved = []

    def __enter__(self) -> "KernelCheck":
        import importlib
        for kernel, mod in _ops().items():
            ref = importlib.import_module(
                f"repro_torch.kernels.{kernel}.ref")
            for wname, rname in WRAPPERS[kernel]:
                orig = getattr(mod, wname)
                self._saved.append((mod, wname, orig))
                setattr(mod, wname, self._shim(kernel, mod, wname, orig,
                                               getattr(ref, rname)))
        return self

    def __exit__(self, *exc) -> None:
        for mod, wname, orig in self._saved:
            setattr(mod, wname, orig)

    def _shim(self, kernel, mod, wname, orig, ref):
        import torch

        def shim(*args, **kwargs):
            if not (isinstance(args[0], torch.Tensor)
                    and args[0].device.type == "cuda"):
                return orig(*args, **kwargs)
            sig = (wname, tuple(map(_sig, args)),
                   tuple((k, _sig(v)) for k, v in sorted(kwargs.items())))
            before = mod.launches
            out = orig(*args, **kwargs)
            self.through[kernel] += mod.launches - before
            if sig not in self.seen:
                self.seen.add(sig)
                self._compare(kernel, orig, ref, args, kwargs, out)
            return out
        return shim

    def _compare(self, kernel, orig, ref, args, kwargs, out) -> None:
        import inspect

        import torch
        a = inspect.signature(orig).bind(*args, **kwargs).arguments
        a.pop("threads", None)
        if kernel in ("block_pair_gemm", "fused_pair_gemm"):
            sliced = (("lhs", "rhs") if kernel == "block_pair_gemm"
                      else ("tile_a", "tile_b", "tile_mask"))
            n = a[sliced[0]].shape[0]
            # a tile row gathers its pair_kmax slots
            step = CHECK_CHUNK // (a["tile_a"].shape[1] or 1) \
                if kernel == "fused_pair_gemm" else CHECK_CHUNK
            step = max(step, 1)
            parts = [(out[i:i + step], dict(a, **{
                k: a[k][i:i + step] for k in sliced}))
                for i in range(0, n, step)]
        else:
            parts = [(out, a)]
        err = scale = 0.0
        for got, kw in parts:
            want = ref(**kw)
            if isinstance(got, tuple):
                got, want = torch.cat([g.reshape(-1) for g in got]), \
                    torch.cat([w.reshape(-1) for w in want])
            if got.numel():
                err = max(err, float((got - want).abs().max()))
                scale = max(scale, float(want.abs().max()))
        dt = out[0].dtype if isinstance(out, tuple) else out.dtype
        tol = {torch.float32: PRECISIONS["f32"],
               torch.bfloat16: PRECISIONS["bf16"]}.get(dt, REL_TOL)
        rel = err / scale if scale else err
        row = self.rows.setdefault(kernel, dict(
            kernel=kernel, signatures=0, max_abs_err=0.0, max_rel_err=0.0,
            failed=[]))
        row["signatures"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["max_rel_err"] = max(row["max_rel_err"], rel)
        if not rel <= tol:
            row["failed"].append(dict(args=repr(
                [_sig(v) for v in a.values()]), rel=rel, tol=tol))

    def report(self, counts: dict) -> list:
        """One row a kernel that launched, with its launches; raises if a
        launch went round the wrappers or a signature disagreed."""
        bad = {k: (self.through[k], n) for k, n in counts.items()
               if self.through[k] != n}
        bad.update({k: r["failed"] for k, r in self.rows.items()
                    if r["failed"]})
        if bad:
            raise AssertionError(f"kernel check: {bad}")
        return [dict(self.rows[k], launches=n) for k, n in counts.items()
                if n]


def front_door_child(name: str, argv: list) -> int:
    """``chip_smoke.py --front-door NAME [--check-kernels] [ARGS]``: the
    twin's command line (``python -m repro_torch.NAME ARGS``, its ``cli``)
    with the launch counts set to 0 just before it; prints its JSON line,
    then the launches.  With ``--check-kernels`` the launches are held
    against the plain versions (``KernelCheck``): one ``door kernel
    check`` line a kernel that launched, before the launches."""
    import importlib
    check = KERNEL_CHECK_FLAG in argv
    argv = [a for a in argv if a != KERNEL_CHECK_FLAG]
    mod = importlib.import_module(f"repro_torch.{name}")
    with KernelCheck() if check else contextlib.nullcontext() as chk:
        reset_counts()
        rc = mod.cli(list(argv))
    counts = read_counts()
    if chk is not None:
        for row in chk.report(counts):
            print("door kernel check " + json.dumps(row))
    print("door launches " + json.dumps(counts))
    return rc


def _door_run(label: str, out) -> tuple:
    """A ``--front-door`` child's JSON line and launches (its ``door
    kernel check`` lines aside)."""
    lines = [ln for ln in out.stdout.splitlines()
             if not ln.startswith("door kernel check ")]
    if out.returncode or len(lines) < 2 \
            or not lines[-1].startswith("door launches "):
        raise _failed(label, out)
    return json.loads(lines[-2]), json.loads(lines[-1][len("door "
                                                            "launches "):])


def _door_key(name: str, res: dict) -> dict:
    """What a twin's CPU and card runs must share: levels, buckets and
    iterations (as JSON reads them back)."""
    key = dict(levels=res["level_rows"])
    if name == "serve_amg":
        key.update(bursts=[(b["k_bucket"], b["iters"])
                           for b in res["bursts"]],
                   post=res["post_update_iters"], stats=res["stats"])
    elif name == "observe_amg":
        key.update(iters=res["iters"], tally=res["tally"],
                   bursts=res["bursts"], request=res["request"]["iters"])
    else:
        key.update(iters=res["iters"])
    return json.loads(json.dumps(key))


def _check_door(name: str, res: dict) -> dict:
    """A twin's card run at ``DOORS_M``; returns its line's summary."""
    bad = {}
    if res["level_rows"] != EXPECT_MIS_ROWS or \
            not res["device"].startswith("cuda"):
        bad["levels"] = (res["device"], res["level_rows"])
    if name == "serve_amg":
        if not all(b["converged"] for b in res["bursts"]):
            bad["bursts"] = res["bursts"]
        out = dict(bursts=[dict(requests=b["requests"],
                                buckets=b["buckets"], iters=b["iters"],
                                ms=b["ms"]) for b in res["bursts"]],
                   update_ms=res["update_ms"],
                   post_update_iters=res["post_update_iters"],
                   solves_per_k=res["stats"]["solves_per_k"])
    elif name == "observe_amg":
        out = dict(iters=res["iters"], tally=res["tally_line"],
                   request=res["request"], recompute=res["recompute"],
                   instruments=len(res["prometheus"]),
                   jsonl_lines=res["jsonl_lines"],
                   latency_p50_s=res["snapshot"]["latency_p50_s"])
    else:
        fields = 2 * res["n_elements"] * 8
        if res["field_bytes"] != fields or any(
                s["h2d_bytes"] != fields for s in res["steps"]):
            bad["h2d"] = res["steps"]
        out = dict(iters=res["iters"], n_elements=res["n_elements"],
                   h2d_bytes=[s["h2d_bytes"] for s in res["steps"]],
                   h2d_copies=[s["h2d_copies"] for s in res["steps"]],
                   update_ms=[s["update_ms"] for s in res["steps"]],
                   solve_ms=[s["solve_ms"] for s in res["steps"]])
    if bad:
        raise AssertionError(f"front door {name} m={DOORS_M}: {bad}")
    return dict(m=res["m"], levels=res["level_rows"], **out)


def _check_measure(pc: int, res: dict) -> dict:
    want = EXPECT_MEASURE
    meas = res["measured"]
    got = {k: {f: meas[k][f] for f in want[k]} for k in ("cycle",
                                                         "recompute")}
    rows = res["model_rows"]
    if got["cycle"] != want["cycle"] or got["recompute"] != \
            want["recompute"] or res["model_msgs"] != want["model_msgs"] \
            or rows[0]["halo_bytes"] != want["halo_bytes"][pc] \
            or rows[-1]["gather_bytes"] != want["gather_bytes"] \
            or not res["agree"] or res["backend"] != "gloo":
        raise AssertionError(f"dist.measure 5 2 {pc}: {res}")
    return dict(pc=pc, cycle=meas["cycle"], recompute=meas["recompute"],
                recompute_calls=meas["recompute_calls"],
                model_msgs=res["model_msgs"],
                model_bytes=res["model_bytes"],
                halo_bytes=[r["halo_bytes"] for r in rows],
                gather_bytes=[r["gather_bytes"] for r in rows],
                agree=res["agree"], levels=res["levels"])


def front_doors_phase() -> dict:
    """The AMG front doors on the card, each a child process with its
    launches counted: ``serve_amg``, ``observe_amg`` and
    ``heterogeneous`` at ``DOORS_M`` (the MIS setting's levels; the
    heterogeneous updates' host-to-device bytes the two fields) and at
    ``DOORS_CHECK_M`` beside the same twin on the CPU in this process
    (levels, buckets and iterations equal); ``python -m
    repro_torch.dist.measure 5 2 1`` and ``5 2 2`` (the reference's
    counts, ``EXPECT_MEASURE``); ``python -m repro_torch.amg_distributed``
    at its default (8 gloo ranks at m=6 on the one card) and at world 1
    (NCCL).  Returns the launches by family summed over the children."""
    import importlib
    launches = dict.fromkeys(KERNELS, 0)
    me = [sys.executable, str(ROOT / "chip_smoke.py"), DOOR_FLAG]
    cmds = {(name, m): me + [name, str(m)] for name in DOORS
            for m in (DOORS_M, DOORS_CHECK_M)}
    # the children run while this process runs the CPU twins
    with Children(cmds) as kids:
        cpu = {}
        for name in DOORS:
            with contextlib.redirect_stdout(open(os.devnull, "w")):
                cpu[name] = importlib.import_module(
                    f"repro_torch.{name}").main(DOORS_CHECK_M,
                                                device="cpu")
        done, secs = kids.wait(DOORS_TIMEOUT_S)
    for name in DOORS:
        res, got = _door_run(f"{name} {DOORS_M}", done[(name, DOORS_M)])
        line = _check_door(name, res)
        check_path_launches(f"front door {name}", got, DOOR_KERNELS[name])
        card7, got7 = _door_run(f"{name} {DOORS_CHECK_M}",
                                done[(name, DOORS_CHECK_M)])
        if _door_key(name, card7) != _door_key(name, cpu[name]):
            raise AssertionError(
                f"front door {name} m={DOORS_CHECK_M}: card "
                f"{_door_key(name, card7)}, cpu {_door_key(name, cpu[name])}")
        line.update(launches=got, child_s=secs[(name, DOORS_M)],
                    cpu_vs_cuda=dict(m=DOORS_CHECK_M, equal=True,
                                     **_door_key(name, card7)),
                    check_child_s=secs[(name, DOORS_CHECK_M)])
        print(f"front door {name} " + json.dumps(line))
        for d in (got, got7):
            for f, v in d.items():
                launches[f] += v

    dist_cmds = {("dist.measure", pc): [sys.executable, "-m",
                                        "repro_torch.dist.measure", "5",
                                        "2", str(pc)] for pc in (1, 2)}
    dist_cmds.update({("amg_distributed", label): [
        sys.executable, "-m", "repro_torch.amg_distributed", *argv]
        for label, argv in DISTRIBUTED_RUNS.items()})
    with Children(dist_cmds) as kids:
        done, secs = kids.wait(DOORS_TIMEOUT_S)
    for (name, arg), out in done.items():
        lines = out.stdout.splitlines()
        if name == "dist.measure":
            if out.returncode or not lines:
                raise _failed(f"dist.measure 5 2 {arg}", out)
            res = json.loads(lines[-1])
            line = _check_measure(arg, res)
            label = f"dist.measure 5 2 {arg}"
        else:
            if out.returncode or not lines or lines[-1] != "OK":
                raise _failed(f"amg_distributed {arg}", out)
            res = json.loads(next(ln for ln in lines if ln.startswith(
                "dist result "))[len("dist result "):])
            world = res["world"]
            if res["iters"] != res["iters_single"] or res["status"] != \
                    ["healthy"] * world or not res["cycle"]["agree"] \
                    or not res["repeat_bitwise"]:
                raise AssertionError(f"amg_distributed {arg}: {res}")
            line = {k: res[k] for k in ("m", "world", "backend", "levels",
                                        "iters", "iters_single",
                                        "rel_single", "placement", "halo",
                                        "wall_ms", "single_ms")}
            line["cycle"] = res["cycle"]
            label = f"amg_distributed {arg}"
        check_path_launches(f"front door {label}", res["launches"],
                            DOOR_KERNELS[name])
        line.update(launches=res["launches"], child_s=secs[(name, arg)])
        print(f"front door {label} " + json.dumps(line))
        for f, v in res["launches"].items():
            launches[f] += v
    return launches


# ---------------------------------------------------------------------------
# The LM phase
# ---------------------------------------------------------------------------

#: the LM phase: the f32 tolerance of logits and caches, card against CPU
#: and decode against prefill (the reference's own,
#: tests/test_arch_smoke.py:110); the serve loop of examples/serve_lm.py
#: (batch, prompt, generated tokens); falcon-mamba-7b's prefill length,
#: past the selective scan's chunk of 64, its depth on the card (the
#: config's 64 layers, ~29 GB of f32 params) and in the card-vs-CPU
#: check (29 GB on the host is too slow); the reduced check's batch,
#: prompt, cache and decode steps; the seed of every init
LM_TOL = 2e-4
LM_B, LM_PROMPT, LM_GEN = 4, 32, 32
LM_MAMBA_TOKENS = 70
LM_MAMBA_LAYERS = 64
LM_MAMBA_CHECK_LAYERS = 2
LM_REDUCED = (2, 16, 8, 3)
LM_SEED = 0
LM_DOOR = "serve_lm"


def _lm_err(got, want) -> float:
    """The largest |got - want| (as f32 on the CPU); raises past the f32
    tolerance, elementwise ``atol + rtol * |want|``."""
    import torch
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"lm: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, or not finite")
    diff = (got - want).abs()
    if bool((diff > LM_TOL + LM_TOL * want.abs()).any()):
        raise AssertionError(f"lm: {float(diff.max())} past rtol = atol = "
                             f"{LM_TOL}")
    return float(diff.max())


def _lm_leaves(tree: dict):
    for v in tree.values():
        yield from _lm_leaves(v) if isinstance(v, dict) else (v,)


def _lm_tree_err(got: dict, want: dict) -> float:
    """The largest gap over two trees built alike (same keys, same
    order)."""
    return max(_lm_err(g, w) for g, w in zip(_lm_leaves(got),
                                              _lm_leaves(want)))


def _lm_to(tree, device):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda a: a.to(device), tree)


@contextlib.contextmanager
def _no_host_sync(device):
    """CUDA's sync debug mode at "error" inside the block (on the card):
    any op that waits for the device raises."""
    import torch
    on = torch.device(device).type == "cuda"
    if on:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if on:
            torch.cuda.set_sync_debug_mode("default")


def _lm_step_ops(step, *args) -> dict:
    """``step(*args)`` run twice: the aten ops it dispatches (views
    included), then its host-to-device bytes and copies
    (``repro_torch.obs.transfer.count_h2d``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.obs.transfer import count_h2d

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Ops() as ops:
        step(*args)
    _, nbytes, copies = count_h2d(lambda: step(*args))
    return dict(aten_ops=ops.n, h2d_bytes=nbytes, h2d_copies=copies)


def _lm_decode_vs_prefill(cfg, params, tokens, cdt) -> tuple:
    """Prefill logits of ``tokens``, the largest gap of a token-by-token
    decode from them at each position (the cache holds the prompt; each
    step, its position a device tensor, under ``_no_host_sync``), and
    then the last step's ``_lm_step_ops`` (which must copy nothing to the
    card)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill, make_serve_step
    full = make_prefill(cfg, cdt)(params, tokens)
    step = make_serve_step(cfg, cdt)
    cache = T.init_full_cache(cfg, tokens.shape[0], tokens.shape[1], cdt,
                              device=tokens.device)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    gaps = []
    for i in range(tokens.shape[1]):
        with _no_host_sync(tokens.device):
            lg, cache = step(params, cache, tokens[:, i:i + 1], pos[i])
        gaps.append(_lm_err(lg[:, 0], full[:, i]))
    ops = _lm_step_ops(step, params, cache, tokens[:, -1:], pos[-1])
    if ops["h2d_bytes"]:
        raise AssertionError(f"lm: a decode step copies to the card: {ops}")
    return full, gaps, ops


def _lm_serve(cfg, params, cdt, device="cuda") -> dict:
    """``serve_lm.serve`` on the card with the peak memory of its loop."""
    import torch

    from repro_torch import serve_lm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = serve_lm.serve(cfg, params, device=device, cdt=cdt, batch=LM_B,
                         prompt=LM_PROMPT, gen=LM_GEN)
    return dict(seconds=res["seconds"], tok_per_s=res["tok_per_s"],
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                tokens=res["tokens"])


def lm_full_qwen2(device="cuda") -> dict:
    """qwen2-0.5b at its full config: params drawn on the CPU from the seed,
    copied to the card; prefill of ``LM_B`` x ``LM_PROMPT`` tokens at f32,
    card against the port on the CPU; decode against prefill on the card;
    the serve loop at f32 and bf16."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    cpu = T.init_lm(cfg, LM_SEED, device="cpu")
    init_s = time.perf_counter() - t0
    params = _lm_to(cpu, device)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_B, LM_PROMPT)))
    t0 = time.perf_counter()
    want = make_prefill(cfg, torch.float32)(cpu, toks)
    cpu_s = time.perf_counter() - t0
    del cpu
    prefill = make_prefill(cfg, torch.float32)
    dtoks = toks.to(device)
    card = prefill(params, dtoks)
    prefill_ms = time_ms(lambda: prefill(params, dtoks), reps=5)
    err = _lm_err(card, want)
    _, gaps, ops = _lm_decode_vs_prefill(cfg, params, dtoks, torch.float32)
    serve = {name: _lm_serve(cfg, params, cdt, device) for name, cdt in
             (("f32", torch.float32), ("bf16", torch.bfloat16))}
    same = float((serve["f32"].pop("tokens")
                  == serve["bf16"].pop("tokens")).mean())
    return dict(card=card_line(), arch=cfg.name, layers=cfg.n_layers,
                d_model=cfg.d_model, vocab=cfg.vocab_size,
                params=T.count_params(params),
                init_cpu_s=init_s, prefill=f"{LM_B}x{LM_PROMPT}",
                card_vs_cpu_max_abs=err, prefill_cpu_s=cpu_s,
                prefill_card_ms=prefill_ms,
                decode_vs_prefill_max_abs=max(gaps), decode_step=ops,
                serve=serve, greedy_tokens_bf16_equal_f32=same)


def lm_full_mamba(layers: int = LM_MAMBA_LAYERS, device="cuda") -> dict:
    """falcon-mamba-7b at full width: ``layers`` layers drawn on the card;
    ``LM_MAMBA_TOKENS`` tokens decoded one by one against their prefill at
    f32 (the gaps over the first ``LM_PROMPT`` and over all of them); the
    serve loop at f32 and bf16.  Then the config at
    ``LM_MAMBA_CHECK_LAYERS`` layers, card against CPU: the prefill and 3
    decode steps (logits and state)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill, make_serve_step
    full = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(full, n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_lm(cfg, LM_SEED, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = T.count_params(params)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, LM_MAMBA_TOKENS)), device=device)
    _, gaps, ops = _lm_decode_vs_prefill(cfg, params, toks, torch.float32)
    peak = torch.cuda.max_memory_allocated()
    serve = {name: _lm_serve(cfg, params, cdt, device) for name, cdt in
             (("f32", torch.float32), ("bf16", torch.bfloat16))}
    for s in serve.values():
        del s["tokens"]
    del params
    gc.collect()
    torch.cuda.empty_cache()

    small = dataclasses.replace(full, n_layers=LM_MAMBA_CHECK_LAYERS)
    card = T.init_lm(small, LM_SEED, device=device)
    cpu = _lm_to(card, "cpu")
    runs = {}
    for dev, p in (("card", card), ("cpu", cpu)):
        t = toks.to(p["embed"].device)
        cache = T.init_full_cache(small, 2, LM_MAMBA_TOKENS, torch.float32,
                                  device=t.device)
        step = make_serve_step(small, torch.float32)
        out = [make_prefill(small, torch.float32)(p, t)]
        for i in range(3):
            lg, cache = step(p, cache, t[:, i:i + 1], i)
            out.append(lg)
        runs[dev] = (out, cache)
    (got, gcache), (want, wcache) = runs["card"], runs["cpu"]
    check = dict(layers=LM_MAMBA_CHECK_LAYERS,
                 prefill_max_abs=_lm_err(got[0], want[0]),
                 decode_max_abs=max(_lm_err(g, w) for g, w in zip(
                     got[1:], want[1:])),
                 state_max_abs=_lm_tree_err(gcache, wcache))
    del card, cpu, runs, got, gcache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card_line(), arch=full.name, layers=layers,
                of_layers=full.n_layers,
                d_model=cfg.d_model, d_inner=cfg.ssm.expand * cfg.d_model,
                d_state=cfg.ssm.d_state, vocab=cfg.vocab_size,
                params=n_params, init_card_s=init_s,
                tokens=f"2x{LM_MAMBA_TOKENS}",
                decode_vs_prefill_max_abs_first_32=max(gaps[:LM_PROMPT]),
                decode_vs_prefill_max_abs=max(gaps), decode_step=ops,
                max_memory_allocated=peak, serve=serve, card_vs_cpu=check)


def lm_reduced(arch: str, device="cuda") -> dict:
    """``arch`` at ``reduced()``: params drawn on the CPU, copied to the
    card; prefill logits and 3 decode steps (logits and cache; whisper
    with its encoder output) at f32, card against CPU."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill, make_serve_step
    cfg = get_config(arch).reduced()
    b, s, cache_len, steps = LM_REDUCED
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))
    feats = None if cfg.encdec is None else torch.as_tensor(
        rng.standard_normal((b, cfg.encdec.encoder_frames, cfg.d_model)),
        dtype=torch.float32)
    cpu = T.init_lm(cfg, LM_SEED, device="cpu")
    runs = {}
    for key, p in (("cpu", cpu), ("card", _lm_to(cpu, device))):
        dev = p["embed"].device
        t = toks.to(dev)
        f = None if feats is None else feats.to(dev)
        out = [make_prefill(cfg, torch.float32)(p, t, f)]
        enc = None
        if f is not None:
            with torch.inference_mode():
                enc = T.encoder_apply(p["encoder"], f, cfg, torch.float32)
        step = make_serve_step(cfg, torch.float32)
        cache = T.init_full_cache(cfg, b, cache_len, torch.float32,
                                  device=dev)
        for i in range(steps):
            lg, cache = step(p, cache, t[:, i:i + 1], i, enc)
            out.append(lg)
        runs[key] = (out, cache)
    (card, ccache), (cpu_out, pcache) = runs["card"], runs["cpu"]
    return dict(prefill_max_abs=_lm_err(card[0], cpu_out[0]),
                decode_max_abs=max(_lm_err(g, w) for g, w in zip(
                    card[1:], cpu_out[1:])),
                cache_max_abs=_lm_tree_err(ccache, pcache),
                params=T.count_params(cpu))


def lm_phase() -> dict:
    """The LM models and the serving path on the card (no AMG kernel on
    it): qwen2-0.5b at its full config, falcon-mamba-7b at full width,
    every arch at ``reduced()`` against the CPU, and ``python -m
    repro_torch.serve_lm`` as a child process beside the same twin on the
    CPU (equal greedy tokens).  The launch counts are set to 0 before it
    and read after: every one must still be 0.  Returns them.  The
    ``max_memory_allocated`` of its lines include what the process held
    when the phase began (``allocated_before`` on the ``lm phase``
    line)."""
    import torch

    from repro_torch import serve_lm
    from repro_torch.configs.registry import ARCH_IDS
    reset_counts()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    print("lm full " + json.dumps(lm_full_qwen2()))
    print("lm full " + json.dumps(lm_full_mamba()))
    cmd = {LM_DOOR: [sys.executable, str(ROOT / "chip_smoke.py"), DOOR_FLAG,
                     LM_DOOR]}
    with Children(cmd) as kids:
        for arch in ARCH_IDS:
            print(f"lm reduced {arch} card vs cpu "
                  + json.dumps(lm_reduced(arch)))
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            cpu = serve_lm.main(device="cpu")
        done, secs = kids.wait(DOORS_TIMEOUT_S)
    res, launches = _door_run(LM_DOOR, done[LM_DOOR])
    if res["device"] == "cpu" or any(launches.values()):
        raise AssertionError(f"lm serve_lm: {res['device']}, {launches}")
    same = {a: res["models"][a]["tokens"] == cpu["models"][a]["tokens"]
            for a in serve_lm.ARCHS}
    if not all(same.values()):
        raise AssertionError(f"lm serve_lm: card tokens differ from the "
                             f"CPU's: {same}")
    print("lm serve_lm " + json.dumps(dict(
        device=res["device"], tokens_equal_cpu=same, child_s=secs[LM_DOOR],
        tok_per_s={a: m["tok_per_s"] for a, m in res["models"].items()},
        launches=launches)))
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"lm phase launched AMG kernels: {counts}")
    print("lm phase " + json.dumps(dict(
        seconds=time.perf_counter() - t0, allocated_before=held,
        launches=counts)))
    return counts


#: the train phase: the f32 card-vs-CPU tolerances (the loss and the
#: global norm relative, each gradient leaf against its largest
#: magnitude; a leaf under ``TRAIN_NOISE`` of the tree's largest
#: gradient is zero in exact arithmetic, e.g. llama4's top-1 router, and
#: is held below that on both devices); (a)'s batch and sequence; (b)'s
#: batch, sequence and steps at bf16 with ``examples/train_lm.py``'s
#: optimizer (``tests/test_arch_smoke.py``'s lr 3e-3 and warmup 5, made
#: for the reduced model, make the full one's loss rise again within 20
#: steps); falcon-mamba-7b's
#: depth (params, gradients and both moments, 16 B a param, with the
#: activations on one card: ~1.4e9 params) and its bf16 batch, sequence
#: and steps; its card-vs-CPU sequence at ``LM_MAMBA_CHECK_LAYERS``
#: layers (past the scan's chunk of 64); the restart run of
#: ``tests/test_fault_tolerance.py`` (steps, save every, failures, batch,
#: sequence); the twins' steps
TRAIN_TOL = dict(loss=1e-5, grad_norm=1e-5, leaf=1e-4)
TRAIN_NOISE = 1e-6
TRAIN_CHECK = (2, 32)
TRAIN_BF16 = (4, 256, 20)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=50)
TRAIN_MAMBA_LAYERS = 8
TRAIN_MAMBA_BF16 = (2, 256, 4)
TRAIN_MAMBA_CHECK_SEQ = LM_MAMBA_TOKENS
TRAIN_RESTART = dict(total=10, save_every=3, fail_at=(4, 8), batch=2,
                     seq_len=17)
TRAIN_RESTART_RTOL = 1e-6
TRAIN_LM_STEPS = (40, 60)
TRAIN_LAUNCH_STEPS = 5
TRAIN_DOORS = ("train_lm", "launch.train")


def _batch(cfg, batch: int, seq: int, step: int = 0) -> dict:
    """``SyntheticTokens.batch_at(step)`` (numpy) for ``cfg``: ``seq``
    tokens and labels a row (``enc_feats`` for an enc-dec)."""
    from repro_torch.train.data import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=batch, seq_len=seq + 1,
        enc_frames=cfg.encdec.encoder_frames if cfg.encdec else 0,
        d_model=cfg.d_model)).batch_at(step)


def _falls(losses) -> bool:
    """The reference's criterion (``tests/test_arch_smoke.py:155``): every
    loss finite and the mean of the last 4 below the mean of the first 4."""
    import numpy as np
    losses = np.asarray(losses, dtype=np.float64)
    return bool(np.isfinite(losses).all()
                and losses[-4:].mean() < losses[:4].mean())


def train_check(cfg, cpu_params, batch: int, seq: int,
                device="cuda") -> dict:
    """One f32 train step of ``cfg`` on the card against the CPU from the
    same params (drawn on the CPU): the loss and the global gradient norm
    relative, each gradient leaf against that leaf's largest magnitude,
    within ``TRAIN_TOL``; the card's ``make_train_step`` gives the same
    loss and norm, its step ms beside."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig, global_norm, \
        init_opt_state
    from repro_torch.train.steps import loss_and_grads, make_train_step
    b = _batch(cfg, batch, seq)
    t0 = time.perf_counter()
    want_loss, want = loss_and_grads(
        cpu_params, {k: torch.as_tensor(v) for k, v in b.items()}, cfg,
        torch.float32)
    want_norm = global_norm(want)
    cpu_s = time.perf_counter() - t0
    params = _lm_to(cpu_params, device)
    db = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
    loss, grads = loss_and_grads(params, db, cfg, torch.float32)
    norm = global_norm(grads)
    top = max(float(w.abs().max()) for w in T.tree_leaves(want))
    leaf, noise = 0.0, {}
    for (path, g), w in zip(T.tree_leaves_with_path(grads),
                            T.tree_leaves(want)):
        g, scale = g.cpu(), float(w.abs().max())
        if scale < TRAIN_NOISE * top:
            noise["/".join(path)] = max(scale, float(g.abs().max())) / top
        else:
            leaf = max(leaf, float((g - w).abs().max()) / scale)
    del grads, want
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), torch.float32,
                           device=device)
    opt = init_opt_state(params)
    _, _, m = step(params, opt, db)
    step_ms = time_ms(lambda: step(params, opt, db), reps=3, warmup=0)
    res = dict(loss=float(loss), loss_rel=_rel(loss, want_loss),
               grad_norm=float(norm), grad_norm_rel=_rel(norm, want_norm),
               leaf_max_rel=leaf, noise_leaves=noise,
               step_loss_rel=_rel(m["loss"], want_loss),
               step_grad_norm_rel=_rel(m["grad_norm"], want_norm),
               cpu_s=cpu_s, f32_step_ms=step_ms)
    bad = {k: res[k] for k in ("loss_rel", "step_loss_rel")
           if not res[k] <= TRAIN_TOL["loss"]}
    bad.update({k: res[k] for k in ("grad_norm_rel", "step_grad_norm_rel")
                if not res[k] <= TRAIN_TOL["grad_norm"]})
    if not leaf <= TRAIN_TOL["leaf"]:
        bad["leaf_max_rel"] = leaf
    if not all(v < TRAIN_NOISE for v in noise.values()):
        bad["noise_leaves"] = noise
    if bad:
        raise AssertionError(f"train {cfg.name}: card against CPU past "
                             f"{TRAIN_TOL}: {bad}")
    return res


def _train_steps(cfg, params, batch: int, seq: int, steps: int, opt_cfg,
                 device="cuda") -> dict:
    """``steps`` bf16 train steps on ``SyntheticTokens``: every loss, ms a
    step over the steps after the first (host clock, synchronized), tok/s
    over them and ``max_memory_allocated``; returns the last params too."""
    import torch

    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.steps import make_train_step
    step = make_train_step(cfg, opt_cfg, torch.bfloat16, device=device)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, opt, m = step(params, opt, _batch(cfg, batch, seq, i))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dict(losses=torch.stack(losses).tolist(),
                step_ms=dt * 1e3 / (steps - 1),
                tok_per_s=(steps - 1) * batch * seq / dt,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                params=params)


def _train_step_profile(cfg, params, batch: int, seq: int,
                        device="cuda") -> dict:
    """One bf16 train step (the batch on the card) under
    ``torch.profiler`` (``_profiled``): wall ms, device busy ms (the sum
    of its kernels' device time), the idle share, kernel launches and the
    top kernels by device ms; then the aten ops it dispatches and the
    bytes it copies to the card (``_lm_step_ops``)."""
    import collections

    import torch

    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import make_train_step
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT), torch.bfloat16,
                           device=device)
    opt = init_opt_state(params)
    b = {k: torch.as_tensor(v, device=device)
         for k, v in _batch(cfg, batch, seq).items()}
    step(params, opt, b)

    def timed():
        t0 = time.perf_counter()
        step(params, opt, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall, kernels, _ = _profiled(timed)
    busy = sum(e.device_time for e in kernels) / 1e3
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.device_time / 1e3
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=1.0 - busy / wall, kernels=len(kernels),
                top=[(k, round(v, 3)) for k, v in by_name.most_common(6)],
                **_lm_step_ops(step, params, opt, b))


def _stack_backward_ms(cfg, params, batch: int, seq: int,
                       device="cuda") -> dict:
    """One bf16 train step with each layer's params taken by one
    ``unbind`` a stacked leaf (``transformer._unstack``, kept) and by
    indexing the stack a layer at a time (each ``a[i]``'s backward a
    zero tensor the size of the stack), in turns (indexed, unbind,
    unbind, indexed): ms a step (CUDA events, median of 3) and peak
    memory of each."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import make_train_step
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT), torch.bfloat16,
                           device=device)
    opt = init_opt_state(params)
    b = {k: torch.as_tensor(v, device=device)
         for k, v in _batch(cfg, batch, seq).items()}
    kept = T._unstack

    def indexed(tree, n):
        return [T._layer(tree, i) for i in range(n)]

    out = {"indexed": [], "unbind": []}
    peak = {}
    try:
        for name in ("indexed", "unbind", "unbind", "indexed"):
            T._unstack = indexed if name == "indexed" else kept
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out[name].append(time_ms(lambda: step(params, opt, b), reps=3,
                                     warmup=1))
            peak[name] = torch.cuda.max_memory_allocated()
    finally:
        T._unstack = kept
    return {name: dict(step_ms=min(v), max_memory_allocated=peak[name])
            for name, v in out.items()}


def train_full_qwen2(device="cuda") -> dict:
    """qwen2-0.5b at its full config, params drawn on the CPU from the
    seed and copied: (a) one f32 step card against CPU at
    ``TRAIN_CHECK``; (b) ``TRAIN_BF16`` bf16 steps with
    ``examples/train_lm.py``'s optimizer, whose loss must fall; one
    bf16 step profiled; the stacked-leaf backward both ways."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    cpu = T.init_lm(cfg, LM_SEED, device="cpu")
    init_s = time.perf_counter() - t0
    n_params = T.count_params(cpu)
    check = train_check(cfg, cpu, *TRAIN_CHECK, device=device)
    b, s, n = TRAIN_BF16
    run = _train_steps(cfg, _lm_to(cpu, device), b, s, n,
                       AdamWConfig(**TRAIN_OPT), device)
    del cpu
    if not _falls(run["losses"]):
        raise AssertionError(f"train qwen2-0.5b: the bf16 loss does not "
                             f"fall: {run['losses']}")
    params = run.pop("params")
    prof = _train_step_profile(cfg, params, b, s, device)
    stack = _stack_backward_ms(cfg, params, b, s, device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card_line(), arch=cfg.name, layers=cfg.n_layers,
                d_model=cfg.d_model, vocab=cfg.vocab_size, params=n_params,
                init_cpu_s=init_s, f32_check=dict(
                    batch=f"{TRAIN_CHECK[0]}x{TRAIN_CHECK[1]}", **check),
                bf16=dict(batch=f"{b}x{s}", steps=n,
                          settings="examples/train_lm.py (lr 3e-4, "
                                   "warmup 50)", **run),
                profiled_bf16_step=prof, stacked_leaf_backward=stack)


def train_full_mamba(layers: int = TRAIN_MAMBA_LAYERS,
                     device="cuda") -> dict:
    """falcon-mamba-7b at full width and ``layers`` layers (drawn on the
    card): ``TRAIN_MAMBA_BF16`` bf16 steps (every loss finite, every
    param moved); then at ``LM_MAMBA_CHECK_LAYERS`` layers one f32 step
    card against CPU over ``TRAIN_MAMBA_CHECK_SEQ`` tokens a row (the
    backward of the Hillis–Steele scan across chunks)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig
    full = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(full, n_layers=layers)
    params = T.init_lm(cfg, LM_SEED, device=device)
    n_params = T.count_params(params)
    b, s, n = TRAIN_MAMBA_BF16
    run = _train_steps(cfg, params, b, s, n, AdamWConfig(**TRAIN_OPT),
                       device)
    moved = [not torch.equal(a, c) for a, c in zip(
        T.tree_leaves(params), T.tree_leaves(run.pop("params")))]
    del params
    if not (np.isfinite(run["losses"]).all() and all(moved)):
        raise AssertionError(f"train falcon-mamba-7b: losses "
                             f"{run['losses']}, leaves moved {moved}")
    gc.collect()
    torch.cuda.empty_cache()
    small = dataclasses.replace(full, n_layers=LM_MAMBA_CHECK_LAYERS)
    cpu = T.init_lm(small, LM_SEED, device="cpu")
    check = train_check(small, cpu, 2, TRAIN_MAMBA_CHECK_SEQ, device)
    del cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card_line(), arch=full.name, layers=layers,
                of_layers=full.n_layers, d_model=cfg.d_model,
                d_inner=cfg.ssm.expand * cfg.d_model, d_state=cfg.ssm.d_state,
                vocab=cfg.vocab_size, params=n_params,
                bf16=dict(batch=f"{b}x{s}", steps=n, **run),
                f32_check=dict(layers=LM_MAMBA_CHECK_LAYERS,
                               batch=f"2x{TRAIN_MAMBA_CHECK_SEQ}", **check))


def train_reduced(arch: str, device="cuda") -> dict:
    """``arch`` at ``reduced()``: one f32 train step card against CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    cpu = T.init_lm(cfg, LM_SEED, device="cpu")
    res = train_check(cfg, cpu, *TRAIN_CHECK, device=device)
    return dict(params=T.count_params(cpu), **{
        k: res[k] for k in ("loss", "loss_rel", "grad_norm_rel",
                            "leaf_max_rel", "noise_leaves",
                            "step_loss_rel")})


def train_restart(device="cuda") -> dict:
    """``run_with_restarts`` on the card at ``tests/test_fault_tolerance
    .py``'s settings (qwen2 ``reduced()``, f32, ``TRAIN_RESTART``): 2
    restarts, resumed from ``[3, 6]``, losses equal to the uninterrupted
    run at ``TRAIN_RESTART_RTOL``; then the newest checkpoint corrupted:
    ``restore_latest`` must return the one before it."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import DataConfig, SyntheticTokens
    from repro_torch.train.fault import run_with_restarts
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import make_train_step
    cfg = get_config("qwen2-0.5b").reduced()
    r = TRAIN_RESTART
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      global_batch=r["batch"],
                                      seq_len=r["seq_len"]))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), torch.float32,
                           device=device)
    cpu = T.init_lm(cfg, LM_SEED, device="cpu")

    def init_state():
        params = _lm_to(cpu, device)
        return {"params": params, "opt": init_opt_state(params),
                "loss": torch.zeros((), device=device)}

    def step_fn(state, i):
        p, o, m = step(state["params"], state["opt"], data.batch_at(i))
        return {"params": p, "opt": o, "loss": m["loss"]}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    try:
        runs = {}
        t0 = time.perf_counter()
        for name, fail_at in (("clean", ()), ("faulty", r["fail_at"])):
            ckpt = CheckpointManager(os.path.join(tmp, name), keep=2)
            runs[name] = run_with_restarts(
                init_state, step_fn, lambda s: float(s["loss"]), ckpt,
                r["total"], save_every=r["save_every"], fail_at=fail_at)
        seconds = time.perf_counter() - t0
        clean, faulty = runs["clean"], runs["faulty"]
        gap = float(np.max(np.abs(np.subtract(clean.losses, faulty.losses))
                           / np.abs(clean.losses)))
        if faulty.restarts != 2 or faulty.resumed_from != [3, 6] \
                or not gap <= TRAIN_RESTART_RTOL:
            raise AssertionError(f"train restart: {faulty}, clean "
                                 f"{clean.losses}, gap {gap}")
        steps = ckpt.available_steps()
        npz, _ = ckpt._paths(steps[-1])
        with open(npz, "r+b") as f:      # as the reference's test does
            f.seek(200)
            f.write(b"\xde\xad\xbe\xef" * 8)
        restored = ckpt.restore_latest(init_state())
        if restored is None or restored[0] != steps[-2]:
            raise AssertionError(f"train restart: the corrupt checkpoint "
                                 f"{steps[-1]} not skipped: "
                                 f"{restored and restored[0]}")
        on_card = restored[1]["params"]["embed"].device.type == "cuda"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(restarts=faulty.restarts, resumed_from=faulty.resumed_from,
                losses=clean.losses, max_rel_gap=gap, seconds=seconds,
                corrupt_skipped=f"{steps[-1]} -> {restored[0]}",
                restored_on_card=on_card)


def _door_cmd(name: str, argv: list) -> list:
    return [sys.executable, str(ROOT / "chip_smoke.py"), DOOR_FLAG, name,
            *argv]


def train_phase() -> dict:
    """LM training on the card (no AMG kernel on it): qwen2-0.5b at its
    full config and falcon-mamba-7b at full width and
    ``TRAIN_MAMBA_LAYERS`` layers, every arch at ``reduced()`` card
    against CPU, the restart run, and ``python -m repro_torch.train_lm``
    (``TRAIN_LM_STEPS[0]`` steps, then resumed to ``[1]`` in the same
    directory) and ``python -m repro_torch.launch.train`` as
    ``--front-door`` children, the latter's first loss against the same
    twin on the CPU.  The launch counts are set to 0 before it and read
    after: every one must still be 0.  Returns them."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch import train as launch_train
    reset_counts()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    print("train full " + json.dumps(train_full_qwen2()))
    print("train full " + json.dumps(train_full_mamba()))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    lm_argv = ["--ckpt-dir", tmp]
    launch_argv = ["--arch", "qwen2-0.5b", "--steps",
                   str(TRAIN_LAUNCH_STEPS)]
    try:
        cmds = {"train_lm": _door_cmd("train_lm", ["--steps", str(
                    TRAIN_LM_STEPS[0])] + lm_argv),
                "launch.train": _door_cmd("launch.train", launch_argv)}
        with Children(cmds) as kids:
            for arch in ARCH_IDS:
                print(f"train reduced {arch} card vs cpu "
                      + json.dumps(train_reduced(arch)))
            print("train restart " + json.dumps(train_restart()))
            with contextlib.redirect_stdout(open(os.devnull, "w")):
                cpu = launch_train.main(launch_argv + ["--device", "cpu"])
            done, secs = kids.wait(DOORS_TIMEOUT_S)
        first, launches = _door_run("train_lm", done["train_lm"])
        lres, llaunch = _door_run("launch.train", done["launch.train"])
        cmd = {"train_lm": _door_cmd("train_lm", ["--steps", str(
            TRAIN_LM_STEPS[1])] + lm_argv)}
        with Children(cmd) as kids:
            done2, secs2 = kids.wait(DOORS_TIMEOUT_S)
        second, launches2 = _door_run("train_lm", done2["train_lm"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resumed = f"resumed from step {TRAIN_LM_STEPS[0]}" in \
        done2["train_lm"].stdout.splitlines()
    bad = {}
    if first["device"] == "cpu" or not _falls(first["losses"]):
        bad["first"] = (first["device"], first["losses"])
    if not resumed or second["start"] != TRAIN_LM_STEPS[0] \
            or len(second["losses"]) != TRAIN_LM_STEPS[1] - TRAIN_LM_STEPS[0]:
        bad["second"] = (second["start"], len(second["losses"]))
    if any(launches.values()) or any(launches2.values()):
        bad["launches"] = (launches, launches2)
    if bad:
        raise AssertionError(f"train train_lm: {bad}")
    print("train train_lm " + json.dumps(dict(
        device=first["device"], model=first["model"],
        params=first["params"], steps=TRAIN_LM_STEPS,
        loss_first_last=[first["losses"][0], first["losses"][-1],
                         second["losses"][-1]],
        resumed_from=second["start"], tok_per_s=[first["tok_per_s"],
                                                 second["tok_per_s"]],
        tok_per_s_after_first=[first["tok_per_s_after_first"],
                               second["tok_per_s_after_first"]],
        loop_s=[first["seconds"], second["seconds"]],
        first_step_s=[first["first_step_s"], second["first_step_s"]],
        child_s=[secs["train_lm"], secs2["train_lm"]],
        launches=launches)))
    gap = _rel(torch.tensor(lres["losses"][0]),
               torch.tensor(cpu["losses"][0]))
    if lres["device"] == "cpu" or not gap <= TRAIN_TOL["loss"] \
            or not np.isfinite(lres["losses"]).all() \
            or any(llaunch.values()):
        raise AssertionError(f"train launch: {lres}, cpu {cpu['losses']}, "
                             f"gap {gap}, {llaunch}")
    print("train launch " + json.dumps(dict(
        device=lres["device"], devices=lres["devices"],
        losses=lres["losses"], cpu_losses=cpu["losses"],
        first_loss_rel=gap, step_ms=lres["step_ms"],
        child_s=secs["launch.train"], launches=llaunch)))
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"train phase launched AMG kernels: {counts}")
    print("train phase " + json.dumps(dict(
        seconds=time.perf_counter() - t0, allocated_before=held,
        launches=counts)))
    return counts

#: the launch phase: ``python -m repro_torch.launch.dryrun`` for the two
#: archs the LM phases run, every shape on every mesh, qwen2's depth
#: probes, the roofline and the AMG rows
LAUNCH_ARCHS = ("qwen2-0.5b", "falcon-mamba-7b")
LAUNCH_MESHES = ("single", "multi", "card")
LAUNCH_TIMEOUT_S = 600
#: the AMG rows' grid (``run_amg_dryrun``'s default, the reference's)
LAUNCH_AMG_M = 21
#: what the AMG card row (the dist hot path at world 1) must launch
LAUNCH_KERNELS = ("block_spmv", "fused_smoother", "block_pair_gemm",
                  "block_seg_sum")
PROBE_REL = 1e-9


def _launch_results() -> dict:
    from repro_torch.launch import dryrun
    with open(dryrun.RESULTS_PATH) as f:
        return json.load(f)


def _launch_child(label: str, argv: list, name: str = "launch.dryrun"
                  ) -> tuple:
    """One launch CLI as a ``--front-door`` child: its JSON line, its
    launches and its seconds."""
    with Children({label: _door_cmd(name, argv)}) as kids:
        done, secs = kids.wait(LAUNCH_TIMEOUT_S)
    res, launches = _door_run(label, done[label])
    return res, launches, secs[label], done[label].stdout


def _check_lm_rows(results: dict) -> list:
    """Every LM row of ``LAUNCH_ARCHS``: OK, or a SKIP with
    ``cell_applicable``'s reason or, on the card, "exceeds one card"; a
    card row that ran has its ms and peak beside the estimate; each full
    row's FLOPs equal its mesh's probe-corrected count (qwen2)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import roofline
    from repro_torch.models.config import LM_SHAPES, cell_applicable
    lines, bad = [], []
    for arch in LAUNCH_ARCHS:
        cfg = get_config(arch)
        for shape in LM_SHAPES:
            ok, why = cell_applicable(cfg, shape)
            for mesh in LAUNCH_MESHES:
                key = f"{arch}|{shape.name}|{mesh}|base"
                rec = results.get(key, {"status": "MISSING"})
                st = rec["status"]
                line = dict(key=key, status=st)
                if st == "SKIP":
                    line.update(reason=rec["reason"])
                    if rec["reason"] != why and not (
                            ok and mesh == "card"
                            and rec["reason"] == "exceeds one card"):
                        bad.append((key, rec["reason"]))
                elif st == "OK" and ok:
                    m = rec["memory"]
                    line.update(
                        flops_per_device=rec["cost"]["flops_per_device"],
                        bytes_per_device=rec["cost"][
                            "bytes_accessed_per_device"],
                        argument_bytes=m["argument_bytes"],
                        peak_bytes=m["peak_bytes"],
                        peak_is_lower_bound=m["peak_is_lower_bound"],
                        trace_s=rec["trace_s"], aten_ops=rec["aten_ops"],
                        extrapolated_from_depths=rec.get(
                            "extrapolated_from_depths"))
                    if mesh == "card":
                        run = rec.get("measured", {})
                        line.update(card=rec.get("card"), ms=run.get("ms"),
                                    ms_all=run.get("ms_all"),
                                    peak_measured_bytes=m.get(
                                        "peak_measured_bytes"),
                                    peak_estimate_bytes=m.get(
                                        "peak_estimate_bytes"))
                        if not run.get("ms") or not m.get(
                                "peak_measured_bytes"):
                            bad.append((key, "card row without ms/peak"))
                    probes = [results.get(f"{arch}|{shape.name}|{mesh}|"
                                          f"probe-d{d}") for d in (1, 2)]
                    if all(p and p["status"] == "OK" for p in probes):
                        full = rec["cost"]["flops_per_device"]
                        corr = roofline._loop_corrected(
                            full, *(p["cost"]["flops_per_device"]
                                    for p in probes),
                            roofline._n_units(arch))
                        line["probe_rel"] = abs(corr - full) / full
                        if not line["probe_rel"] <= PROBE_REL:
                            bad.append((key, "probe", corr, full))
                    elif arch == LAUNCH_ARCHS[0]:
                        bad.append((key, "no probes"))
                else:
                    bad.append((key, st, rec.get("error")))
                lines.append(line)
    if bad:
        raise AssertionError(f"launch rows: {bad}")
    return lines


def launch_phase(card: str) -> tuple:
    """The launch layer on the card (``repro_torch.launch``): ``python -m
    repro_torch.launch.dryrun`` for ``LAUNCH_ARCHS`` over every shape on
    the ``single``, ``multi`` and ``card`` meshes, ``--probe`` for qwen2,
    ``--amg`` at ``LAUNCH_AMG_M`` with its launches held against the plain
    versions (``KernelCheck``), then ``python -m
    repro_torch.launch.roofline``, each a ``--front-door`` child with its
    launches counted and every row of this run (``--force``): the LM dry
    runs and the roofline must launch none of the seven kernels, the AMG
    rows (whose card row runs the dist hot path at NCCL world 1) every
    one of ``LAUNCH_KERNELS``.  Prints a ``launch`` line a row; fails on
    any FAIL record, a card row whose iterations differ from the
    single-device solve's or whose true residual (the plain CPU product)
    is above the solve's tolerance, a kernel that disagrees with its plain
    version, or a probe-corrected FLOP count more than ``PROBE_REL`` off
    the full trace's.  Returns the AMG rows' launches and the kernel
    checks' largest errors."""
    from repro_torch.launch import dryrun_amg
    t0 = time.perf_counter()
    lm_launches = {}
    runs = [("qwen2-0.5b", ["--arch", "qwen2-0.5b", "--force"]),
            ("qwen2-0.5b probe", ["--arch", "qwen2-0.5b", "--probe",
                                  "--force"]),
            ("falcon-mamba-7b", ["--arch", "falcon-mamba-7b", "--force"])]
    for label, argv in runs:
        res, lm_launches[label], child_s, _ = _launch_child(label, argv)
        print(f"launch dryrun {label} " + json.dumps(dict(
            rows=res["rows"], failures=res["failures"], child_s=child_s,
            launches=lm_launches[label])))
    amg, launches, amg_s, amg_out = _launch_child(
        "amg", [KERNEL_CHECK_FLAG, "--amg", "--force"])
    per = {}
    for ln in amg_out.splitlines():
        if ln.startswith("door kernel check "):
            row = json.loads(ln[len("door kernel check "):])
            per[row["kernel"]] = row
            print("launch kernel check " + json.dumps(row))
    roof, lm_launches["roofline"], roof_s, roof_out = _launch_child(
        "roofline", [], name="launch.roofline")
    for ln in roof_out.splitlines():
        if ln.startswith(("constants:", "| ", "  ")):
            print("launch roofline " + ln)
    results = _launch_results()
    for line in _check_lm_rows(results):
        print("launch " + json.dumps(line))
    amg_rows = {}
    for mesh in ("single", "multi", "card"):
        key = f"amg-elasticity-q1-m{LAUNCH_AMG_M}|solve|{mesh}|base"
        rec = results.get(key, {"status": "MISSING"})
        if rec["status"] != "OK":
            raise AssertionError(f"launch {key}: {rec}")
        amg_rows[mesh] = rec
        line = {k: rec[k] for k in ("grid", "halo_strategy", "placement",
                                    "n_devices", "stage_s", "iters",
                                    "single_device_iters", "x_rel_diff",
                                    "relres", "true_relres", "backend",
                                    "card")
                if k in rec}
        line.update(key=key, argument_bytes=rec["memory"].get(
            "argument_bytes"), peak_measured_bytes=rec["memory"].get(
            "peak_measured_bytes"), ms=rec.get("measured", {}).get("ms"))
        if rec.get("collectives"):
            line.update(cycle_msgs=rec["collectives"]["msgs"],
                        cycle_bytes=rec["collectives"]["total_bytes"])
        print("launch " + json.dumps(line))
    crow = amg_rows["card"]
    if crow["iters"] != crow["single_device_iters"] or not crow[
            "converged"] or not crow["x_rel_diff"] <= DIST_TOL \
            or not crow["true_relres"] <= dryrun_amg.RTOL:
        raise AssertionError(f"launch AMG card row: {crow}")
    unchecked = [k for k, n in launches.items() if n and k not in per]
    if unchecked:
        raise AssertionError(f"launch: no kernel check of {unchecked}")
    if any(v for counts in lm_launches.values() for v in counts.values()):
        raise AssertionError(f"launch: LM rows launched AMG kernels: "
                             f"{lm_launches}")
    check_path_launches("launch", launches, LAUNCH_KERNELS)
    print("launch phase " + json.dumps(dict(
        card=card, seconds=time.perf_counter() - t0, amg_child_s=amg_s,
        roofline_child_s=roof_s, roofline_rows=roof["rows"],
        launches=launches)))
    return launches, per


def card_line() -> str:
    """The card's name and power limit (``nvidia-smi``); raises without
    them."""
    from repro_torch.launch.dryrun import card_line as line
    out = line()
    if out is None:
        raise RuntimeError("chip_smoke: nvidia-smi gave no card line")
    return out


def peaks_for(name: str) -> tuple:
    """The datasheet peaks; another card has other peaks, so it raises."""
    if CARD not in name:
        raise RuntimeError(f"chip_smoke: bounds are for the {CARD} "
                           f"({PEAKS[0] / 1e12} TB/s, {PEAKS[1] / 1e12} "
                           f"TFLOP/s fp64); this card is {name!r}")
    return PEAKS


def kernel_record(per: dict, by_path: dict, per_step: dict,
                  peaks: tuple, precision: dict, scalar: tuple) -> dict:
    """The per-kernel JSON record: launches summed over the paths (and per
    path), the largest error against the plain version, and times summed
    over the cases; the f64 instantiation of each kernel under its name,
    the f32 and bf16 ones under ``<name>_f32`` / ``<name>_bf16`` with the
    precision path's launches and cases at that dtype (``precision``:
    ``{prec: (launches, per, per_hot_step)}``), and the scalar baseline's
    1x1 and scalar-row entries under their ``SCALAR_KERNELS`` names with
    the scalar path's launches of that entry and its cases (``scalar``:
    ``(launches by entry, launches per scalar hot step, per)``).  A
    family's ``scalar`` column (``by_path["scalar"]``) counts only its
    blocked instantiations on the scalar path."""
    record = []
    rows = [(kname, kname, "f64", per[kname], by_path, per_step)
            for kname in KERNELS]
    for prec, (launches, pper, pstep) in precision.items():
        rows += [(f"{kname}_{prec}", kname, prec, pper[kname],
                  {"precision": launches}, {"hot_step": pstep})
                 for kname in KERNELS]
    s_launches, s_step, s_per = scalar
    rows += [(rec, fam, "f64", s_per[rec], {"scalar": s_launches},
              {"scalar_hot_step": s_step})
             for rec, (fam, _) in SCALAR_KERNELS.items()]
    for name, kname, dt, row, paths, steps in rows:
        meta = KERNELS[kname]
        if row["cases"] == 0:
            raise AssertionError(f"{name}: no case checked")
        flops = peaks[1] if dt == "f64" else F32_FLOPS
        by_bytes = row["bytes"] / peaks[0] >= row["flops"] / flops
        key = name if name in SCALAR_KERNELS else kname
        record.append(dict(
            name=name, dtype=dt,
            route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(p[key] for p in paths.values()),
            launches_by_path={path: p[key] for path, p in paths.items()},
            launches_per_hot_step=sum(v[key] for v in steps.values()),
            cases=row["cases"], max_abs_err=row["max_abs_err"],
            max_rel_err=row["max_rel_err"], ms=row["ms"],
            kernel_ms=row["ms"], ms_single=row["ms_single"],
            plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], floor_ms=row["floor_ms"],
            bound_by="bytes" if by_bytes else "operations",
            library_ms=row["library_ms"] if row["library_all"] else None))
    return {"kernels": record}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    args = sys.argv[1:]
    child = PROFILE_FLAG in args
    tune_dir = None
    # a profile witness reads its parent's tune cache (inherited)
    if not (child and os.environ.get("REPRO_TORCH_TUNE_CACHE")):
        tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
        os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(tune_dir) /
                                                   "autotune.json")
    try:
        if child:
            return profile_witness(json.loads(
                args[args.index(PROFILE_FLAG) + 1]))
        with tune_mode("off"):
            if DOOR_FLAG in args:
                i = args.index(DOOR_FLAG)
                return front_door_child(args[i + 1], args[i + 2:])
            return h2d_witness() if H2D_FLAG in args else run_all()
    finally:
        if tune_dir is not None:
            shutil.rmtree(tune_dir, ignore_errors=True)


def run_all() -> int:
    import torch

    from repro_torch.kernels import autotune, backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name}")
    peaks = peaks_for(name)

    t0 = time.perf_counter()
    so = backend.build_library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s -> {so.name}")
    log = Path(str(so) + ".log")
    if log.exists():
        for ln in log.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print("ptxas " + ln.strip())

    reset_counts()
    with SignatureLog() as sigs:
        run = main_path(MAIN_M, "cuda")
        by_path = {"main": read_counts()}
        check_main_path(run)
        per_step = run["records"][-1]["launches"]
        print("main path launches " + json.dumps(by_path["main"]))
        print("launches per hot step " + json.dumps(per_step))
        print("coarse operators " + json.dumps(check_fingerprint(run)))
        hot = profile_hot_step(run)

        by_path["serve"] = serve_path(run, "cuda", EXPECT_ITERS)
    check_path_launches("serve", by_path["serve"],
                        ("block_spmm", "fused_smoother", "block_spmv"))
    by_path["pairs"] = pairs_path(run, "cuda", EXPECT_ITERS)
    check_path_launches("pairs", by_path["pairs"],
                        ("block_pair_gemm", "block_seg_sum"))
    by_path["stored"], run["r_ells"] = stored_path(run)
    obs_phase(run, hot)
    by_path["scalar"], s_launches, s_step, s_per = scalar_path(run, peaks)

    print("bitwise per column " + json.dumps(
        check_bitwise(run, "cuda", extra_ells=run["r_ells"])))
    print(f"datasheet peaks: {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.1f} TFLOP/s fp64; measured copy_ "
          f"{copy_bandwidth() / 1e12:.3f} TB/s")
    cases = build_cases(run, "cuda", extra_ells=run["r_ells"])
    attach_floors(cases)
    per = check_kernels(cases, peaks)
    lanes_sweep(cases)

    by_path["tune"], _ = tune_path(run, sigs.seen, "cuda")
    check_path_launches("tune", by_path["tune"], TUNED)
    print("threads bitwise " + json.dumps(check_threads_bitwise(cases)))
    rows = tuned_vs_static_kernels(cases)
    slower = [r for r in rows if r["beyond_margin"]]
    print("tune winners slower than 256 beyond the margin " + json.dumps(
        dict(margin=autotune.EVENT_MARGIN, count=len(slower), of=len(rows),
             cases=[f"{r['kernel']} {r['case']}" for r in slower])))
    pbjacobi_phase(cases, peaks)
    del cases           # the m=32 case operands; nothing below reads them
    print("tune resolve host us per call "
          + json.dumps(resolve_cost_us(run)))
    tuned_vs_static_steps(run, "cuda", EXPECT_ITERS)
    with tune_mode("cache"):
        profile_hot_step(run, label="tuned ")

    check = cpu_vs_cuda(CHECK_M, CHECK_COARSE)
    check["heterogeneous"] = hetero_cpu_vs_cuda()
    print("cpu vs cuda " + json.dumps(check))
    print(f"m={MAIN_M} aggregates card vs cpu "
          + json.dumps(aggregates_vs_cpu(run)))

    by_path["mis"], mis_per = mis_path()
    check_path_launches("mis", by_path["mis"], MAIN_KERNELS)
    by_path["coeff"], coeff_per = coefficient_path()
    check_path_launches("coeff", by_path["coeff"], MAIN_KERNELS)
    by_path["march"], march_per = march_phase()
    check_path_launches("march", by_path["march"], MAIN_KERNELS)
    print("march cpu vs cuda " + json.dumps(march_cpu_vs_cuda()))
    for other in (mis_per, coeff_per, march_per):
        fold_errors(per, other)
    print("coefficient h2d " + json.dumps(h2d_check()))
    by_path["robust"] = robust_path(run)
    check_path_launches("robust", by_path["robust"],
                        MAIN_KERNELS + ("block_spmm", "block_pair_gemm"))
    print("quickstart " + json.dumps(quickstart_phase()))

    precision = {prec: precision_path(prec, run, peaks)
                 for prec in PRECISIONS}
    # the dist path's rank processes share the card with this one: hand
    # back what the caching allocator holds
    gc.collect()
    torch.cuda.empty_cache()
    print("dist path parent memory " + json.dumps(dict(
        allocated=torch.cuda.memory_allocated(),
        reserved=torch.cuda.memory_reserved())))
    by_path["dist"] = dist_path()
    by_path["doors"] = front_doors_phase()
    gc.collect()
    torch.cuda.empty_cache()
    by_path["lm"] = lm_phase()
    gc.collect()
    torch.cuda.empty_cache()
    by_path["train"] = train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    by_path["launch"], launch_per = launch_phase(card_line())
    fold_errors(per, launch_per)

    print(json.dumps(kernel_record(per, by_path, per_step, peaks,
                                   precision, (s_launches, s_step, s_per))))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
