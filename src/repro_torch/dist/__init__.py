"""Distributed (multi-process) AMG path — PETSc-style row-slab
decomposition on ``torch.distributed`` (torch twin of ``repro.dist``).

``partition``   process meshes and balanced contiguous block-row slabs
                (``ProcessMesh``, ``RowPartition``).
``comm``        ``RankComm``: the reference's ``shard_map`` collectives as
                one process per rank — neighbour exchanges in flight,
                all-gathers, reductions summed in rank order (the same
                bits on every rank); gloo stages CUDA payloads through
                host memory, so several ranks can share one card.
``pamg``        distributed blocked operators: slab halo exchange
                (blocking, or split into start/finish around the interior
                rows), the slab SpMV on ``block_spmv`` / ``block_spmm``
                with a build-time interior/boundary row split, and the
                distributed PtAP stages on ``block_pair_gemm`` +
                ``block_seg_sum`` with the off-process prolongator operand
                (P_oth) cached per rank.
``solver``      ``build_dist_gamg`` / ``make_dist_solver``: the hot path
                of one rank (numeric hierarchy recompute + AMG-PCG, the
                panel solve and the warm start), with per-level placement
                (fine levels slab-sharded, coarse levels agglomerated into
                a replicated tail below ``coarse_eq_limit`` equations per
                rank) and the ``REPRO_TORCH_OVERLAP`` halo schedule.
``measure``     messages and bytes of one V-cycle, counted by
                ``RankComm`` and held against
                ``repro_torch.obs.model.dist_cycle_comm``.
``selftest``    ``python -m repro_torch.dist.selftest <m> --world N``:
                spawned ranks held against the single-device solve.
"""
