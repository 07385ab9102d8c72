"""The port's dry run (``repro_torch.launch.dryrun``) and distributed-AMG
rows (``repro_torch.launch.dryrun_amg``) on the CPU.

``collective_census`` is bitwise the reference's on hand-written HLO.  The
traces run on the meta device at ``reduced()`` configs: SKIP reasons are
``cell_applicable``'s (the reference's too), FLOPs are
``FlopCounterMode``'s, and the depth-1/2 probes corrected as the roofline
corrects them give back the full trace's FLOPs and bytes; a trace taken
at depths 1 and 2 and extrapolated gives back the whole trace's counts
(its peak at most the whole trace's).  A ``card`` row runs on the CPU
against a given capacity or is a SKIP.  The AMG staging
rows at small m, on the reference's setup carried across, give the
reference's grid, halo strategy, placement and per-rank bytes (the port
stages a stage's segment offsets where the reference stages its segment
ids: those leaves are held to their own sizes), and the world-1 hot path
takes the single-device iterations, its solution's true residual
within the solve's tolerance.  Full-config traces, production rank
counts and the reference's 512 placeholder devices are ``slow``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on, as the reference's AMG)
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.dist import solver as ref_solver  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.models.config import LM_SHAPES  # noqa: E402
from repro.models.config import cell_applicable as ref_applicable  # noqa

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import gamg  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import setup_from_numpy  # noqa: E402
from repro_torch.launch import dryrun, dryrun_amg, roofline  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import data_axes, make_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ShapeSpec, cell_applicable  # noqa
from repro_torch.models.sharding import axis_env  # noqa: E402

from torch_helpers import setup_to_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the LM shapes' names and kinds at a CPU size (the name decides
#: ``cell_applicable``)
SMALL = [ShapeSpec("train_4k", 16, 4, "train"),
         ShapeSpec("prefill_32k", 32, 2, "prefill"),
         ShapeSpec("decode_32k", 32, 4, "decode"),
         ShapeSpec("long_500k", 64, 1, "decode")]


def _ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512
    placeholder devices: the variable is put back as it was."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _reduced(arch: str, layers: int = 2):
    """``reduced()`` at ``layers`` layers (an interleaved MoE keeps its
    pairs; an encoder as deep as the decoder)."""
    cfg = get_config(arch).reduced()
    kw = {"n_layers": layers}
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec,
                                           n_encoder_layers=layers)
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# collective_census
# ---------------------------------------------------------------------------

HLO = {
    "every kind": """
  %ag = f32[16,128]{1,0} all-gather(f32[1,128]{1,0} %x), dimensions={0}
  %ar = bf16[1024]{0} all-reduce(bf16[1024]{0} %y), to_apply=%sum
  %rs = f32[64]{0} reduce-scatter(f32[1024]{0} %z), dimensions={0}
  %a2a = s32[4,4]{1,0} all-to-all(s32[4,4]{1,0} %w), dimensions={0}
  %cp = u8[100]{0} collective-permute(u8[100]{0} %v), source_target_pairs={{0,1}}
""",
    "async pairs": """
  %ars = (f32[8,8]{1,0}, f32[8,8]{1,0}) all-reduce-start(f32[8,8]{1,0} %a), to_apply=%sum
  %ard = f32[8,8]{1,0} all-reduce-done((f32[8,8]{1,0}, f32[8,8]{1,0}) %ars)
  %cps = (f32[10]{0}, f32[10]{0}, u32[], u32[]) collective-permute-start(f32[10]{0} %b)
  %cpd = f32[10]{0} collective-permute-done((f32[10]{0}, f32[10]{0}, u32[], u32[]) %cps)
  %ags = (bf16[2,4]{1,0}, bf16[32,4]{1,0}) all-gather-start(bf16[2,4]{1,0} %c)
  %agd = bf16[32,4]{1,0} all-gather-done((bf16[2,4]{1,0}, bf16[32,4]{1,0}) %ags)
""",
    "tuple results": """
  %t = (f64[3,3]{1,0}, s64[7]{0}, pred[5]{0}) all-reduce(f64[3,3]{1,0} %p, s64[7]{0} %q, pred[5]{0} %r)
  %u = (c64[2]{0}, c128[2]{0}) all-to-all(c64[2]{0} %s, c128[2]{0} %t2)
""",
    "unknown dtype": """
  %k = f8e4m3fn[32]{0} all-reduce(f8e4m3fn[32]{0} %f), to_apply=%sum
  %tok = token[] all-gather(token[] %g)
  %mix = (f8e5m2[4]{0}, f16[4]{0}, s16[2]{0}, u16[2]{0}, s8[3]{0}) all-to-all(f16[4]{0} %h)
""",
    "no collectives": """
  %d = f32[128,128]{1,0} dot(f32[128,64]{1,0} %x, f32[64,128]{1,0} %y)
  ROOT %t = (f32[128,128]{1,0}) tuple(%d)
""",
}


@pytest.mark.parametrize("name", sorted(HLO))
def test_collective_census_is_the_references(name):
    ref = _ref_dryrun()
    got = dryrun.collective_census(HLO[name])
    assert json.dumps(got, sort_keys=True) == json.dumps(
        ref.collective_census(HLO[name]), sort_keys=True)
    if name != "no collectives":
        assert got["total_bytes"] > 0


# ---------------------------------------------------------------------------
# traces (meta device, reduced configs)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skip_reasons_are_cell_applicables(arch):
    """A shape the arch does not take is a SKIP with ``cell_applicable``'s
    reason (the reference's) on every mesh; a card row over its capacity
    is a SKIP, "exceeds one card"."""
    cfg = _reduced(arch)
    for shape in SMALL:
        ok, why = cell_applicable(cfg, shape)
        assert (ok, why) == ref_applicable(ref_config(arch).reduced(),
                                           shape)
        if ok:
            continue
        for mesh_name in ("single", "multi", "card"):
            assert dryrun.cell_record(cfg, shape, mesh_name, device="cpu") \
                == {"status": "SKIP", "reason": why}
    traces = {}
    rec = dryrun.cell_record(cfg, SMALL[2], "single", traces=traces)
    assert rec["status"] == "OK" and rec["cost"]["flops_per_device"] > 0
    rec = dryrun.cell_record(cfg, SMALL[2], "card", device="cpu",
                             traces=traces, capacity_bytes=1)
    assert rec["status"] == "SKIP" and rec["reason"] == "exceeds one card"
    assert rec["memory"]["peak_estimate_bytes"] > rec["memory"][
        "capacity_bytes"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_corrected_counts_equal_the_full_trace(arch):
    """outside + units * body from the depth-1/2 probes is the full
    trace's count: the trace runs every layer."""
    cfg = _reduced(arch, layers=4)
    per = 2 if (cfg.moe and cfg.moe.moe_every == 2) else 1
    units = cfg.n_layers // per
    for shape in SMALL[:1]:
        recs = [dryrun.cell_record(c, shape, "single")
                for c in (cfg, dryrun._probe_config(cfg, 1),
                          dryrun._probe_config(cfg, 2))]
        for key in ("flops_per_device", "bytes_accessed_per_device"):
            full, d1, d2 = (r["cost"][key] for r in recs)
            got = roofline._loop_corrected(full, d1, d2, units)
            assert abs(got - full) <= 1e-9 * full, (shape.name, key)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_extrapolated_trace_is_the_whole_trace(arch, monkeypatch):
    """Four units traced at depths 1 and 2 and extrapolated: FLOPs, bytes,
    aten ops and output bytes are the whole trace's; the live-bytes peak
    is at most the whole trace's (a unit's live set grows with depth under
    the checkpoints), so an extrapolated SKIP stands."""
    cfg = dryrun._probe_config(get_config(arch).reduced(), 4)
    mesh = make_mesh("single")
    monkeypatch.setattr(dryrun, "TRACE_OPS_LIMIT", 0)
    for shape in (SMALL[0], SMALL[2]):
        if not cell_applicable(cfg, shape)[0]:
            continue
        whole = dryrun._trace_once(cfg, shape, mesh)
        ext = dryrun.trace_cell(cfg, shape, mesh)
        assert ext["depths"] == [1, 2] and ext["out"] is None
        for key in ("flops", "bytes", "ops", "output_bytes"):
            assert ext[key] == whole[key], (shape.name, key)
        assert ext["peak_live_bytes"] <= whole["peak_live_bytes"]


def test_an_extrapolated_card_row_is_traced_whole_before_it_runs(
        monkeypatch):
    cfg = dryrun._probe_config(get_config("qwen2-0.5b").reduced(), 4)
    monkeypatch.setattr(dryrun, "TRACE_OPS_LIMIT", 0)
    monkeypatch.setattr(dryrun, "CARD_REPS", 1)
    whole = dryrun._trace_once(cfg, SMALL[0], make_mesh("card"))
    rec = dryrun.cell_record(cfg, SMALL[0], "card", device="cpu",
                             capacity_bytes=1 << 34)
    assert rec["status"] == "OK" and rec["extrapolated_from_depths"] == [1, 2]
    assert rec["aten_ops"] == whole["ops"]
    assert rec["memory"]["peak_estimate_bytes"] == whole["peak_live_bytes"]
    skip = dryrun.cell_record(cfg, SMALL[0], "card", device="cpu",
                              capacity_bytes=1)
    assert skip["status"] == "SKIP" and skip["memory"][
        "peak_estimate_bytes"] < whole["peak_live_bytes"]


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-0.5b", SMALL[0]), ("llama4-maverick-400b-a17b", SMALL[1]),
    ("whisper-small", SMALL[2]), ("falcon-mamba-7b", SMALL[0])])
def test_trace_flops_are_flop_counter_modes(arch, shape):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = _reduced(arch)
    mesh = make_mesh("single")
    cell = S.build_cell(cfg, shape, mesh)
    got = dryrun.trace_cell(cfg, shape, mesh, cell)
    with axis_env(data_axes(mesh), "model", mesh.shape), \
            FlopCounterMode(display=False) as fc:
        args = tuple(T.tree_map(lambda a: torch.empty(
            a.shape, dtype=a.dtype, device="meta"), t)
            if isinstance(t, dict) else torch.empty(
                t.shape, dtype=t.dtype, device="meta") for t in cell.args)
        dryrun._step(cfg, cell.kind, "meta")(*args)
    assert got["flops"] == fc.get_total_flops() > 0


def test_meta_is_an_entry_device_and_the_kernels_refuse_it():
    from repro_torch.kernels import backend
    from repro_torch.kernels.block_spmv import ops as spmv_ops
    assert backend.resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        backend.resolve_device("mps")
    meta = torch.empty((4, 2, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        spmv_ops.block_spmv_ell(torch.zeros((4, 2), dtype=torch.int32,
                                            device="meta"), meta,
                                torch.empty((1, 3), dtype=torch.float64,
                                            device="meta"))


def test_op_bytes_moves_only_what_an_op_touches():
    aten = torch.ops.aten
    x = torch.empty((64, 32), dtype=torch.float32, device="meta")   # 8 KiB
    idx = torch.zeros((4,), dtype=torch.int64, device="meta")
    rows = torch.empty((4, 32), dtype=torch.float32, device="meta")
    ob = dryrun.op_bytes
    assert ob(aten.t.default, (x,), {}, x.t()) == 0                # a view
    assert ob(aten.empty.memory_format, ((3,),), {}, x) == 0
    y = x * 2
    assert ob(aten.mul.Tensor, (x, 2), {}, y) == 2 * 8192
    assert ob(aten.index_select.default, (x, 0, idx), {}, rows) == \
        32 + 2 * 512
    assert ob(aten.index_copy_.default, (x, 0, idx, rows), {}, x) == \
        32 + 2 * 512
    assert ob(aten.copy_.default, (x, y), {}, x) == 2 * 8192
    assert ob(aten.add_.Tensor, (x, y), {}, x) == 3 * 8192


def test_live_bytes_follow_storages():
    tr = dryrun._Trace()
    with tr:
        a = torch.empty((1000,), dtype=torch.float32, device="meta")
        b = a + 1
        v = b[:10]          # a view: no new storage
        del a
        c = b * 2
        del b, c, v
    assert tr.peak == 8000 and tr.live == 0
    assert tr.ops >= 3 and tr.flops == 0 and tr.bytes > 0


def test_records_hold_the_reference_fields():
    cfg = _reduced("qwen2-0.5b")
    traces = {}
    single = dryrun.cell_record(cfg, SMALL[2], "single", traces=traces)
    multi = dryrun.cell_record(cfg, SMALL[2], "multi", traces=traces)
    for rec, mesh_name in ((single, "single"), (multi, "multi")):
        mesh = make_mesh(mesh_name)
        assert rec["n_devices"] == mesh.size
        assert rec["mesh"] == list(mesh.axis_sizes)
        m = rec["memory"]
        cell = S.build_cell(cfg, SMALL[2], mesh)
        assert m["alias_bytes"] == S.tree_shard_bytes(
            cell.args[1], cell.in_shardings[1], mesh) > 0
        assert m["argument_bytes"] == S.tree_shard_bytes(
            cell.args, cell.in_shardings, mesh)
        assert m["peak_bytes"] == m["argument_bytes"] + m["output_bytes"] \
            - m["alias_bytes"]
        assert m["peak_is_lower_bound"] and m["temp_bytes"] is None
        assert rec["collectives"] is None
    # one program for both meshes: the same totals
    assert single["cost"]["flops_per_device"] * 256 == \
        multi["cost"]["flops_per_device"] * 512
    train = dryrun.cell_record(cfg, SMALL[0], "single")
    assert train["memory"]["alias_bytes"] == 0
    # params, both moments and the step out, as the reference's outputs
    assert train["memory"]["output_bytes"] == train["memory"][
        "argument_bytes"] - S.tree_shard_bytes(
        S.build_cell(cfg, SMALL[0], make_mesh("single")).args[2],
        S.build_cell(cfg, SMALL[0], make_mesh("single")).in_shardings[2],
        make_mesh("single")) + 8


def test_card_rows_run_on_the_cpu(monkeypatch):
    """A row that fits runs (median ms; no measured peak on the CPU), a
    cell of each kind."""
    monkeypatch.setattr(dryrun, "CARD_REPS", 2)
    for arch, shape in (("qwen2-0.5b", SMALL[0]), ("whisper-small", SMALL[1]),
                        ("qwen2-0.5b", SMALL[2]),
                        ("falcon-mamba-7b", SMALL[3])):
        rec = dryrun.cell_record(_reduced(arch), shape, "card", device="cpu",
                                 capacity_bytes=1 << 34)
        assert rec["status"] == "OK", rec
        assert rec["device"] == "cpu" and rec["measured"]["ms"] > 0
        assert len(rec["measured"]["ms_all"]) == dryrun.CARD_REPS
        m = rec["memory"]
        assert m["peak_measured_bytes"] is None
        assert m["peak_estimate_bytes"] >= m["argument_bytes"]
        assert rec["n_devices"] == 1
    with pytest.raises(ValueError, match="device"):
        dryrun.cell_record(_reduced("qwen2-0.5b"), SMALL[2], "card")


def test_cli_resumes_and_records_failures(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_PATH", str(tmp_path / "r.json"))
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: _reduced(arch))
    argv = ["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--device",
            "cpu"]
    assert dryrun.main(argv) == 0
    first = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert first["rows"] == {"qwen2-0.5b|decode_32k|single|base": "OK",
                             "qwen2-0.5b|decode_32k|multi|base": "OK"}
    assert dryrun.main(argv) == 0
    assert "[cached] qwen2-0.5b|decode_32k|single|base: OK" in \
        capsys.readouterr().out

    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "cell_record", broken)
    assert dryrun.main(argv + ["--force", "--mesh", "single"]) == 1
    saved = json.loads((tmp_path / "r.json").read_text())
    assert saved["qwen2-0.5b|decode_32k|single|base"]["status"] == "FAIL"
    assert saved["qwen2-0.5b|decode_32k|multi|base"]["status"] == "OK"
    with pytest.raises(SystemExit):
        dryrun.main(argv + ["--mesh", "card"])


# ---------------------------------------------------------------------------
# distributed AMG rows
# ---------------------------------------------------------------------------

def _ref_rank_bytes(dg, setupd, prob) -> dict:
    """The reference's per-device bytes of its ``shard_map`` operands
    (every leaf split over ``rank``), named as the port's."""
    n = dg.ndev
    args = dg.sharded_args(setupd)
    out = {f"L{i}/{k}": np.asarray(v).nbytes // n
           for i, lv in enumerate(args["levels"]) for k, v in lv.items()}
    out["a0"] = np.asarray(dg.scatter_fine_payloads(prob.A.data)).nbytes // n
    out["b"] = np.asarray(dg.scatter_vector(prob.b)).nbytes // n
    return out


@pytest.fixture(scope="module")
def amg_setups():
    """The reference's m=6 setup (``dryrun_amg``'s setting), with its port
    copy and the port's own problem."""
    out = {}
    for m in (6,):
        rp = ref_assemble(m)
        ref = ref_gamg.setup(rp.A, rp.B, coarse_size=60)
        levels, coarse = setup_to_numpy(ref)
        port = setup_from_numpy(levels, coarse, coarsener=ref.coarsener,
                                device="cpu")
        out[m] = (rp, ref, assemble_elasticity(m, device="cpu"), port)
    return out


@pytest.mark.parametrize("m,ndev", [(6, 8), (6, 16), (6, 64)])
def test_amg_staging_rows_match_reference(amg_setups, m, ndev):
    rp, ref, prob, port = amg_setups[m]
    row = dryrun_amg.staging_row(prob, port, ndev, m)
    dg = ref_solver.build_dist_gamg(ref, ndev)
    assert row["grid"] == (f"{m}^3 Q1 elasticity ({rp.A.shape[0]} unknowns,"
                           f" {len(ref.levels) + 1} levels)")
    assert row["halo_strategy"] == dg.levels[0].a_op.halo.strategy
    assert row["placement"] == dg.placement
    assert row["n_devices"] == ndev and row["mesh"] == [ndev]
    got = dict(row["memory"]["argument_bytes_by_leaf"])
    want = _ref_rank_bytes(dg, ref, rp)
    for i, lv in enumerate(dg.levels):
        for st in ("s1", "s2"):
            stage = lv.stage1 if st == "s1" else lv.stage2
            # offsets (out_pad + 1 int32) where the reference has ids
            assert got.pop(f"L{i}/{st}_off") == 4 * (stage.out_pad + 1)
            assert want.pop(f"L{i}/{st}_seg") == 4 * stage.ppad
    assert got == want
    assert row["memory"]["argument_bytes"] == sum(
        row["memory"]["argument_bytes_by_leaf"].values())
    coll = row["collectives"]
    assert coll["msgs"] == sum(r["msgs"] for r in coll["levels"]) > 0


def test_amg_card_row_takes_the_single_device_iterations(amg_setups):
    _, _, prob, port = amg_setups[6]
    row = dryrun_amg.card_row(prob, port, "cpu")
    assert row["backend"] == "gloo" and row["device"] == "cpu"
    assert row["iters"] == row["single_device_iters"] > 0
    assert row["converged"] and row["x_rel_diff"] < 1e-10
    assert row["true_relres"] <= dryrun_amg.RTOL
    assert len(row["measured"]["ms_all"]) == dryrun_amg.CARD_REPS


def test_amg_rows_and_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_PATH", str(tmp_path / "r.json"))
    monkeypatch.setattr(dryrun_amg, "RANKS", (("single", 4), ("multi", 8)))
    assert dryrun_amg.run_amg_dryrun(m=5, device="cpu") == 0
    saved = json.loads((tmp_path / "r.json").read_text())
    assert sorted(saved) == [f"amg-elasticity-q1-m5|solve|{k}|base"
                             for k in ("card", "multi", "single")]
    card = saved["amg-elasticity-q1-m5|solve|card|base"]
    assert card["iters"] == card["single_device_iters"]
    assert saved["amg-elasticity-q1-m5|solve|multi|base"]["n_devices"] == 8
    assert dryrun_amg.run_amg_dryrun(m=5, device="cpu") == 0
    assert capsys.readouterr().out.count("[cached]") == 3
    calls = []
    monkeypatch.setattr(dryrun_amg, "run_amg_dryrun",
                        lambda **kw: calls.append(kw) or 0)
    assert dryrun.main(["--amg", "--force", "--device", "cpu"]) == 0
    assert calls == [dict(force=True, device=torch.device("cpu"))]
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["failures"] == 0 and len(out["rows"]) == 3


# ---------------------------------------------------------------------------
# slow: full configs, production rank counts, 512 placeholder devices
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-small"])
def test_full_config_traces(arch):
    """Every shape at the full config, probes included: the corrected
    counts are the full trace's, and the card estimate covers the
    arguments."""
    cfg = get_config(arch)
    units = roofline._n_units(arch)
    for shape in LM_SHAPES:
        if not cell_applicable(cfg, shape)[0]:
            continue
        recs = [dryrun.cell_record(c, shape, "single")
                for c in (cfg, dryrun._probe_config(cfg, 1),
                          dryrun._probe_config(cfg, 2))]
        full, d1, d2 = (r["cost"]["flops_per_device"] for r in recs)
        assert abs(roofline._loop_corrected(full, d1, d2, units) - full) \
            <= 1e-9 * full
        card = dryrun.cell_record(cfg, shape, "card", device="cpu",
                                  capacity_bytes=1)
        assert card["status"] == "SKIP"
        assert card["memory"]["peak_estimate_bytes"] >= \
            card["memory"]["argument_bytes"]


@pytest.mark.slow
def test_amg_staging_at_production_ranks():
    """m=12 (the largest MIS grid the CPU holds comfortably; m=21 does not
    fit this host) staged for the production meshes' 256 and 512 ranks."""
    prob = assemble_elasticity(12, device="cpu")
    setupd = gamg.setup(prob.A, prob.B, coarse_size=60)
    for _, ndev in dryrun_amg.RANKS:
        row = dryrun_amg.staging_row(prob, setupd, ndev, 12)
        assert row["placement"][0] == "sharded"
        assert row["memory"]["argument_bytes"] > 0
        assert row["collectives"]["msgs"] > 0


REF_ARGS = """
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                           + os.environ.get("XLA_FLAGS", ""))
import jax
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.launch import specs
from repro.models.config import shape_by_name
out = {}
for arch, shape, name in json.loads(sys.argv[1]):
    multi = name == "multi"
    axes = ("pod", "data", "model") if multi else ("data", "model")
    mesh = jax.make_mesh((2, 16, 16) if multi else (16, 16), axes,
                         axis_types=(AxisType.Auto,) * len(axes))
    with jax.enable_x64(False):
        cell = specs.build_cell(get_config(arch), shape_by_name(shape), mesh)
        ma = jax.jit(lambda *a: 0, in_shardings=cell.in_shardings,
                     keep_unused=True).lower(*cell.args).compile() \\
            .memory_analysis()
    out["|".join((arch, shape, name))] = int(ma.argument_size_in_bytes)
print(json.dumps(out))
"""


@pytest.mark.slow
def test_argument_bytes_under_512_placeholder_devices():
    """XLA's per-device argument bytes for the reference's cell shardings,
    compiled over 512 (and 256) placeholder CPU devices, equal the
    port's ``shard_bytes`` sums (no padding)."""
    cells = [("qwen2-0.5b", "decode_32k", "multi"),
             ("deepseek-v2-236b", "train_4k", "single"),
             ("whisper-small", "prefill_32k", "multi"),
             ("falcon-mamba-7b", "long_500k", "single")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_ARGS, json.dumps(cells)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.splitlines()[-1])
    for arch, shape, name in cells:
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models.config import shape_by_name
        pm = make_production_mesh(multi_pod=name == "multi")
        cell = S.build_cell(get_config(arch), shape_by_name(shape), pm)
        assert S.tree_shard_bytes(cell.args, cell.in_shardings, pm) == \
            want[f"{arch}|{shape}|{name}"]
