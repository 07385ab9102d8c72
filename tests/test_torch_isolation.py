"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch`` or ``chip_smoke.py``; entry points default to CUDA and
raise where it is absent; CPU tensors take the plain versions and count no
kernel launch."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.block_pair_gemm import ops as pair_ops  # noqa
from repro_torch.kernels.block_seg_sum import ops as seg_ops  # noqa: E402
from repro_torch.kernels.block_spmm import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.block_spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.fused_pair_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.fused_smoother import ops as smooth_ops  # noqa
from repro_torch.kernels.pbjacobi import ops as pbj_ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch.configs.elasticity import ElasticityConfig
    from repro_torch.fem.assemble import assemble_elasticity
    from repro_torch.interop import bcsr_from_numpy
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        assemble_elasticity(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticityConfig(m=3).build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bcsr_from_numpy([0, 1], [0], np.eye(3)[None], 1)
    # the observability and time-march entry points
    from repro_torch import march as march_cli
    from repro_torch import sim
    from repro_torch.core.gamg import GAMGSolver
    from repro_torch.obs import trace
    cfg = sim.MarchConfig(n_steps=1)
    calls = [
        lambda: trace.zero_tally(3),
        lambda: sim.march(assemble_elasticity(3), None, cfg),
        lambda: sim.SofteningScenario.build(assemble_elasticity(3)),
        lambda: GAMGSolver(assemble_elasticity(3).A, None, obs="counters"),
        lambda: march_cli.main(3, 1),
        lambda: march_cli.cli(["3", "1"]),
    ]
    # the scalar baseline's entry points run where their operands are,
    # which the port's constructors put on the card by default
    from repro_torch.core import gamg
    from repro_torch.core.scalar_csr import expand_bcsr
    from repro_torch.core.scalar_path import build_scalar_ptap_chain, \
        recompute_scalar
    calls += [
        lambda: expand_bcsr(assemble_elasticity(3).A),
        lambda: expand_bcsr(bcsr_from_numpy([0, 1], [0], np.eye(3)[None],
                                            1)),
        lambda: recompute_scalar(gamg.setup(assemble_elasticity(3).A, None),
                                 None),
        lambda: build_scalar_ptap_chain(gamg.setup(
            assemble_elasticity(3).A, None)),
    ]
    # the AMG front doors: serve, observe, heterogeneous, distributed and
    # the message-count CLI
    from repro_torch import amg_distributed, heterogeneous, observe_amg, \
        serve_amg
    from repro_torch.dist import measure
    argv = {"march": ["3", "1"], "serve_amg": ["3"], "observe_amg": ["3"],
            "heterogeneous": ["3"], "amg_distributed": ["2", "3"],
            "dist.measure": ["3", "2", "1"]}
    calls += [
        lambda: serve_amg.main(3), lambda: serve_amg.cli(["3"]),
        lambda: observe_amg.main(3), lambda: observe_amg.cli(["3"]),
        lambda: heterogeneous.main(3), lambda: heterogeneous.cli(["3"]),
        lambda: amg_distributed.main(2, 3),
        lambda: amg_distributed.cli(["2", "3"]),
        lambda: measure.main(3, 2, 1), lambda: measure.cli(["3", "2", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-m", f"repro_torch.{mod}",
                               *args], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for mod, args in argv.items()]
    for proc in procs:
        _, err = proc.communicate(timeout=120)
        assert proc.returncode != 0 and "device='cpu'" in err, proc.args


def test_lm_entry_points_default_to_cuda_and_raise_without_it():
    """The LM models, the serve and train steps, ``serve_lm`` and the
    training twins put what they make on the card by default: without CUDA
    they raise, in-process and as ``python -m repro_torch.serve_lm``,
    ``.train_lm`` and ``.launch.train``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch import serve_lm
    from repro_torch.configs.registry import get_config
    from repro_torch.interop import lm_cache_from_numpy, \
        lm_params_from_numpy, train_state_from_numpy
    from repro_torch import train_lm
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers, transformer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.steps import make_init, make_train_step
    cfg = get_config("falcon-mamba-7b").reduced()
    calls = [
        lambda: transformer.init_lm(cfg),
        lambda: transformer.init_full_cache(cfg, 1, 4),
        lambda: transformer.init_layer_cache(cfg, 1, 4, torch.float32),
        lambda: transformer.LM(cfg),
        lambda: make_init(cfg)(0),
        lambda: layers.init_mamba_state(cfg, 1, torch.float32),
        lambda: layers.causal_mask(4, 4),
        lambda: lm_params_from_numpy({"w": np.zeros(2)}),
        lambda: lm_cache_from_numpy({"k": np.zeros(2)}),
        lambda: train_state_from_numpy({"opt": {"step": np.zeros(())}}),
        lambda: serve_lm.serve(cfg), lambda: serve_lm.main(),
        lambda: serve_lm.cli([]),
        lambda: make_train_step(cfg, AdamWConfig()),
        lambda: train_lm.main([]), lambda: train_lm.cli([]),
        lambda: launch_train.main(["--arch", "qwen2-0.5b"]),
        lambda: launch_train.cli(["--arch", "qwen2-0.5b"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for cmd in (["repro_torch.serve_lm"], ["repro_torch.train_lm"],
                ["repro_torch.launch.train", "--arch", "qwen2-0.5b"]):
        out = subprocess.run(
            [sys.executable, "-m"] + cmd, capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        assert out.returncode != 0 and "device='cpu'" in out.stderr, cmd


def test_launch_entry_points_default_to_cuda_and_raise_without_it():
    """The launch layer's dry run, AMG rows and roofline run on the card by
    default: without CUDA they raise, in-process and as ``python -m
    repro_torch.launch.dryrun``, ``.dryrun_amg`` and ``.roofline``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, dryrun_amg, roofline
    from repro_torch.models.config import shape_by_name
    cfg = get_config("qwen2-0.5b").reduced()
    calls = [
        lambda: dryrun.main(["--arch", "qwen2-0.5b"]),
        lambda: dryrun.cli(["--amg"]),
        lambda: dryrun.run_cell("qwen2-0.5b", "decode_32k", "card",
                                device="cuda"),
        lambda: dryrun.cell_record(cfg, shape_by_name("decode_32k"), "card",
                                   device="cuda"),
        lambda: dryrun_amg.run_amg_dryrun(m=3),
        lambda: roofline.main([]), lambda: roofline.cli(["--json"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for cmd in (["repro_torch.launch.dryrun", "--arch", "qwen2-0.5b"],
                ["repro_torch.launch.dryrun", "--amg"],
                ["repro_torch.launch.dryrun_amg"],
                ["repro_torch.launch.roofline"]):
        out = subprocess.run(
            [sys.executable, "-m"] + cmd, capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        assert out.returncode != 0 and "device='cpu'" in out.stderr, cmd


def test_dist_entry_points_default_to_cuda_and_nccl(tmp_path):
    """The distributed layer's front doors default to the card and the
    NCCL backend: without CUDA they raise unless asked for the CPU and
    gloo; the rank operands default to the card too."""
    from repro_torch.core import gamg
    from repro_torch.dist import selftest
    from repro_torch.dist.comm import RankComm
    from repro_torch.dist.solver import build_dist_gamg
    from repro_torch.fem.assemble import assemble_elasticity
    with pytest.raises(RuntimeError, match="process group"):
        RankComm()
    with pytest.raises(ValueError, match="gloo"):
        selftest.main(["4", "--device", "cpu"])
    with pytest.raises(SystemExit):
        selftest.parse_args(["4", "--fault"])      # one rank has no halo
    prob = assemble_elasticity(4, path="host", device="cpu")
    dg = build_dist_gamg(gamg.setup(prob.A, prob.B, coarse_size=12,
                                    coarsener="greedy"), 2)
    assert dg.rank_args(1, device="cpu")["levels"][0]["a_idx"].device \
        .type == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        selftest.main(["4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dg.rank_args(0)
    out = subprocess.run([sys.executable, "-m", "repro_torch.dist.selftest",
                          "4"], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode != 0 and "device='cpu'" in out.stderr


def _cpu_calls():
    rng = np.random.default_rng(0)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape))

    idx = torch.zeros((4, 2), dtype=torch.int32)
    mask = torch.ones((4, 2), dtype=torch.bool)
    return [
        (seg_ops, lambda: seg_ops.block_seg_sum(
            t((5, 3, 3)), torch.tensor([0, 2, 5], dtype=torch.int32))),
        (spmv_ops, lambda: spmv_ops.block_spmv_ell(idx, t((4, 2, 3, 6)),
                                                   t((1, 6)))),
        (smooth_ops, lambda: smooth_ops.smoother_step_ell(
            idx, t((4, 2, 3, 3)), t((4, 3, 3)), t((4, 3)), t((4, 3)),
            t((4, 3)), t((2,)))),
        (gemm_ops, lambda: gemm_ops.fused_pair_gemm(
            t((3, 6, 3)), t((2, 3, 6)), idx, idx, mask)),
        (spmm_ops, lambda: spmm_ops.block_spmm_ell(idx, t((4, 2, 3, 6)),
                                                   t((1, 6, 5)))),
        (smooth_ops, lambda: smooth_ops.smoother_step_ell(
            idx, t((4, 2, 3, 3)), t((4, 3, 3)), t((4, 3, 5)), t((4, 3, 5)),
            t((4, 3, 5)), t((2,)))),
        (pair_ops, lambda: pair_ops.block_pair_gemm(t((7, 6, 3)),
                                                    t((7, 3, 6)))),
        (pbj_ops, lambda: pbj_ops.pbjacobi_update(t((4, 6, 6)), t((4, 6)),
                                                  t((4, 6)), 0.6)),
        (smooth_ops, lambda: smooth_ops.smoother_step_scalar_ell(
            torch.zeros((12, 2), dtype=torch.int32), t((12, 2, 1, 1)),
            t((4, 3, 3)), t((4, 3)), t((4, 3)), t((4, 3)), t((2,)))),
    ]


@pytest.mark.parametrize("i", range(9), ids=["block_seg_sum", "block_spmv",
                                             "fused_smoother",
                                             "fused_pair_gemm", "block_spmm",
                                             "fused_smoother_panel",
                                             "block_pair_gemm", "pbjacobi",
                                             "fused_smoother_scalar"])
def test_cpu_calls_take_the_plain_version_and_count_nothing(i):
    mod, call = _cpu_calls()[i]
    before = mod.launches
    call()
    assert mod.launches == before


def test_scalar_entry_points_run_where_their_operands_are():
    """On CPU operands the scalar baseline runs on the CPU (the plain
    versions: no kernel launch counted), its outputs on the CPU."""
    from repro_torch.core import gamg
    from repro_torch.core.scalar_csr import expand_bcsr
    from repro_torch.core.scalar_path import build_scalar_ptap_chain, \
        recompute_scalar
    from repro_torch.fem.assemble import assemble_elasticity
    mods = (seg_ops, spmv_ops, smooth_ops, gemm_ops)
    before = [m.launches for m in mods]
    prob = assemble_elasticity(4, device="cpu")
    sd = gamg.setup(prob.A, prob.B, coarse_size=40)
    assert sd.levels
    assert expand_bcsr(prob.A).data.device.type == "cpu"
    hier = recompute_scalar(sd, prob.A.data)
    assert all(lv.a_ell.data.device.type == "cpu" for lv in hier.levels)
    outs = build_scalar_ptap_chain(sd)(prob.A.data)
    assert all(o.device.type == "cpu" for o in outs)
    assert gamg.hier_solve(sd, hier, prob.b).x.device.type == "cpu"
    assert [m.launches for m in mods] == before


def test_other_devices_and_mixed_devices_raise():
    meta = torch.empty((4, 2, 3, 3), dtype=torch.float64, device="meta")
    idx = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        spmv_ops.block_spmv_ell(idx, meta, torch.empty(
            (1, 3), dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        spmv_ops.block_spmv_ell(torch.zeros((4, 2), dtype=torch.int32),
                                meta, torch.zeros((1, 3)))


def test_pbjacobi_mixed_devices_raise():
    cpu = torch.zeros((4, 3), dtype=torch.float64)
    dinv = torch.zeros((4, 3, 3), dtype=torch.float64)
    meta = torch.empty((4, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        pbj_ops.pbjacobi_update(dinv, meta, cpu, 0.6)
    with pytest.raises(ValueError, match="several devices"):
        pbj_ops.pbjacobi_update(dinv, cpu, cpu, torch.ones(
            1, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pbj_ops.pbjacobi_update(dinv.to("meta"), meta, meta, 0.6)


def test_tune_knob_validates(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE", "bogus")
    with pytest.raises(ValueError, match="autotune mode"):
        backend.resolve_tune()
    monkeypatch.delenv("REPRO_TORCH_TUNE")
    assert backend.resolve_tune() == "cache"
    assert backend.resolve_tune("off") == "off"


def test_path_knobs_validate(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SPGEMM_PATH", "pairs")
    assert backend.resolve_spgemm_path("cpu") == "pairs"
    assert backend.resolve_spgemm_path("cuda") == "pairs"
    monkeypatch.setenv("REPRO_TORCH_SPGEMM_PATH", "bogus")
    with pytest.raises(ValueError, match="SpGEMM path"):
        backend.resolve_spgemm_path("cpu")
    monkeypatch.setenv("REPRO_TORCH_SMOOTH_PATH", "bogus")
    with pytest.raises(ValueError, match="smoother path"):
        backend.resolve_smooth_path("cpu")
    monkeypatch.delenv("REPRO_TORCH_SPGEMM_PATH")
    monkeypatch.delenv("REPRO_TORCH_SMOOTH_PATH")
    assert backend.resolve_spgemm_path("cpu") == "fused"
    assert backend.resolve_smooth_path("cpu") == "fused"


@pytest.mark.parametrize("var", ["REPRO_SPGEMM_PATH", "REPRO_SMOOTH_PATH",
                                 "REPRO_PRECISION"])
def test_reference_package_knobs_do_not_reach_the_port(monkeypatch, var):
    """The JAX package's variables (where "reference" is the CPU default)
    leave the port on its kernel paths and its f64 policy."""
    monkeypatch.setenv(var, "f32" if var == "REPRO_PRECISION"
                       else "reference")
    assert backend.resolve_spgemm_path("cuda") == "fused"
    assert backend.resolve_smooth_path("cuda") == "fused"
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.interop import bcsr_from_numpy
    from repro_torch.core import gamg
    A = bcsr_from_numpy([0, 1], [0], np.eye(3)[None], 1, device="cpu")
    B = torch.eye(3, dtype=torch.float64)
    assert gamg.setup(A, B).precision == PrecisionPolicy.double()


@pytest.mark.parametrize("knob", ["spgemm", "smooth"])
@pytest.mark.parametrize("source", ["env", "arg"])
def test_reference_path_is_refused_on_cuda(monkeypatch, knob, source):
    """No route to the plain versions on the card: the 'reference' paths
    raise for CUDA payloads and run only on the CPU."""
    resolve = getattr(backend, f"resolve_{knob}_path")
    var = f"REPRO_TORCH_{knob.upper()}_PATH"
    kw = {}
    if source == "env":
        monkeypatch.setenv(var, "reference")
    else:
        kw["path"] = "reference"
    assert resolve("cpu", **kw) == "reference"
    with pytest.raises(ValueError, match="CPU-only"):
        resolve("cuda", **kw)
    with pytest.raises(ValueError, match="CPU-only"):
        resolve(torch.device("cuda", 0), **kw)
