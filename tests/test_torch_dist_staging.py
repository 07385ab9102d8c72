"""The port's distributed staging (``repro_torch.dist.solver
.build_dist_gamg`` and ``repro_torch.dist.pamg``) against
``repro.dist.solver.build_dist_gamg`` on the CPU.

Two setups: the reference's own at m=5 (its defaults, the MIS coarsener,
``coarse_size=12``: levels ``[300, ...]`` with a mid level to
agglomerate), carried across to the port through numpy
(``interop.setup_from_numpy``), and the port's own greedy setup at m=7
(``coarse_size=12``) beside the reference's, whose aggregates are equal.
On the carried setup every staged array — halos, ELL indices, local
indices, interior masks and counts, stage gathers and payloads, ``seg``
and masks, ``diag_sel``, ``row_mask``, placement, the switch and coarse
selectors — is held bitwise, at ndev 2, 3, 4 and a (2, 2) mesh, for
``coarse_eq_limit`` 0, the default and ``1 << 30``, at f64 and f32.  On
the port's own setup the plans are bitwise and the payloads within 1e-12
(the setups' values differ by rounding).  Also ``dist_cycle_comm``
against the reference's rows, the scatter staging dtypes (the policy's,
never the caller's), the per-rank operands and the ``coarse_eq_limit``
threading of ``setup`` and ``ElasticityConfig``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 on)
from repro.core import gamg as ref_gamg  # noqa: E402
from repro.dist import solver as ref_solver  # noqa: E402
from repro.dist.partition import ProcessMesh as RefMesh  # noqa: E402
from repro.fem.assemble import assemble_elasticity as ref_assemble  # noqa
from repro.obs.model import dist_cycle_comm as ref_comm_model  # noqa: E402

from repro_torch.core import gamg  # noqa: E402
from repro_torch.dist import solver  # noqa: E402
from repro_torch.dist.partition import ProcessMesh  # noqa: E402
from repro_torch.fem.assemble import assemble_elasticity  # noqa: E402
from repro_torch.interop import setup_from_numpy  # noqa: E402
from repro_torch.obs.model import dist_cycle_comm  # noqa: E402

from torch_helpers import setup_to_numpy, to_np  # noqa: E402

#: payloads of the port's own setup against the reference's (the two
#: setups' values differ by rounding; plans are bitwise)
PAYLOAD_REL = 1e-12
MESHES = [2, 3, 4, (2, 2)]
MESH_IDS = ["ndev2", "ndev3", "ndev4", "mesh2x2"]
LIMITS = [0, None, 1 << 30]
LIMIT_IDS = ["limit0", "default", "limit1e30"]
#: fields that are not staging: the single-device level itself (the
#: setup, carried across bit for bit) and the reference's jit token
SKIP = {"ls", "state_token"}


def _mesh(spec, ref: bool):
    cls = RefMesh if ref else ProcessMesh
    return cls(spec) if isinstance(spec, tuple) else spec


@pytest.fixture(scope="module")
def carried():
    """The reference's m=5 setups (f64, f32) and their port copies."""
    rp = ref_assemble(5)
    out = {}
    for prec in ("f64", "f32"):
        ref = ref_gamg.setup(rp.A, rp.B, coarse_size=12, precision=prec)
        levels, coarse = setup_to_numpy(ref)
        port = setup_from_numpy(levels, coarse, precision=prec,
                                coarsener=ref.coarsener, device="cpu")
        out[prec] = (ref, port)
    assert len(out["f64"][0].levels) >= 2, out["f64"][0].stats
    return rp, out


@pytest.fixture(scope="module")
def own():
    """The reference's and the port's own greedy setups at m=7."""
    rp = ref_assemble(7)
    ref = ref_gamg.setup(rp.A, rp.B, coarse_size=12, coarsener="greedy",
                         precision="f64")
    prob = assemble_elasticity(7, path="host", device="cpu")
    port = gamg.setup(prob.A, prob.B, coarse_size=12, coarsener="greedy",
                      precision="f64")
    assert port.stats["level_rows"] == ref.stats["level_rows"]
    return ref, port


def _np(a) -> np.ndarray:
    return to_np(a) if hasattr(a, "detach") else np.asarray(a)


def _same(ref, got, path: str, payload_rel=None) -> int:
    """Walk the reference's staging beside the port's; returns how many
    arrays were compared.  Arrays are bitwise (dtype, shape and bytes)
    unless ``payload_rel`` is given, which floats then meet instead."""
    if ref is None:
        assert got is None, path
        return 0
    if isinstance(ref, (bool, int, float, str, np.integer)):
        assert ref == got, (path, ref, got)
        return 0
    if hasattr(ref, "shape") and hasattr(ref, "dtype"):
        r, g = _np(ref), _np(got)
        assert r.shape == g.shape, (path, r.shape, g.shape)
        assert r.dtype == g.dtype, (path, r.dtype, g.dtype)
        if payload_rel is not None and r.dtype.kind == "f":
            scale = np.abs(r).max() if r.size else 0.0
            err = np.abs(r - g).max() if r.size else 0.0
            assert err <= payload_rel * scale, (path, err, scale)
        else:
            assert r.tobytes() == g.tobytes(), path
        return 1
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), (path, len(ref), len(got))
        return sum(_same(r, g, f"{path}[{i}]", payload_rel)
                   for i, (r, g) in enumerate(zip(ref, got)))
    if type(ref).__name__ == "PrecisionPolicy":
        assert ref.describe() == got.describe(), path
        return 0
    if type(ref).__name__ == "BlockELL":       # the switch's global P / R
        # the setup's own ELL payload: valid slots bitwise, padded slots
        # zero (the reference's may hold -0.0 where the port's hold +0.0)
        n = _same(ref.indices, got.indices, path + ".indices") \
            + _same(ref.mask, got.mask, path + ".mask")
        m = _np(ref.mask)
        r, g = _np(ref.data), _np(got.data)
        assert not r[~m].any() and not g[~m].any(), path + ".data padding"
        return n + _same(r[m], g[m], path + ".data", payload_rel)
    if type(ref).__name__ == "BlockCSR":       # the coarsest structure
        return (_same(ref.indptr, got.indptr, path + ".indptr")
                + _same(ref.indices, got.indices, path + ".indices"))
    assert dataclasses.is_dataclass(ref), (path, type(ref))
    n = 0
    for f in dataclasses.fields(ref):
        if f.name in SKIP:
            continue
        assert hasattr(got, f.name), f"{path}.{f.name} missing in the port"
        n += _same(getattr(ref, f.name), getattr(got, f.name),
                   f"{path}.{f.name}", payload_rel)
    return n


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("limit", LIMITS, ids=LIMIT_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_staging_bitwise_on_the_carried_setup(carried, mesh, limit, prec):
    ref_setup, port_setup = carried[1][prec]
    want = ref_solver.build_dist_gamg(ref_setup, _mesh(mesh, True),
                                      coarse_eq_limit=limit)
    got = solver.build_dist_gamg(port_setup, _mesh(mesh, False),
                                 coarse_eq_limit=limit)
    assert got.placement == want.placement
    assert _same(want, got, "dg") > 20
    assert got.levels[0].p_op is None or \
        got.levels[0].p_op.data.dtype == port_setup.precision \
        .hierarchy_dtype


@pytest.mark.parametrize("limit", LIMITS, ids=LIMIT_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_staging_on_the_ports_own_setup(own, mesh, limit):
    """The port's own greedy setup: plans bitwise, payloads within
    ``PAYLOAD_REL`` of the reference's staging of its own setup."""
    ref_setup, port_setup = own
    want = ref_solver.build_dist_gamg(ref_setup, _mesh(mesh, True),
                                      coarse_eq_limit=limit)
    got = solver.build_dist_gamg(port_setup, _mesh(mesh, False),
                                 coarse_eq_limit=limit)
    assert got.placement == want.placement
    assert _same(want, got, "dg", payload_rel=PAYLOAD_REL) > 20


def test_placements_cover_every_strategy(carried):
    """The cases above reach every halo strategy and both placements."""
    _, port_setup = carried[1]["f64"]
    seen = set()
    for mesh in MESHES:
        for limit in LIMITS:
            dg = solver.build_dist_gamg(port_setup, _mesh(mesh, False),
                                        coarse_eq_limit=limit)
            for lv in dg.levels:
                seen.add(lv.a_op.halo.strategy)
                seen.add(lv.stage2.halo.strategy)
            if dg.switch is not None:
                seen.add(dg.switch.p_b.halo.strategy)
            seen.add("switch" if dg.repl else "coarse")
    assert {"ppermute", "allgather", "replicated", "switch",
            "coarse"} <= seen, seen


@pytest.mark.parametrize("limit", LIMITS, ids=LIMIT_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_comm_model_matches_reference(carried, mesh, limit):
    ref_setup, port_setup = carried[1]["f64"]
    want = ref_comm_model(ref_solver.build_dist_gamg(
        ref_setup, _mesh(mesh, True), coarse_eq_limit=limit))
    got = dist_cycle_comm(solver.build_dist_gamg(
        port_setup, _mesh(mesh, False), coarse_eq_limit=limit))
    assert got == want


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_scatter_staging_dtypes_are_the_policys(carried, prec):
    """tests/test_dist_amg.py's staging-dtype contract: f64 and f32 callers
    stage at the same (policy) dtype, and the values match the
    reference's scatter bitwise."""
    rp, setups = carried
    ref_setup, port_setup = setups[prec]
    for limit in (0, 1 << 30):
        want = ref_solver.build_dist_gamg(ref_setup, 2,
                                          coarse_eq_limit=limit)
        dg = solver.build_dist_gamg(port_setup, 2, coarse_eq_limit=limit)
        a = np.array(rp.A.data)
        b = np.array(rp.b)
        a64, a32 = (dg.scatter_fine_payloads(a.astype(dt))
                    for dt in (np.float64, np.float32))
        assert a64.dtype == a32.dtype == dg.payload_stage_dtype \
            == torch.float64
        b64, b32 = (dg.scatter_vector(b.astype(dt))
                    for dt in (np.float64, np.float32))
        assert b64.dtype == b32.dtype == port_setup.precision.krylov_dtype
        _same(want.scatter_fine_payloads(a), a64, "payload")
        _same(want.scatter_fine_payloads(a.astype(np.float32)), a32,
              "payload32")
        _same(want.scatter_vector(b), b64, "vector")
        # a rank's slab is that rank's row of the stack
        assert torch.equal(dg.scatter_fine_payloads(a, 1), a64[1])
        assert torch.equal(dg.scatter_vector(b, 0), b64[0])
        assert torch.equal(dg.gather_vector(b64), torch.as_tensor(b))


def test_rank_args_are_the_ranks_slices(carried):
    """``rank_args`` slices rank r's plans, kernel indices int32, and
    derives each stage's segment offsets from its sorted ``seg``."""
    _, port_setup = carried[1]["f64"]
    dg = solver.build_dist_gamg(port_setup, 3, coarse_eq_limit=0)
    for r in range(3):
        args = dg.rank_args(r, device="cpu")
        for lv, a in zip(dg.levels, args["levels"]):
            assert a["a_idx"].dtype == torch.int32
            assert np.array_equal(a["a_idx"].numpy(), lv.a_op.indices[r])
            assert a["a_gather"].dtype == torch.int64
            assert torch.equal(a["s1_rhs"], lv.stage1.rhs_data[r])
            for key, st in (("s1_off", lv.stage1), ("s2_off", lv.stage2)):
                off = a[key].numpy()
                assert a[key].dtype == torch.int32
                assert off[0] == 0 and off[-1] == st.ppad
                seg = st.seg[r]
                assert np.array_equal(
                    np.repeat(np.arange(st.out_pad), np.diff(off)), seg)


def test_coarse_eq_limit_threads_through_setup_and_config():
    from repro_torch.configs.elasticity import ElasticityConfig
    prob = assemble_elasticity(5, path="host", device="cpu")
    sd = gamg.setup(prob.A, prob.B, coarse_size=12, coarsener="greedy")
    assert sd.coarse_eq_limit is None
    sd7 = gamg.setup(prob.A, prob.B, coarse_size=12, coarsener="greedy",
                     coarse_eq_limit=7)
    assert sd7.coarse_eq_limit == 7
    assert solver.build_dist_gamg(sd, 2).coarse_eq_limit == \
        solver.DEFAULT_COARSE_EQ_LIMIT
    assert solver.build_dist_gamg(sd7, 2).coarse_eq_limit == 7
    assert solver.build_dist_gamg(sd7, 2, coarse_eq_limit=0) \
        .coarse_eq_limit == 0
    cfg = ElasticityConfig(m=4, coarse_size=12, assembly="host",
                           coarse_eq_limit=3)
    _, slv = cfg.build(device="cpu")
    assert slv.setup_data.coarse_eq_limit == 3
    assert ElasticityConfig(m=4).coarse_eq_limit is None


def test_staging_rejects_what_the_reference_rejects(carried):
    _, port_setup = carried[1]["f64"]
    nbr = port_setup.levels[0].A0.nbr
    with pytest.raises(ValueError, match="larger than the block-row"):
        solver.build_dist_gamg(port_setup, ProcessMesh((nbr + 1, 1)))
    with pytest.raises(ValueError, match="int rank count or a ProcessMesh"):
        solver.build_dist_gamg(port_setup, 2.0)
