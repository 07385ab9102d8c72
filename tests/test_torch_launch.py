"""The port's launch layer (``repro_torch.launch.mesh``, ``.specs``,
``.roofline``) against the reference's ``repro.launch`` on the CPU.

The meshes' axes and sizes equal jax's ``AbstractMesh`` ones.  Every cell
of every arch at its full config (``build_cell`` on the production meshes,
the reference's on ``AbstractMesh``, no devices) has the reference's leaf
paths, shapes and dtypes, sanitized specs (``tuple(NamedSharding.spec)``)
and per-device argument bytes (the sum of ``NamedSharding.shard_shape``
bytes).  The roofline's model counts equal the reference's for all ten
archs, and ``analyze_cell``, with the port's H100 constants set to the
reference's TPU v5e ones, gives the reference's row field for field on
the same records.  The reference's LM side runs with jax's x64 off, as
its own LM tests run alone (other files turn it on through
``repro.core``, and its params then come out f64).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models.config import LM_SHAPES, cell_applicable  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh, roofline, specs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
#: the reference's roofline constants (TPU v5e), set on the port's names
REF_CONSTANTS = dict(PEAK_FLOPS=197e12, HBM_BW=819e9, LINK_BW=50e9,
                     FITS_BYTES=16e9)


def X32():
    return jax.enable_x64(False)


def _abstract(name: str) -> AbstractMesh:
    return AbstractMesh(*MESHES[name])


def _port_mesh(name: str):
    return mesh.make_production_mesh(multi_pod=name == "multi")


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _ref_abstract_params(cfg):
    with X32():
        return ref_specs.abstract_params.__wrapped__(cfg)


@pytest.fixture
def ref_params_cached(monkeypatch):
    """The reference's ``abstract_params`` once a config (its roofline
    calls it again for every count)."""
    fn = functools.wraps(ref_specs.abstract_params)(_ref_abstract_params)
    monkeypatch.setattr(ref_specs, "abstract_params", fn)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_axes_match_reference(name):
    got, want = _port_mesh(name), _abstract(name)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == want.size
    assert mesh.data_axes(got) == ref_mesh.data_axes(want)
    axes = list(want.axis_names)
    for part in axes + [tuple(axes), ref_mesh.data_axes(want)]:
        assert mesh.axis_size(got, part) == ref_mesh.axis_size(want, part)


def test_card_and_amg_meshes_are_descriptions():
    card = mesh.make_mesh("card")
    assert card.axis_names == ("data", "model")
    assert card.shape == {"data": 1, "model": 1} and card.size == 1
    assert mesh.data_axes(card) == ("data",)
    amg = mesh.make_amg_mesh(256)
    assert amg.shape == {"rank": 256} and amg.size == 256
    assert mesh.make_production_mesh().shape == {"data": 16, "model": 16}
    with pytest.raises(KeyError):
        mesh.make_mesh("pod")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _port_leaves(args, shards, path=()):
    """``[(path, leaf, spec)]`` of a cell's args and in_shardings, in
    jax's flattening order (dict keys sorted)."""
    if isinstance(args, dict):
        out = []
        for k in sorted(args):
            out += _port_leaves(args[k], shards[k], path + (k,))
        return out
    if isinstance(args, (tuple, list)):
        out = []
        for i, (a, s) in enumerate(zip(args, shards)):
            out += _port_leaves(a, s, path + (i,))
        return out
    return [(path, args, shards)]


def _ref_path(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch):
    """Leaf for leaf: paths, shapes, dtypes, sanitized specs; and the
    per-device argument bytes, on both production meshes, for every
    applicable shape of the arch at its full config."""
    checked = 0
    for shape in LM_SHAPES:
        if not cell_applicable(ref_config(arch), shape)[0]:
            continue
        for name in MESHES:
            with X32():
                rc = ref_specs.build_cell(ref_config(arch), shape,
                                          _abstract(name))
            pm = _port_mesh(name)
            pc = specs.build_cell(get_config(arch), shape, pm)
            assert pc.kind == rc.kind
            ref = jax.tree_util.tree_flatten_with_path(rc.args)[0]
            ref_sh = jax.tree_util.tree_leaves(
                rc.in_shardings, is_leaf=lambda x: isinstance(
                    x, NamedSharding))
            got = _port_leaves(pc.args, pc.in_shardings)
            assert [_ref_path(p) for p, _ in ref] == [p for p, _, _ in got]
            want_bytes = 0
            for (p, leaf), ns, (_, gl, gs) in zip(ref, ref_sh, got):
                assert tuple(gl.shape) == tuple(leaf.shape), p
                assert _dtype(gl.dtype) == str(leaf.dtype), p
                assert gs == tuple(ns.spec), (p, gs, ns.spec)
                want_bytes += int(np.prod(ns.shard_shape(leaf.shape))) \
                    * leaf.dtype.itemsize
            assert specs.tree_shard_bytes(pc.args, pc.in_shardings,
                                          pm) == want_bytes
            ref_out = jax.tree_util.tree_leaves(
                rc.out_shardings, is_leaf=lambda x: isinstance(
                    x, NamedSharding))
            if pc.kind == "train":      # (params, opt, metrics)
                got_out = [s for _, _, s in _port_leaves(
                    pc.args[:2], pc.out_shardings[:2])] + [(), ()]
            elif pc.kind == "prefill":  # logits
                got_out = [pc.out_shardings]
            else:                       # (logits, cache)
                got_out = [pc.out_shardings[0]] + [
                    s for _, _, s in _port_leaves(pc.args[1],
                                                  pc.out_shardings[1])]
            assert got_out == [tuple(ns.spec) for ns in ref_out]
            checked += 1
    assert checked >= 6


def test_shard_bytes_drops_axes_that_do_not_divide():
    pm = _port_mesh("single")
    with specs.FakeTensorMode():
        leaf = torch.empty((6, 32, 48), dtype=torch.float32)
    full = 6 * 32 * 48 * 4
    assert specs.sanitize_spec(("data", "model", None), leaf.shape, pm) == \
        (None, "model", None)
    assert specs.shard_bytes(leaf, ("data", "model"), pm) == full // 16
    assert specs.shard_bytes(leaf, (None, None, ("data", "model")),
                             pm) == full        # 48 % 256 != 0: dropped
    assert specs.shard_bytes(leaf, (None, ("data",), "model"), pm) == \
        full // 256
    assert specs.shard_bytes(leaf, (), mesh.make_mesh("card")) == full


def test_abstract_params_allocate_nothing():
    cfg = get_config("llama4-maverick-400b-a17b")
    a, b = specs.abstract_params(cfg), specs.abstract_params(cfg)
    assert a is not b and a["blocks"] is not b["blocks"]
    leaves = T.tree_leaves(a)
    assert all(type(x).__name__ == "FakeTensor" for x in leaves)
    assert all(x.dtype == torch.float32 for x in leaves)
    assert T.count_params(a) == 397_691_950_080
    opt = specs.abstract_opt_state(a)
    assert opt["step"].dtype == torch.int32 and opt["step"].shape == ()
    assert all(x.dtype == torch.float32 for x in T.tree_leaves(opt["mu"]))


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_counts_match_reference(arch, ref_params_cached):
    assert roofline.model_params(arch) == ref_roofline.model_params(arch)
    assert roofline._n_units(arch) == ref_roofline._n_units(arch)
    for shape in LM_SHAPES:
        args = (arch, shape.kind, shape.seq_len, shape.global_batch, 256)
        assert roofline.model_flops(*args) == \
            ref_roofline.model_flops(*args)
        assert roofline._ssm_scan_terms(*args) == \
            ref_roofline._ssm_scan_terms(*args)
        if cell_applicable(ref_config(arch), shape)[0]:
            with X32():
                want = ref_roofline._model_min_bytes(*args)
            assert roofline._model_min_bytes(*args) == want
    for d1, d2, units in ((3.0, 5.0, 24), (7.5, 7.0, 64), (0.0, 2.0, 1)):
        assert roofline._loop_corrected(1.0, d1, d2, units) == \
            ref_roofline._loop_corrected(1.0, d1, d2, units)


def _record(kind: str, ndev: int, scale: float, collectives=True,
            peak=12e9) -> dict:
    """A reference-format dry-run record."""
    rec = {"status": "OK", "kind": kind, "n_devices": ndev,
           "memory": {"peak_bytes": peak},
           "cost": {"flops_per_device": 3.1e13 * scale,
                    "bytes_accessed_per_device": 2.2e11 * scale}}
    rec["collectives"] = ({"total_bytes": 4.4e9 * scale} if collectives
                          else None)
    return rec


CELLS = [("qwen2-0.5b", "train_4k"), ("falcon-mamba-7b", "prefill_32k"),
         ("falcon-mamba-7b", "long_500k"), ("deepseek-v2-236b", "decode_32k"),
         ("whisper-small", "train_4k"), ("gemma-7b", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_analyze_cell_matches_reference(arch, shape, ref_params_cached,
                                        monkeypatch):
    for k, v in REF_CONSTANTS.items():
        monkeypatch.setattr(roofline, k, v)
    kind = next(s.kind for s in LM_SHAPES if s.name == shape)
    results = {}
    for mesh_name, ndev in (("single", 256), ("multi", 512)):
        results[f"{arch}|{shape}|{mesh_name}|base"] = _record(
            kind, ndev, 1.0 if mesh_name == "single" else 0.5)
    results[f"{arch}|{shape}|single|probe-d1"] = _record(kind, 256, 0.1)
    results[f"{arch}|{shape}|single|probe-d2"] = _record(kind, 256, 0.15)
    probes = {k: v for k, v in results.items() if "|probe-" in k}
    for key, rec in results.items():
        for pr in (probes, None):
            with X32():
                want = ref_roofline.analyze_cell(key, rec, pr)
            got = roofline.analyze_cell(key, rec, pr)
            want["fits_80g"] = want.pop("fits_16g")
            assert {k: got[k] for k in want} == want, key


def test_analyze_cell_on_a_port_record():
    """A port record: no collective term, the dominant term between
    compute and memory, the scan's bytes already traced, a lower-bound
    peak and a card row's measured ms."""
    rec = _record("prefill", 256, 1.0, collectives=False, peak=90e9)
    rec["cost"]["bytes_traced_per_op"] = True
    rec["memory"]["peak_is_lower_bound"] = True
    row = roofline.analyze_cell("falcon-mamba-7b|prefill_32k|single|base",
                                rec)
    assert row["t_collective_s"] is None
    assert row["dominant"] in ("compute", "memory")
    sf, _ = roofline._ssm_scan_terms("falcon-mamba-7b", "prefill", 32768,
                                     32, 256)
    assert row["t_memory_s"] == 2.2e11 / roofline.HBM_BW
    assert row["hlo_flops_per_device"] == 3.1e13 + sf
    assert row["peak_is_lower_bound"] and not row["fits_80g"]
    card = _record("decode", 1, 1.0, collectives=False)
    card["measured"] = {"ms": 42.0}
    crow = roofline.analyze_cell("qwen2-0.5b|decode_32k|card|base", card)
    assert crow["measured_ms"] == 42.0
    assert crow["measured_vs_bound"] == pytest.approx(
        max(crow["t_compute_s"], crow["t_memory_s"]) * 1e3 / 42.0)
    table = roofline.markdown_table([row, crow])
    assert "| >=83.8 | N | - |" in table and "| 42.000 |" in table
    assert " | - | **" in table        # the null collective term


def test_roofline_states_the_card():
    line = roofline.constants_line("NVIDIA H100 80GB HBM3, 700.00 W")
    assert "989 TFLOP/s bf16" in line and "3.35 TB/s" in line
    assert "450 GB/s NVLink" in line and "700.00 W" in line
    assert "card: none" in roofline.constants_line(None)
