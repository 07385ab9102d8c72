"""The port's kernel autotuner (``repro_torch.kernels.autotune``) against
the JAX package's (``repro.kernels.autotune``): the mode knob, the cache
keys and families, the mode ladder, the cache round trip, a tiny sweep of
the plain versions, the machine key that keeps CPU winners off the card,
the CLI, and the ``threads`` knob of every tuned front door."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import autotune as ref_autotune  # noqa: E402
from repro.kernels import backend as ref_backend  # noqa: E402

from repro_torch.kernels import autotune, backend  # noqa: E402
from repro_torch.kernels.block_spmm import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.block_spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.fused_pair_gemm import ops as gemm_ops  # noqa
from repro_torch.kernels.fused_smoother import ops as smooth_ops  # noqa
from repro_torch.kernels.pbjacobi import ops as pbj_ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIG = autotune.signature(torch.float64, 32, br=3, bc=3, kmax=4)
MODES = [None, "off", "0", "", "false", "none", "cache", "on", "1", "true",
         "sweep", " Off ", "SWEEP"]


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path, monkeypatch):
    """Every test here writes only to its own cache file."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_TORCH_TUNE", raising=False)
    autotune.clear_memo()
    yield path
    autotune.clear_memo()


@pytest.mark.parametrize("mode", MODES, ids=[repr(m) for m in MODES])
def test_resolve_tune_maps_like_the_reference(monkeypatch, mode):
    for var in ("REPRO_TUNE", "REPRO_TORCH_TUNE"):
        if mode is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, mode)
    assert backend.resolve_tune(None) == ref_backend.resolve_tune(None)
    assert backend.resolve_tune(mode) == ref_backend.resolve_tune(mode)


@pytest.mark.parametrize("mode", ["fastest", "2", "sweeps"])
def test_resolve_tune_raises_where_the_reference_raises(monkeypatch, mode):
    with pytest.raises(ValueError):
        ref_backend.resolve_tune(mode)
    with pytest.raises(ValueError, match="REPRO_TORCH_TUNE"):
        backend.resolve_tune(mode)
    monkeypatch.setenv("REPRO_TORCH_TUNE", mode)
    with pytest.raises(ValueError):
        backend.resolve_tune(None)


@pytest.mark.parametrize("family,sig", [
    ("block_spmv", {"br": 3, "bc": 3, "kmax": 27, "dtype": "float64"}),
    ("block_spmm", {"br": 6, "bc": 6, "kmax": 490, "k": 16,
                    "dtype": "float64", "items": 16384}),
    ("pbjacobi", {"bs": 6, "dtype": "float64"}),
    ("fused_pair_gemm", {"br": 6, "bk": 3, "bc": 6, "kmax": 12,
                         "dtype": "float64"}),
])
def test_entry_key_is_the_references(family, sig):
    assert autotune.entry_key(family, sig) == \
        ref_autotune.entry_key(family, sig)


def test_families_match_the_reference_and_hold_the_default():
    assert set(autotune.CANDIDATES) == set(ref_autotune.CANDIDATES)
    for family, knobs in autotune.CANDIDATES.items():
        assert set(knobs) == {"threads"}, family
        assert autotune.DEFAULT_THREADS in knobs["threads"], family
        for t in knobs["threads"]:
            backend.check_threads(family, t)


@pytest.mark.parametrize("items,want", [(0, 1), (1, 1), (2, 2), (3, 4),
                                        (836, 1024), (1024, 1024),
                                        (1025, 2048), (13376, 16384)])
def test_signature_rounds_items_up_to_a_power_of_two(items, want):
    sig = autotune.signature(torch.float64, items, bs=3)
    assert sig == {"bs": 3, "dtype": "float64", "items": want}


def test_cache_round_trip(tmp_cache):
    assert autotune.lookup("block_spmv", SIG, "threads", "cpu") is None
    p = autotune.record("block_spmv", SIG, {"threads": 64}, best_us=12.5,
                        device="cpu")
    assert p == tmp_cache and tmp_cache.exists()
    autotune.clear_memo()
    assert autotune.lookup("block_spmv", SIG, "threads", "cpu") == 64
    # merging a second signature keeps the first
    sig2 = dict(SIG, br=6, bc=6)
    autotune.record("block_spmv", sig2, {"threads": 512}, device="cpu")
    assert autotune.lookup("block_spmv", SIG, "threads", "cpu") == 64
    assert autotune.lookup("block_spmv", sig2, "threads", "cpu") == 512
    assert autotune.machine_key("cpu") in autotune.load_cache()


def test_resolve_param_mode_ladder(monkeypatch):
    # explicit request always wins
    monkeypatch.setenv("REPRO_TORCH_TUNE", "sweep")
    assert autotune.resolve_param("block_spmv", SIG, "threads", 128, 256,
                                  device="cpu") == 128
    # off -> static default even with a cached winner present
    autotune.record("block_spmv", SIG, {"threads": 64}, device="cpu")
    monkeypatch.setenv("REPRO_TORCH_TUNE", "off")
    assert autotune.resolve_param("block_spmv", SIG, "threads", None, 256,
                                  device="cpu") == 256
    # cache -> the winner
    monkeypatch.setenv("REPRO_TORCH_TUNE", "cache")
    assert autotune.resolve_param("block_spmv", SIG, "threads", None, 256,
                                  device="cpu") == 64
    # cache miss -> default (never sweeps)
    miss = dict(SIG, kmax=9)
    assert autotune.resolve_param("block_spmv", miss, "threads", None, 256,
                                  device="cpu") == 256
    assert autotune.lookup("block_spmv", miss, "threads", "cpu") is None


def test_off_touches_no_file(monkeypatch):
    """The port resolves at every launch: "off" returns before any cache
    read."""
    def boom(*a, **k):
        raise AssertionError("the cache was read in mode off")
    monkeypatch.setattr(autotune, "load_cache", boom)
    monkeypatch.setattr(autotune, "lookup", boom)
    monkeypatch.setenv("REPRO_TORCH_TUNE", "off")
    assert autotune.launch_threads("block_spmv", SIG, None, "cpu") == 256


def test_cache_file_is_stat_at_most_once_per_interval(monkeypatch,
                                                     tmp_cache):
    """Per-launch lookups do not each ``stat`` the file (a missing one
    included); a write by another process shows after ``RESTAT_S``."""
    calls = []
    real_stat = os.stat

    def counting_stat(path, *a, **k):
        calls.append(path)
        return real_stat(path, *a, **k)
    monkeypatch.setattr(autotune.os, "stat", counting_stat)
    monkeypatch.setattr(autotune, "RESTAT_S", 3600.0)
    for _ in range(50):
        assert autotune.lookup("block_spmv", SIG, "threads", "cpu") is None
    assert len(calls) == 1
    # another process writes the cache: unseen until the interval ends
    key = autotune.machine_key("cpu")
    tmp_cache.write_text('{"%s": {"%s": {"params": {"threads": 64}}}}' % (
        key, autotune.entry_key("block_spmv", SIG)))
    assert autotune.lookup("block_spmv", SIG, "threads", "cpu") is None
    monkeypatch.setattr(autotune, "RESTAT_S", 0.0)
    assert autotune.lookup("block_spmv", SIG, "threads", "cpu") == 64


def test_tiny_sweep_records_winner_used_by_resolution(monkeypatch):
    won = autotune.sweep("block_spmv", SIG, nbr=16, repeats=1, device="cpu")
    assert won["params"]["threads"] in \
        autotune.CANDIDATES["block_spmv"]["threads"]
    assert won["best_us"] > 0 and len(won["table"]) == 5
    autotune.clear_memo()
    monkeypatch.setenv("REPRO_TORCH_TUNE", "sweep")
    # the recorded winner satisfies sweep-mode resolution without
    # re-measuring (the cache hit short-circuits)
    monkeypatch.setattr(autotune, "sweep", None)
    assert autotune.resolve_param("block_spmv", SIG, "threads", None, 256,
                                  device="cpu") == won["params"]["threads"]


@pytest.mark.parametrize("family,sig", [
    ("block_spmm", autotune.signature(torch.float64, 64, br=3, bc=6, kmax=3,
                                      k=4)),
    ("pbjacobi", autotune.signature(torch.float64, 48, bs=6)),
    ("fused_smoother", autotune.signature(torch.float64, 16, br=6, bc=6,
                                          kmax=3)),
    ("fused_smoother", autotune.signature(torch.float64, 48, br=3, bc=3,
                                          kmax=3, k=3)),
    ("fused_pair_gemm", autotune.signature(torch.float64, 360, br=6, bk=3,
                                           bc=6, kmax=3)),
])
def test_sweep_mode_measures_a_miss_and_records_it(monkeypatch, family,
                                                   sig):
    monkeypatch.setenv("REPRO_TORCH_TUNE", "sweep")
    got = autotune.resolve_param(family, sig, "threads", None, 256,
                                 device="cpu")
    assert got in autotune.CANDIDATES[family]["threads"]
    autotune.clear_memo()
    assert autotune.lookup(family, sig, "threads", "cpu") == got


def test_cpu_winner_does_not_steer_the_card(monkeypatch):
    """Winners are keyed by device kind, and a card's kind carries the
    kernel sources' digest."""
    monkeypatch.setattr(autotune, "_card_kind",
                        lambda index: f"FakeCard|{backend.source_digest()}")
    card = torch.device("cuda", 0)
    assert autotune.machine_key("cpu").endswith("|cpu")
    assert autotune.machine_key(card).endswith(
        "|FakeCard|" + backend.source_digest())
    autotune.record("block_spmv", SIG, {"threads": 32}, device="cpu")
    assert autotune.lookup("block_spmv", SIG, "threads", card) is None
    monkeypatch.setenv("REPRO_TORCH_TUNE", "cache")
    assert autotune.resolve_param("block_spmv", SIG, "threads", None, 256,
                                  device=card) == 256
    autotune.record("block_spmv", SIG, {"threads": 512}, device=card)
    assert autotune.lookup("block_spmv", SIG, "threads", card) == 512
    assert autotune.lookup("block_spmv", SIG, "threads", "cpu") == 32


def test_reference_variables_do_not_reach_the_port(monkeypatch, tmp_path,
                                                   tmp_cache):
    monkeypatch.setenv("REPRO_TUNE", "off")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref.json"))
    assert backend.resolve_tune(None) == "cache"
    assert autotune.cache_path() == tmp_cache
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert autotune.cache_path() == (Path.home() / ".cache" / "repro_torch"
                                     / "autotune.json")
    monkeypatch.setenv("REPRO_TUNE", "bogus")
    assert backend.resolve_tune(None) == "cache"


def _cli(*args, tmp_cache):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_TUNE_CACHE=str(tmp_cache))
    return subprocess.run([sys.executable, "-m",
                           "repro_torch.kernels.autotune", *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_smoke_on_cpu(tmp_cache):
    out = _cli("smoke", "--device", "cpu", tmp_cache=tmp_cache)
    assert out.returncode == 0, out.stderr
    assert "autotune smoke OK" in out.stdout
    shown = _cli("show", "--device", "cpu", tmp_cache=tmp_cache)
    assert shown.returncode == 0, shown.stderr
    assert "block_spmv|bc=3,br=3,dtype=float64,items=32,kmax=4" in \
        shown.stdout


def test_cli_on_cuda_without_a_card_raises(tmp_cache):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli("smoke", tmp_cache=tmp_cache)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not tmp_cache.exists()


def _front_door_calls():
    rng = np.random.default_rng(5)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape))

    idx = torch.zeros((40, 2), dtype=torch.int32)
    mask = torch.ones((40, 2), dtype=torch.bool)
    a36, x6, x65 = t((40, 2, 3, 6)), t((1, 6)), t((1, 6, 5))
    sm = (idx, t((40, 2, 3, 3)), t((40, 3, 3)), t((40, 3, 4)),
          t((40, 3, 4)), t((40, 3, 4)), t((2,)))
    ga, gb = t((3, 6, 3)), t((2, 3, 6))
    dinv, r, x = t((40, 6, 6)), t(240), t(240)
    return {
        "block_spmv": (
            lambda **kw: spmv_ops.block_spmv_ell(idx, a36, x6, **kw),
            autotune.signature(torch.float64, 40, br=3, bc=6, kmax=2)),
        "block_spmm": (
            lambda **kw: spmm_ops.block_spmm_ell(idx, a36, x65, **kw),
            autotune.signature(torch.float64, 200, br=3, bc=6, kmax=2,
                               k=5)),
        "fused_smoother": (
            lambda **kw: smooth_ops.smoother_step_ell(*sm, **kw),
            autotune.signature(torch.float64, 160, br=3, bc=3, kmax=2, k=4)),
        "fused_pair_gemm": (
            lambda **kw: gemm_ops.fused_pair_gemm(ga, gb, idx, idx, mask,
                                                  **kw),
            autotune.signature(torch.float64, 40 * 36, br=6, bk=3, bc=6,
                               kmax=2)),
        "pbjacobi": (
            lambda **kw: pbj_ops.pbjacobi_apply(dinv, r, x, 0.7, **kw),
            autotune.signature(torch.float64, 240, bs=6)),
    }


@pytest.mark.parametrize("family", sorted(autotune.CANDIDATES))
def test_front_doors_resolve_threads_and_ignore_it_on_cpu(monkeypatch,
                                                          family):
    """``threads=None`` resolves through the ladder with the launch's own
    signature (here a cached winner); on CPU tensors the plain version
    ignores it; an invalid value raises."""
    call, sig = _front_door_calls()[family]
    autotune.record(family, sig, {"threads": 64}, device="cpu")
    monkeypatch.setenv("REPRO_TORCH_TUNE", "cache")
    seen = []
    orig = autotune.launch_threads

    def spy(fam, s, threads, device):
        out = orig(fam, s, threads, device)
        seen.append((fam, s, out))
        return out
    monkeypatch.setattr(autotune, "launch_threads", spy)
    tuned = call()
    assert seen == [(family, sig, 64)]
    static = call(threads=256)
    for a, b in zip(tuned if isinstance(tuned, tuple) else (tuned,),
                    static if isinstance(static, tuple) else (static,)):
        assert torch.equal(a, b)
    for bad in (48, 2048, 0):
        with pytest.raises(ValueError, match="multiple of 32"):
            call(threads=bad)
