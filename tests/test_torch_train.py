"""The port's training substrate (``repro_torch.train``: data, optimizer,
checkpoint, fault, ``cross_entropy``) and its two training twins against
the reference's, on the CPU.

State crosses through numpy (``interop.lm_params_from_numpy``,
``interop.train_state_from_numpy``); the reference runs with jax's x64
mode off, as its own LM tests run alone.  Tolerances:

* ``batch_at``: bitwise, host shards and ``enc_feats`` included;
* ``cross_entropy`` with masked labels: within 1e-6 relative;
* ``apply_updates`` over 3 steps fed the same gradients (clipped and not):
  params, ``mu``, ``nu``, ``step`` and ``grad_norm`` within 1e-6 of each
  leaf's largest magnitude;
* ``compress_grads``: ``q`` bitwise, scales and error feedback within 1e-6;
* checkpoints: ``_tree_hash`` equal, each package restores the other's
  checkpoint bitwise, the corrupt one is skipped, pruning keeps ``keep``;
* ``run_with_restarts`` as ``tests/test_fault_tolerance.py`` runs it
  (qwen2 ``reduced()``, f32, 10 steps, a save every 3, ``fail_at=(4, 8)``):
  2 restarts, ``resumed_from == [3, 6]``, losses equal to the clean run at
  ``rtol=1e-6``; the port's clean losses within 1e-3 of the reference's
  ``_driver`` from the same params (measured: 1.6e-7 relative);
* ``StragglerMonitor``: the reference's flags and plan on the same
  durations;
* ``python -m repro_torch.train_lm`` and ``python -m
  repro_torch.launch.train`` run with ``--device cpu``.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import fault as RF  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro.train.data import DataConfig as RDataConfig  # noqa: E402
from repro.train.data import SyntheticTokens as RSyntheticTokens  # noqa

from repro_torch import train_lm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import lm_params_from_numpy, \
    train_state_from_numpy  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import steps as S  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.train.fault import StragglerMonitor, \
    run_with_restarts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
REL = 1e-6


def X32():
    return jax.enable_x64(False)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_params(seed=0):
    with X32():
        return jax.jit(RT.init_lm, static_argnums=0)(
            get_config(ARCH).reduced(), jax.random.key(seed))


def _leaf_rel(got, want) -> float:
    """max |got - want| over the leaf's largest |want|."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    return float(err / scale) if scale else float(err)


def _assert_tree_rel(got, want, rel):
    got = dict(T.tree_leaves_with_path(got))
    want = dict(T.tree_leaves_with_path(_np_tree(want)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert _leaf_rel(got[k], w) <= rel, ("/".join(k),
                                             _leaf_rel(got[k], w))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,host_id,num_hosts,enc", [
    (0, 0, 0, 1, 0), (3, 7, 0, 1, 0), (1, 123456, 1, 2, 0),
    (2, 5, 3, 4, 0), (0, 2, 0, 1, 16), (5, 9, 1, 2, 8)])
def test_batch_at_is_bitwise_the_references(seed, step, host_id, num_hosts,
                                            enc):
    kw = dict(vocab_size=300, global_batch=8, seq_len=13, seed=seed,
              host_id=host_id, num_hosts=num_hosts, enc_frames=enc,
              d_model=24 if enc else 0)
    got = SyntheticTokens(DataConfig(**kw)).batch_at(step)
    want = RSyntheticTokens(RDataConfig(**kw)).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert got["tokens"].dtype == np.int32
    assert ("enc_feats" in got) == bool(enc)
    it = iter(SyntheticTokens(DataConfig(**kw)))
    for i in range(2):
        np.testing.assert_array_equal(
            next(it)["labels"],
            RSyntheticTokens(RDataConfig(**kw)).batch_at(i)["labels"])


# ---------------------------------------------------------------------------
# cross-entropy and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [0, 5, 24])
def test_cross_entropy_matches_with_masked_labels(masked):
    rng = np.random.default_rng(masked)
    logits = (rng.standard_normal((2, 12, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 12)).astype(np.int32)
    labels.reshape(-1)[rng.permutation(24)[:masked]] = -1
    with X32():
        want = float(RS.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels)))
    got = float(S.cross_entropy(torch.as_tensor(logits),
                                torch.as_tensor(labels)))
    assert abs(got - want) <= REL * max(abs(want), 1e-30), (got, want)
    if masked == 24:
        assert got == 0.0 == want
    # bf16 logits are upcast first, as the reference's
    half = torch.as_tensor(logits).bfloat16()
    assert float(S.cross_entropy(half, torch.as_tensor(labels))) == \
        float(S.cross_entropy(half.float(), torch.as_tensor(labels)))


def _grads(params_np, rng, std):
    return {k: _grads(v, rng, std) if isinstance(v, dict)
            else (rng.standard_normal(v.shape) * std).astype(np.float32)
            for k, v in params_np.items()}


@pytest.mark.parametrize("std", [1.0, 1e-4], ids=["clipped", "unclipped"])
def test_apply_updates_matches_over_three_steps(std):
    """The same gradients into both packages' ``apply_updates`` for 3
    steps (warmup 2, so the schedule moves): params, moments, step and the
    global norm."""
    cfg = O.AdamWConfig(lr=1e-3, warmup_steps=2)
    rcfg = RO.AdamWConfig(lr=1e-3, warmup_steps=2)
    ref = _ref_params()
    with X32():
        rstate = RO.init_opt_state(ref)
    params = lm_params_from_numpy(_np_tree(ref), device="cpu")
    state = O.init_opt_state(params)
    assert state["step"].dtype == torch.int32 and state["step"].ndim == 0
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = _grads(_np_tree(ref), rng, std)
        with X32():
            ref, rstate, rnorm = jax.jit(RO.apply_updates, static_argnums=3)(
                ref, jax.tree_util.tree_map(jnp.asarray, g), rstate, rcfg)
        params, state, norm = O.apply_updates(
            params, lm_params_from_numpy(g, device="cpu"), state, cfg)
        assert _leaf_rel(norm, np.asarray(rnorm)) <= REL
        assert int(state["step"]) == int(rstate["step"])
        _assert_tree_rel(params, ref, REL)
        _assert_tree_rel(state["mu"], rstate["mu"], REL)
        _assert_tree_rel(state["nu"], rstate["nu"], REL)
    assert (float(norm) > cfg.grad_clip) == (std == 1.0)


def test_adamw_config_and_schedule_equal_the_references():
    import dataclasses
    assert dataclasses.asdict(O.AdamWConfig()) == \
        dataclasses.asdict(RO.AdamWConfig())
    cfg = O.AdamWConfig(warmup_steps=7)
    for s in (0, 3, 6, 7, 50):
        with X32():
            want = float(RO._schedule(RO.AdamWConfig(warmup_steps=7),
                                      jnp.asarray(s, jnp.int32)))
        got = float(O._schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= REL * want


def test_compress_grads_matches_with_error_feedback():
    """Two rounds (the second fed the first's residual): ``q`` bitwise,
    scales, residuals and the decompressed gradients within 1e-6."""
    ref = _ref_params(1)
    rng = np.random.default_rng(0)
    g1, g2 = _grads(_np_tree(ref), rng, 1.0), _grads(_np_tree(ref), rng, 0.3)
    with X32():
        rerr = RO.init_error_feedback(ref)
        rq1, rerr = RO.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, g1), rerr)
        rq2, rerr = RO.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, g2), rerr, chunk=100)
        rdeq = RO.decompress_grads(rq2)
    params = lm_params_from_numpy(_np_tree(ref), device="cpu")
    err = O.init_error_feedback(params)
    q1, err = O.compress_grads(lm_params_from_numpy(g1, device="cpu"), err)
    q2, err = O.compress_grads(lm_params_from_numpy(g2, device="cpu"), err,
                               chunk=100)
    deq = O.decompress_grads(q2)
    is_q = lambda x: isinstance(x, dict) and "q" in x  # noqa: E731
    for got, want in ((q1, rq1), (q2, rq2)):
        want = jax.tree_util.tree_leaves(want, is_leaf=is_q)
        got = [leaf for leaf in _q_leaves(got)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["q"].dtype == torch.int8 and \
                tuple(g["shape"]) == tuple(w["shape"])
            np.testing.assert_array_equal(g["q"].numpy(), np.asarray(w["q"]))
            assert _leaf_rel(g["scale"], np.asarray(w["scale"])) <= REL
    _assert_tree_rel(err, rerr, REL)
    _assert_tree_rel(deq, rdeq, REL)


def _q_leaves(tree):
    """The ``{q, scale, shape}`` dicts of a compressed tree, in jax's
    order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and "q" in v:
            yield v
        else:
            yield from _q_leaves(v)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_train_state():
    """The reference's state after one AdamW step (non-zero moments,
    ``step`` 1) with a ``loss`` leaf, as ``tests/test_fault_tolerance.py``
    saves it."""
    ref = _ref_params()
    rng = np.random.default_rng(3)
    with X32():
        opt = RO.init_opt_state(ref)
        g = jax.tree_util.tree_map(jnp.asarray, _grads(_np_tree(ref), rng,
                                                       1.0))
        ref, opt, _ = jax.jit(RO.apply_updates, static_argnums=3)(
            ref, g, opt, RO.AdamWConfig())
        return {"params": ref, "opt": opt,
                "loss": jnp.asarray(2.5, jnp.float32)}


def _bitwise(got, want):
    got = dict(T.tree_leaves_with_path(got))
    want = dict(T.tree_leaves_with_path(_np_tree(want)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
        np.testing.assert_array_equal(g.numpy(), w, err_msg="/".join(k))


def test_tree_hash_and_flat_keys_equal_the_references():
    rstate = _ref_train_state()
    state = train_state_from_numpy(_np_tree(rstate), device="cpu")
    assert state["opt"]["step"].dtype == torch.int32
    flat, rflat = C._flatten(state), RC._flatten(rstate)
    assert list(flat) == list(rflat)
    assert "params/blocks/attn/wq" in flat and "opt/step" in flat
    assert C._tree_hash(flat) == RC._tree_hash(rflat)


def test_checkpoints_cross_both_ways_bitwise(tmp_path):
    rstate = _ref_train_state()
    state = train_state_from_numpy(_np_tree(rstate), device="cpu")
    RC.CheckpointManager(str(tmp_path / "ref")).save(4, rstate,
                                                     extra={"k": 1})
    got = C.CheckpointManager(str(tmp_path / "ref")).restore_latest(
        T.tree_map(torch.zeros_like, state))
    assert got[0] == 4 and got[2] == {"k": 1}
    _bitwise(got[1], rstate)

    C.CheckpointManager(str(tmp_path / "port")).save(5, state,
                                                     extra={"k": 2})
    with X32():
        template = jax.tree_util.tree_map(jnp.zeros_like, rstate)
        back = RC.CheckpointManager(str(tmp_path / "port")).restore_latest(
            template)
    assert back[0] == 5 and back[2] == {"k": 2}
    _bitwise(T.tree_map(lambda a: torch.as_tensor(np.array(a)),
                        _np_tree(back[1])), rstate)
    metas = [json.loads(p.read_text()) for p in
             (tmp_path / "ref" / "ckpt_00000004.json",
              tmp_path / "port" / "ckpt_00000005.json")]
    assert metas[0]["hash"] == metas[1]["hash"]
    assert metas[1]["n_arrays"] == metas[0]["n_arrays"]
    assert metas[1]["mesh_devices"] == 1


def test_restore_puts_leaves_at_the_templates_dtype(tmp_path):
    state = train_state_from_numpy(_np_tree(_ref_train_state()),
                                   device="cpu")
    mgr = C.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    template = T.tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float64)
                          if a.is_floating_point() else a, state)
    step, got, extra = mgr.restore(1, template)
    assert step == 1 and extra == {}
    assert got["params"]["embed"].dtype == torch.float64
    assert got["opt"]["step"].dtype == torch.int32
    np.testing.assert_array_equal(got["params"]["embed"].float().numpy(),
                                  state["params"]["embed"].numpy())


def test_corrupt_and_partial_checkpoints_are_skipped_and_pruned(tmp_path):
    state = train_state_from_numpy(_np_tree(_ref_train_state()),
                                   device="cpu")
    mgr = C.CheckpointManager(str(tmp_path), keep=3)
    for s in (1, 2, 3, 4):
        mgr.save(s, T.tree_map(lambda a, s=s: a + s if a.is_floating_point()
                               else a, state))
    assert mgr.available_steps() == [2, 3, 4]           # pruned to keep
    assert not (tmp_path / "ckpt_00000001.npz").exists()
    npz, _ = mgr._paths(4)
    with open(npz, "r+b") as f:                  # as the reference's test
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef" * 8)
    assert mgr.restore(4, state) is None
    step, got, _ = mgr.restore_latest(state)
    assert step == 3
    np.testing.assert_array_equal(got["loss"].numpy(),
                                  state["loss"].numpy() + 3)
    os.remove(mgr._paths(3)[0])                  # a save cut before its npz
    assert mgr.restore_latest(state)[0] == 2
    with open(mgr._paths(2)[0], "r+b") as f:     # a flipped payload byte
        f.seek(-64, os.SEEK_END)
        b = f.read(1)
        f.seek(-64, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    assert mgr.restore_latest(state) is None
    # the reference skips the same ones
    with X32():
        assert RC.CheckpointManager(str(tmp_path)).restore_latest(
            _ref_train_state()) is None


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

CFG = registry.get_config(ARCH).reduced()
OPT = O.AdamWConfig(lr=1e-3)


def _data():
    return SyntheticTokens(DataConfig(vocab_size=CFG.vocab_size,
                                      global_batch=2, seq_len=17))


def _port_run(tmp_path, params_np, fail_at=(), total=10, save_every=3):
    """``tests/test_fault_tolerance.py``'s ``_driver`` on the port, from
    the reference's params."""
    data = _data()
    step_fn = S.make_train_step(CFG, OPT, cdt=torch.float32, device="cpu")

    def init_state():
        params = lm_params_from_numpy(params_np, device="cpu")
        return {"params": params, "opt": O.init_opt_state(params),
                "loss": torch.zeros(())}

    def step_fn_(state, step):
        p, o, m = step_fn(state["params"], state["opt"], data.batch_at(step))
        return {"params": p, "opt": o, "loss": m["loss"]}

    ckpt = C.CheckpointManager(str(tmp_path), keep=2)
    return run_with_restarts(init_state, step_fn_, lambda s: float(s["loss"]),
                             ckpt, total, save_every=save_every,
                             fail_at=fail_at), ckpt


def _ref_clean_losses(tmp_path, total=10):
    """The reference's ``_driver`` (clean), as ``tests/test_fault_tolerance
    .py`` builds it."""
    cfg = get_config(ARCH).reduced()
    data = RSyntheticTokens(RDataConfig(vocab_size=cfg.vocab_size,
                                        global_batch=2, seq_len=17))
    with X32():
        step_jit = jax.jit(RS.make_train_step(cfg, RO.AdamWConfig(lr=1e-3),
                                              cdt=jnp.float32))

        def init_state():
            params = RT.init_lm(cfg, jax.random.key(0))
            return {"params": params, "opt": RO.init_opt_state(params),
                    "loss": jnp.zeros(())}

        def step_fn(state, step):
            batch = {k: jnp.asarray(v) for k, v in
                     data.batch_at(step).items()}
            p, o, m = step_jit(state["params"], state["opt"], batch)
            return {"params": p, "opt": o, "loss": m["loss"]}

        rep = RF.run_with_restarts(init_state, step_fn,
                                   lambda s: float(s["loss"]),
                                   RC.CheckpointManager(str(tmp_path), keep=2),
                                   total, save_every=3)
    return rep.losses


def test_restart_reproduces_uninterrupted_run_and_the_reference(tmp_path):
    params_np = _np_tree(_ref_params())
    clean, _ = _port_run(tmp_path / "clean", params_np)
    faulty, ckpt = _port_run(tmp_path / "faulty", params_np,
                                fail_at=(4, 8))
    assert faulty.restarts == 2
    assert faulty.resumed_from == [3, 6]
    np.testing.assert_allclose(clean.losses, faulty.losses, rtol=1e-6)
    assert ckpt.available_steps() == [9, 10]
    want = _ref_clean_losses(tmp_path / "ref")
    np.testing.assert_allclose(clean.losses, want, rtol=1e-3)
    # the port's restart resumes from the reference's own checkpoint
    rdir = tmp_path / "ref"
    resumed, _ = _port_run(rdir, params_np)
    assert resumed.resumed_from == [10] and resumed.final_step == 10


def test_failures_past_max_restarts_raise(tmp_path):
    """A failure past ``max_restarts`` propagates."""
    from repro_torch.train.fault import SimulatedFailure
    assert issubclass(SimulatedFailure, RuntimeError)
    with pytest.raises(SimulatedFailure):
        run_with_restarts(
            lambda: {"x": torch.zeros(())}, lambda s, i: s,
            lambda s: 0.0, C.CheckpointManager(str(tmp_path / "m")), 4,
            save_every=10, fail_at=(0, 1), max_restarts=1)


def test_straggler_monitor_matches_the_reference():
    mon, rmon = StragglerMonitor(n_hosts=8), RF.StragglerMonitor(n_hosts=8)
    rng = np.random.default_rng(0)
    for i in range(20):
        d = rng.normal(1.0, 0.02, 8)
        if i in (10, 15):
            d[3 if i == 10 else 6] = 5.0
        flagged = mon.observe(d)
        assert flagged == rmon.observe(d)
        assert flagged == ([3] if i == 10 else [6] if i == 15 else [])
        assert mon.mitigate(flagged, 8) == rmon.mitigate(flagged, 8)
    assert mon.reassignments == rmon.reassignments == [3, 6]
    assert mon.history.shape == (16, 8)
    np.testing.assert_array_equal(mon.history, rmon.history)


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

def test_train_lm_twin_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.train_lm`` (the example's ~100M model) for
    one step, then in-process for two in the same directory: it resumes
    from step 1."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argv = ["--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    out = subprocess.run([sys.executable, "-m", "repro_torch.train_lm",
                          "--steps", "1"] + argv, capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "model: qwen2-0.5b-derived, 93.8M params"
    assert lines[1].startswith("step    0 | loss ")
    assert lines[-2] == "done."
    first = json.loads(lines[-1])
    assert first["device"] == "cpu" and first["start"] == 0
    assert len(first["losses"]) == 1 and np.isfinite(first["losses"][0])
    res = train_lm.main(["--steps", "2"] + argv)
    printed = capsys.readouterr().out.splitlines()
    assert "resumed from step 1" in printed and printed[-1] == "done."
    assert res["start"] == 1 and len(res["losses"]) == 1
    assert np.isfinite(res["losses"]).all() and res["tok_per_s"] > 0
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000001.json", "ckpt_00000001.npz", "ckpt_00000002.json",
        "ckpt_00000002.npz"]


def test_launch_train_twin_runs_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` at qwen2 ``reduced()``: the
    reference's lines; its losses are ``make_train_step``'s from the same
    params; a checkpoint every ``--save-every`` and a resume."""
    argv = ["--arch", ARCH, "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--save-every", "2"]
    res = launch_train.cli(["--steps", "3"] + argv)
    lines = capsys.readouterr().out.splitlines()
    assert res == 0
    assert lines[0].startswith(f"[launch] {ARCH}: ") and \
        lines[0].endswith("(reduced=True), devices=1")
    assert lines[1].startswith("[launch] step 0 loss=")
    assert lines[-2] == "[launch] done"
    out = json.loads(lines[-1])
    params = T.init_lm(CFG, 0, "cpu")
    step = S.make_train_step(CFG, O.AdamWConfig(lr=1e-3), torch.float32,
                             device="cpu")
    data = SyntheticTokens(DataConfig(vocab_size=CFG.vocab_size,
                                      global_batch=2, seq_len=17))
    opt = O.init_opt_state(params)
    want = []
    for i in range(3):
        params, opt, m = step(params, opt, data.batch_at(i))
        want.append(float(m["loss"]))
    assert out["losses"] == want
    assert C.CheckpointManager(str(tmp_path)).available_steps() == [2, 3]
    again = launch_train.main(["--steps", "4"] + argv)
    assert again["start"] == 3 and len(again["losses"]) == 1
    assert "[launch] resumed from step 3" in capsys.readouterr().out
