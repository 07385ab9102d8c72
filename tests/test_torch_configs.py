"""The port's LM config zoo (``repro_torch.models.config`` and
``repro_torch.configs``) against ``repro``'s, field by field: every
architecture's config and its ``reduced()`` form, the registry's order,
the shape cells and the applicability table (the twin of
``tests/test_arch_smoke.py::test_long_context_applicability_table``).
Pure data: nothing here touches torch."""
import dataclasses

import pytest

from repro.configs import registry as ref_registry
from repro.models import config as ref_config

from repro_torch.configs import registry
from repro_torch.models import config


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_config_and_reduced_equal_the_reference(arch):
    got, want = registry.get_config(arch), ref_registry.get_config(arch)
    assert type(got) is config.ModelConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert got.resolved_head_dim == want.resolved_head_dim
    if got.ssm is not None:
        assert got.ssm.resolved_dt_rank(got.d_model) == \
            want.ssm.resolved_dt_rank(want.d_model)


def test_registry_and_shapes_equal_the_reference():
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert all(m.startswith("repro_torch.configs.")
               for m in registry._MODULES.values())
    assert list(registry.all_configs()) == list(ref_registry.ARCH_IDS)
    assert [dataclasses.asdict(s) for s in config.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in ref_config.LM_SHAPES]
    for s in ref_config.LM_SHAPES:
        assert dataclasses.asdict(config.shape_by_name(s.name)) == \
            dataclasses.asdict(s)


def test_cell_applicability_equals_the_reference():
    got = {(a, s.name): config.cell_applicable(registry.get_config(a), s)
           for a in registry.ARCH_IDS for s in config.LM_SHAPES}
    want = {(a, s.name): ref_config.cell_applicable(
        ref_registry.get_config(a), s)
        for a in ref_registry.ARCH_IDS for s in ref_config.LM_SHAPES}
    assert len(got) == 40 and got == want
    runs = {a: got[(a, "long_500k")][0] for a in registry.ARCH_IDS}
    assert runs == {
        "llama4-maverick-400b-a17b": False, "deepseek-v2-236b": False,
        "hymba-1.5b": True, "mistral-large-123b": False,
        "phi4-mini-3.8b": False, "gemma-7b": False, "qwen2-0.5b": False,
        "chameleon-34b": False, "falcon-mamba-7b": True,
        "whisper-small": False}


def test_errors_and_frozen_instances():
    with pytest.raises(KeyError):
        config.shape_by_name("train_8k")
    with pytest.raises(ValueError, match="repro_torch.configs.elasticity"):
        registry.get_config("elasticity")
    with pytest.raises(KeyError):
        registry.get_config("gpt-2")
    cfg = registry.get_config("qwen2-0.5b")
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.n_layers = 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        config.LM_SHAPES[0].seq_len = 1
    assert config.SSMConfig().resolved_dt_rank(4096) == 256
    assert config.SSMConfig(dt_rank=7).resolved_dt_rank(4096) == 7


def test_arch_modules_keep_the_reference_docstrings():
    import importlib
    for arch in registry.ARCH_IDS:
        mod = importlib.import_module(registry._MODULES[arch])
        ref = importlib.import_module(ref_registry._MODULES[arch])
        assert mod.__doc__ == ref.__doc__
