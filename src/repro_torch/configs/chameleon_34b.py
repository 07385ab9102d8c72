"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early fusion, VQ image tokens share the text vocab (the
modality frontend is a stub: inputs are token ids over the fused vocab).
[arXiv:2405.09818; unverified]  Full attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536, activation="swiglu",
    subquadratic=False,
    notes="early-fusion VQ image tokens; frontend stubbed per spec")
