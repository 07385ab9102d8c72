"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407;
unverified]  Full attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768, activation="swiglu", rope_theta=1e6,
    subquadratic=False)
