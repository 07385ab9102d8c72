"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias, tied embeddings.  [arXiv:2407.10671; hf]
Full attention -> long_500k skipped."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936, activation="swiglu", qkv_bias=True,
    tie_embeddings=True, subquadratic=False)
