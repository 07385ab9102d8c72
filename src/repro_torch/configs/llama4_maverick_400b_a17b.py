"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 routed top-1 + 1 shared expert, early
fusion (text/image token stub).  [hf:meta-llama/Llama-4-*; unverified]

Full attention -> long_500k skipped (DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048, activation="swiglu", rope_theta=5e5,
    moe=MoEConfig(n_experts=128, top_k=1, n_shared=1, d_ff_expert=8192,
                  moe_every=2),   # interleaved dense/MoE (400B total,
    #                               17B active; all-MoE would be ~780B)
    subquadratic=False,
    notes="early-fusion multimodal; image tokens share the vocab (stub)")
