"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400; MLA kv_lora=512, q_lora=1536, qk 128 nope + 64 rope, v 128;
MoE 2 shared + 160 routed top-6.  [arXiv:2405.04434; hf]

Deviation noted in DESIGN.md: DSv2's first dense layer is made MoE so the
stack stays scan-homogeneous.  Full attention -> long_500k skipped.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288, vocab_size=102400, attention="mla", activation="swiglu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
    subquadratic=False)
