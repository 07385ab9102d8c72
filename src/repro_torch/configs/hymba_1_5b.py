"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba heads fused with
per-branch output norms.  [arXiv:2411.13676; hf]

Sliding-window attention (all layers; the paper's 3 global layers are
noted as a deviation) + SSM branch -> sub-quadratic: long_500k RUNS.
Meta tokens are omitted (frontend stub).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, activation="swiglu", sliding_window=1024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    hybrid_parallel_ssm=True, subquadratic=True)
