"""falcon-mamba-7b [ssm] — 64L d_model=4096, attention-free mamba-1
blocks, ssm_state=16, vocab=65024.  [arXiv:2410.05355; unverified]
Attention-free -> long_500k RUNS."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=65024, attention="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    subquadratic=True)
