"""whisper-small [audio] — enc-dec, 12L decoder (+12L encoder),
d_model=768 12H d_ff=3072 vocab=51865; conv frontend is a STUB —
input_specs() provides precomputed frame embeddings (B, 1500, 768).
[arXiv:2212.04356; unverified]

Enc-dec (not encoder-only) -> decode shapes RUN (decoder + cross-attn
over cached encoder output); full attention -> long_500k skipped.
"""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865, activation="gelu",
    encdec=EncDecConfig(n_encoder_layers=12, encoder_frames=1500),
    subquadratic=False)
