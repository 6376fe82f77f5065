"""H2O-Danube3-4B [arXiv:2401.16818; unverified]: llama+mistral mix, 24L,
d=3840, 32H GQA(kv=8), d_ff=10240, vocab 32000, sliding-window attn."""
from repro_torch.models.common import LayerKind, ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    segments=uniform_segments(LayerKind("gqa", "dense"), 24),
    window=4096,
    rope_theta=1e4,
)
