"""Yi-6B [arXiv:2403.04652; hf]: llama-arch GQA, 32L, d=4096, 32H GQA(kv=4),
d_ff=11008, vocab 64000."""
from repro_torch.models.common import LayerKind, ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab=64000,
    segments=uniform_segments(LayerKind("gqa", "dense"), 32),
    rope_theta=5e6,
)
