"""TinyLlama-1.1B [arXiv:2401.02385; hf]: llama2-arch small, 22L, d=2048,
32H GQA(kv=4), d_ff=5632, vocab 32000."""
from repro_torch.models.common import LayerKind, ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    segments=uniform_segments(LayerKind("gqa", "dense"), 22),
    rope_theta=1e4,
)
