"""InternVL2-2B [arXiv:2404.16821; hf]: InternViT (STUB frontend) +
InternLM2-1.8B backbone: 24L, d=2048, 16H GQA(kv=8), d_ff=8192, vocab 92553.
input_specs() supplies precomputed patch embeddings for the first
``n_patches`` positions of the sequence."""
from repro_torch.models.common import LayerKind, ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    segments=uniform_segments(LayerKind("gqa", "dense"), 24),
    n_patches=256,
    rope_theta=1e6,
)
