"""Mixtral-8x7B [arXiv:2401.04088; hf]: 32L, d=4096, 32H GQA(kv=8),
d_ff=14336/expert, vocab 32000, MoE 8 experts top-2, sliding-window attn."""
from repro_torch.models.common import LayerKind, ModelConfig, MoEConfig, uniform_segments

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    segments=uniform_segments(LayerKind("gqa", "moe"), 32),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    window=4096,
    rope_theta=1e6,
)
