"""Jamba-v0.1-52B [arXiv:2403.19887; hf]: 32L, d=4096, 32H GQA(kv=8),
d_ff=14336, vocab 65536; Mamba:attention 7:1 interleave (attention at
position 4 of each 8-layer period), MoE 16 experts top-2 on every other
layer."""
from repro_torch.models.common import LayerKind, ModelConfig, MoEConfig

_PERIOD = tuple(
    LayerKind("gqa" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    segments=((_PERIOD, 4),),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    mamba_d_state=16,
    mamba_expand=2,
    mamba_conv=4,
    rope_theta=1e4,
)
