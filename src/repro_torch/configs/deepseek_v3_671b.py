"""DeepSeek-V3 671B [arXiv:2412.19437; hf]: 61L (3 dense + 58 MoE), d=7168,
128H MLA, expert d_ff=2048, vocab 129280, 1 shared + 256 routed top-8
(sigmoid router, aux-loss-free), MTP."""
from repro_torch.models.common import LayerKind, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,                      # the 3 dense layers
    vocab=129280,
    segments=(
        ((LayerKind("mla", "dense"),), 3),
        ((LayerKind("mla", "moe"),), 58),
    ),
    moe=MoEConfig(
        n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
        router="sigmoid", aux_coef=0.0,
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_dim=128),
    rope_theta=1e4,
    mtp=True,
)
