"""DeepSeek-7B [arXiv:2401.02954; hf]: llama-arch, 30L, d=4096, 32H MHA
(kv=32), d_ff=11008, vocab 102400."""
from repro_torch.models.common import LayerKind, ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=102400,
    segments=uniform_segments(LayerKind("gqa", "dense"), 30),
    rope_theta=1e4,
)
