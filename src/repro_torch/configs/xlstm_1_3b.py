"""xLSTM-1.3B [arXiv:2405.04517; unverified]: 48 blocks, d=2048, 4 heads,
xLSTM[7:1] (7 mLSTM : 1 sLSTM), no separate FFN (d_ff=0; block-internal
projections: mLSTM 2x up, sLSTM 4/3 post-FFN)."""
from repro_torch.models.common import LayerKind, ModelConfig

_PATTERN = tuple([LayerKind("mlstm", "none")] * 7 + [LayerKind("slstm", "none")])

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab=50304,
    segments=((_PATTERN, 6),),
    xlstm_proj_factor=1.5,   # sized to hit ~1.3-1.4B total (see DESIGN.md §4)
    tie_embeddings=True,
)
