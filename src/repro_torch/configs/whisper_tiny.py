"""Whisper-tiny [arXiv:2212.04356; unverified]: enc-dec, 4+4L, d=384, 6H MHA,
d_ff=1536, vocab 51865. Conv frontend is a STUB — input_specs() supplies
precomputed (B, 1500, 384) frame embeddings (per the assignment contract)."""
from repro_torch.models.common import LayerKind, ModelConfig, uniform_segments

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    segments=uniform_segments(LayerKind("gqa", "dense", cross=True), 4),
    encoder_layers=4,
    encoder_frames=1500,
    tie_embeddings=True,
)
