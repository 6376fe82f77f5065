"""Optimizers of the port: AdamW (:mod:`repro_torch.optim.adamw`)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm  # noqa: F401
