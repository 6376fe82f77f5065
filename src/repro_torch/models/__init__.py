"""LM substrate of the port (dense GQA serving): ``common`` (configs,
initialisers, RoPE), ``attention`` (GQA with its caches), ``ffn`` (dense
MLPs), ``lm`` (the :class:`~repro_torch.models.lm.LM` module and its entry
points) and ``convert`` (the reference's parameters into the port)."""
