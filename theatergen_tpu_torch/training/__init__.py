"""Diffusion training: the noise-prediction loss, the optax-equivalent
optimizer, the train step with its trainable filter (adapter finetuning,
e.g. the IP-Adapter projections, or the full UNet), EMA and checkpoints,
on one device."""
