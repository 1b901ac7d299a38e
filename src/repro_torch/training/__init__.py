"""Training on the port: the synthetic data pipeline, AdamW, atomic
checkpoints and the restart-safe loop (the reference's
``repro.training``)."""

from repro_torch.training.optimizer import adamw_init, adamw_update
