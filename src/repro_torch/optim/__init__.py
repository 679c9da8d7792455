"""Optimizers of the port: AdamW (the JAX package's ``optim/adamw.py``).
Adafactor and gradient compression are queued in ROADMAP.md."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    schedule,
)
