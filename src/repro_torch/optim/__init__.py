"""Optimizers of the port: AdamW (the JAX package's ``optim/adamw.py``) and
Adafactor (``optim/adafactor.py``); gradient compression is
``optim/compression.py``."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    schedule,
)
from repro_torch.optim.adafactor import (  # noqa: F401
    AdafactorConfig,
    adafactor_update,
    init_adafactor_state,
    state_bytes,
)
