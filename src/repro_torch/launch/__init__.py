"""Launch tooling of the port: step builders and the serve entry point."""

from repro_torch.launch.steps import (  # noqa: F401
    make_prefill_step,
    make_serve_step,
    make_train_state,
    make_train_step,
)
