"""Launch tooling of the port: step builders and the serve entry point."""

from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: F401
