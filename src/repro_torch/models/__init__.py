from repro_torch.models.registry import Model, build_model  # noqa: F401
