"""The system under test, as the benchmark builds it: the port's model for
a configuration file's ``model`` section, with the benchmark's weights laid
into the parameter structure the port's own init gives."""

from __future__ import annotations

import torch

from portbench.harness import weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(m: dict):
    """The port's ``ModelConfig`` of the configuration as it is run."""
    from repro_torch.configs import base

    ssm = m.get("ssm")
    return base.ModelConfig(**{**m, "ssm": ssm and base.SSMConfig(**ssm)})


def build(m: dict, reference, seed: int, device, requires_grad: bool):
    """(model, params, flat weights buffer, parameter shapes): the port's
    ``Model`` for ``m`` and its parameters, drawn from ``seed`` in
    ``m["param_dtype"]`` on ``device``."""
    from repro_torch.models import build_model

    cfg = model_config(m)
    model = build_model(cfg, device)
    shapes = reference.param_shapes(m)
    flat, views = weights.draw(shapes, m, DTYPES[m["param_dtype"]], seed, device)
    meta = build_model(cfg, "meta").init(torch.Generator())
    params = weights.lay_into(meta, views, requires_grad)
    return model, params, flat, shapes


def reference_weights(m: dict, reference, seed: int, device):
    """The same weights again, drawn anew from ``seed`` in the dtype the
    cell runs and widened to float32 for the reference: (flat, {name: view})."""
    shapes = reference.param_shapes(m)
    flat, _ = weights.draw(shapes, m, DTYPES[m["param_dtype"]], seed, device)
    flat = flat.float()
    return flat, weights.views_of(flat, shapes)
