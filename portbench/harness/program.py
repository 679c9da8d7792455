"""The system under test, as the benchmark builds it: the port's model for
a configuration file's ``model`` section, with the benchmark's weights laid
into the parameter structure the port's own init gives."""

from __future__ import annotations

import importlib

import torch

from portbench.harness import weights
from portbench.harness.spec import SpecError

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def config_type(spec: str):
    """The class ``"<module>:<qualname>"`` names: a subclass of the port's
    pinned ``ModelConfig``, from anywhere but the JAX package."""
    from repro_torch.configs import base

    module, _, qualname = spec.partition(":")
    if module.split(".")[0] == "repro":
        raise SpecError(f"model.type {spec!r}: a type of the JAX package")
    try:
        cls = importlib.import_module(module)
        for part in qualname.split("."):
            cls = getattr(cls, part)
    except (ImportError, AttributeError, ValueError) as e:
        raise SpecError(f"model.type {spec!r}: {e}") from e
    if not (isinstance(cls, type) and issubclass(cls, base.ModelConfig)):
        raise SpecError(f"model.type {spec!r}: not a subclass of ModelConfig")
    return cls


def model_config(m: dict):
    """The port's configuration of the model as it is run: of the class
    ``m["type"]`` names (``Type.from_dict`` where it defines one), else a
    ``ModelConfig``; the section's other keys are its fields."""
    from repro_torch.configs import base

    m = dict(m)
    cls = config_type(m.pop("type")) if "type" in m else base.ModelConfig
    if hasattr(cls, "from_dict"):
        return cls.from_dict(m)
    ssm = m.get("ssm")
    return cls(**{**m, "ssm": ssm and base.SSMConfig(**ssm)})


def build(m: dict, reference, seed: int, device, requires_grad: bool,
          own_rules: dict | None = None):
    """(model, params, flat weights buffer, parameter shapes): the port's
    ``Model`` for ``m`` and its parameters, drawn from ``seed`` in
    ``m["param_dtype"]`` on ``device`` by the frozen init rules and the
    configuration's ``own_rules``."""
    from repro_torch.models import build_model

    cfg = model_config(m)
    model = build_model(cfg, device)
    shapes = reference.param_shapes(m)
    flat, views = weights.draw(shapes, m, DTYPES[m["param_dtype"]], seed,
                               device, own_rules)
    meta = build_model(cfg, "meta").init(torch.Generator())
    params = weights.lay_into(meta, views, requires_grad)
    return model, params, flat, shapes


def reference_weights(m: dict, reference, seed: int, device,
                      own_rules: dict | None = None):
    """The same weights again, drawn anew from ``seed`` in the dtype the
    cell runs and widened to float32 for the reference: (flat, {name: view})."""
    shapes = reference.param_shapes(m)
    flat, _ = weights.draw(shapes, m, DTYPES[m["param_dtype"]], seed, device,
                           own_rules)
    flat = flat.float()
    return flat, weights.views_of(flat, shapes)
