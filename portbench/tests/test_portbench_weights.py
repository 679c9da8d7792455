"""A configuration's own init rules and config type: a new kind of
parameter drawn by the configuration's rule, a clash with the frozen table
and a type from the JAX package or outside ``ModelConfig`` refused, and
phi3's configuration and weights exactly as the harness built them before
either key existed."""

import dataclasses
import hashlib
import json

import pytest
import torch

from portbench.harness import program, weights
from portbench.harness.spec import PKG, SpecError, find_cell, load_json
from portbench.reference import lm
from repro_torch.configs import base, get_config

SEED = 2**31 + 3
PHI3 = "phi3_mini_3p8b"
# sha256 of the flat buffer of phi3's SMOKE weights from SEED, as the
# harness drew them before configurations could bring rules of their own
DIGESTS = {
    "float32": "2f54fb6a33ca38d9014f6c7113993f6718681724ab83273d9aa64dc9948fb1d3",
    "bfloat16": "e044874e7b51729ae72ce84f0532ef95515173da29b0fe95c4e38a43b3d602cf",
}


@dataclasses.dataclass(frozen=True)
class FromDict(base.ModelConfig):
    """A type that builds itself from the ``model`` section."""

    built_by_from_dict: bool = False

    @classmethod
    def from_dict(cls, m: dict) -> "FromDict":
        return cls(**{**m, "built_by_from_dict": True})


def _phi3_model() -> dict:
    return json.loads((PKG / "configs" / f"{PHI3}.json").read_text())["model"]


def _digest(flat: torch.Tensor) -> str:
    bits = flat.detach().contiguous()
    if bits.dtype == torch.bfloat16:
        bits = bits.view(torch.int16)
    return hashlib.sha256(bits.numpy().tobytes()).hexdigest()


def test_a_new_leaf_is_drawn_by_the_configurations_rule():
    shapes = [("embed.table", (16, 4)), ("layers.0.ssm.conv_bias", (4096,))]
    own = {"conv_bias": {"normal": 0.1}}
    flat, views = weights.draw(shapes, {}, torch.float32, SEED, "cpu", own)
    again, _ = weights.draw(shapes, {}, torch.float32, SEED, "cpu", own)
    assert torch.equal(flat, again)
    assert views["layers.0.ssm.conv_bias"].std().item() == pytest.approx(
        0.1, rel=0.05)


def test_a_rule_the_table_has_is_refused():
    with pytest.raises(SpecError, match=r"init_rules: \['conv'\]"):
        weights.draw([("layers.0.ssm.conv", (4, 8))], {}, torch.float32,
                     SEED, "cpu", {"conv": {"normal": 0.5}})


def test_a_leaf_with_no_rule_is_named():
    with pytest.raises(KeyError, match="layers.0.ssm.conv_bias"):
        weights.draw([("layers.0.ssm.conv_bias", (8,))], {}, torch.float32,
                     SEED, "cpu")


@pytest.mark.parametrize("spec,why", [
    ("repro.configs.base:ModelConfig", "JAX package"),
    ("repro:ModelConfig", "JAX package"),
    ("collections:OrderedDict", "not a subclass of ModelConfig"),
    ("repro_torch.configs.base:SSMConfig", "not a subclass of ModelConfig"),
    ("repro_torch.configs.base:NoSuchConfig", "NoSuchConfig"),
])
def test_a_type_outside_the_ports_configs_is_refused(spec, why):
    with pytest.raises(SpecError, match=f"model.type {spec!r}: .*{why}"):
        program.model_config({**_phi3_model(), "type": spec})


def test_a_type_that_defines_from_dict_builds_itself():
    m = {**_phi3_model(), "type": f"{__name__}:FromDict"}
    cfg = program.model_config(m)
    assert type(cfg) is FromDict and cfg.built_by_from_dict
    assert "type" in m   # the section itself is left as it was


def test_phi3_builds_the_pinned_config():
    m = _phi3_model()
    cfg = program.model_config(m)
    assert type(cfg) is base.ModelConfig and cfg == base.ModelConfig(**m)


@pytest.mark.parametrize("smoke", [False, True])
def test_the_zamba2_fixture_builds_the_pinned_config(smoke):
    pinned = get_config("zamba2_1p2b", smoke=smoke)
    m = dataclasses.asdict(pinned)      # the fixture's section (tests/smoke.py)
    want = base.ModelConfig(**{**m, "ssm": base.SSMConfig(**m["ssm"])})
    assert program.model_config(m) == want == pinned


def test_phi3_draws_by_the_frozen_table_alone():
    cell = find_cell(f"{PHI3}.score_2k")
    assert cell.init_rules == {}
    assert weights.rules_for(cell.init_rules) == load_json(
        PKG / "init_rules.json")["rules"]


@pytest.mark.parametrize("dtype", sorted(DIGESTS))
def test_phi3_smoke_weights_are_bit_identical(dtype):
    m = {**dataclasses.asdict(get_config(PHI3, smoke=True)), "param_dtype": dtype}
    own = find_cell(f"{PHI3}.score_2k").init_rules
    _, _, flat, _ = program.build(m, lm, SEED, "cpu", False, own_rules=own)
    assert _digest(flat) == DIGESTS[dtype]
    flat, _ = weights.draw(lm.param_shapes(m), m, program.DTYPES[dtype], SEED,
                           "cpu")
    assert _digest(flat) == DIGESTS[dtype]
