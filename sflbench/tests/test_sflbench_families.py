"""What a configuration's family and its files decide, for the accepted
cells and for a new family: the seeded weights of each accepted cell at
CPU size bit for bit, frozen (``weights_digests.json``: the sha256 of
every tensor ``weights.make`` gave under ``tiny_cell`` at one seed, with
the dense and ssm layers still written into the harness); the port's
``ModelConfig`` built from a file's nested groups and lists; the
traffic's ``remat``."""
import dataclasses
import hashlib
import json

import pytest

from conftest import BENCH, tiny_cell
from harness import program, session, spec, weights

FROZEN = json.loads((BENCH / "tests" / "weights_digests.json").read_text())
HYBRID = BENCH / "tests" / "hybrid_moe" / "configs" / "tiny-hybrid-moe.json"


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(FROZEN["digests"]))
def test_weights_frozen(name):
    c = tiny_cell(spec.cell(name))
    got = weights.make(c.config["model"], FROZEN["seed"], "cpu",
                       spec.family(c.config))
    want = FROZEN["digests"][name]
    assert list(got) == list(want)
    assert {k: _digest(v) for k, v in got.items()} == want


def test_accepted_configs_name_no_family():
    for path in spec.listed_files()["families"]:
        assert path == BENCH / "reference" / "model.py"


def test_model_config_from_nested_groups_and_lists():
    program.import_program()
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

    cfg = json.loads(HYBRID.read_text())
    mc = program.model_config(cfg)
    assert mc.moe == MoEConfig(**cfg["model"]["moe"])
    assert mc.ssm == SSMConfig(**cfg["model"]["ssm"])
    assert mc.hybrid_attn_offsets == (2,) and mc.name == cfg["name"]
    assert [mc.is_attn_layer(i) for i in range(4)] == [False, False, True,
                                                       False]
    assert [mc.is_moe_layer(i) for i in range(4)] == [False, True, False,
                                                      True]
    for name in ("granite8b-4l.sflga-fp32-s1024",
                 "mamba2-130m.sflga-fp32-b2-s1024"):
        c = spec.cell(name).config
        m = dict(c["model"])
        if "ssm" in m:
            m["ssm"] = SSMConfig(**m["ssm"])
        assert program.model_config(c) == ModelConfig(name=c["name"], **m)
    with pytest.raises(TypeError):
        program.model_config(dict(cfg, model=dict(cfg["model"],
                                                  not_a_field=1)))


def test_remat_from_the_traffic(monkeypatch):
    """``"remat": true`` in the traffic reaches ``TrainConfig.remat``;
    the checked steps read the same bit for bit (remat recomputes the
    same graph), and the default is off."""
    program.import_program()
    from repro_torch.core import algorithms as alg

    seen = []
    real = alg.make_train_step

    def make(plan, tcfg, *a, **k):
        seen.append(tcfg.remat)
        return real(plan, tcfg, *a, **k)

    monkeypatch.setattr(alg, "make_train_step", make)
    c = tiny_cell(spec.cell("granite8b-4l.sflga-fp32-s1024"))
    off = session.setup(c, 2 ** 31 + 21, "cpu").checked
    on = session.setup(dataclasses.replace(
        c, traffic=dict(c.traffic, remat=True)), 2 ** 31 + 21, "cpu").checked
    assert seen == [False, True]
    assert on == off
