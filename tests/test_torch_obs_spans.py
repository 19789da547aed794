"""The port's ``obs`` spans on the profiler's clock, and the phase spans
of the SFL train step (``core.algorithms``, ``core.gradagg``,
``core.protocol``).

* (a) Under ``torch.profiler``, one ``make_train_step`` step holds each of
  ``repro_torch.client_forward``, ``.uplink``, ``.server_forward``,
  ``.backward``, ``.downlink`` and ``.optimizer`` once, ``downlink``
  inside ``backward``, and besides them only the model's own spans (a
  Mamba-2 layer's ``mamba`` and ``ssd``); each ``resplit_*`` call holds
  one ``repro_torch.resplit``.
* (b) With the profiler off and the Null recorder active, ``obs.span``
  is the shared no-op span.
* (c) A step's params, optimizer state and loss are bit-identical with
  the profiler on and off.
* (d) Under a real ``Recorder`` the span events carry the phase names and
  parents, with the event schema of ``repro.obs.v1``.
* On the card (``cuda`` marker), ``downlink`` runs on autograd's device
  thread, not the caller's, and the profiler still sees it and its B1.

Cases: a reduced dense model (granite-8b) and a reduced SSM
(mamba2-130m), each under sfl_ga with the fp32 and the int8 codec, and
psl int8, whose downlink is the per-client unicast.
"""
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import TrainConfig, get_config, reduced_config
from repro_torch.core import algorithms as alg
from repro_torch.models import lm
from repro_torch.obs import recorder
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves
from _torch_threads import _one_torch_thread  # noqa: F401

N, B, S = 3, 2, 16
OVER = {"granite-8b": dict(num_layers=4, d_model=64, d_ff=128,
                           vocab_size=256),
        "mamba2-130m": dict(num_layers=3, d_model=64, vocab_size=256)}
PHASES = ("client_forward", "uplink", "server_forward", "backward",
          "downlink", "optimizer")
# the model's own spans a step opens, by name and count: a Mamba-2
# mixer's ``mamba`` and its SSD's ``ssd``, once a layer (3, cut 2)
MODEL_SPANS = {"granite-8b": {}, "mamba2-130m": {"mamba": 3, "ssd": 3}}
CASES = [("granite-8b", "sfl_ga", "fp32"), ("granite-8b", "sfl_ga", "int8"),
         ("mamba2-130m", "sfl_ga", "fp32"), ("mamba2-130m", "sfl_ga", "int8"),
         ("granite-8b", "psl", "int8")]


def _step(arch, algo, codec, cut=2, opt="sgd", device="cpu"):
    cfg = reduced_config(get_config(arch)).with_overrides(**OVER[arch])
    plan = lm.build_plan(cfg, cut)
    params = alg.split_lm_params(lm.init_lm(0, plan, device=device), N)
    tcfg = TrainConfig(model=cfg, algo=algo, cut_layer=cut,
                       compute_dtype="float32", param_dtype="float32",
                       lr=0.05, remat=False, tau=1, uplink_codec=codec,
                       downlink_codec=codec)
    optim = make_optimizer(opt, 0.05)
    step = alg.make_train_step(plan, tcfg, optim, N)
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (N, B, S)))
             .to(device) for k in ("tokens", "labels")}
    batch["seed"] = np.uint32(7)
    return cfg, step, params, optim.init(params), batch


def _ranges(prof, prefix=recorder.PROFILER_PREFIX):
    """{span name: [(start_us, end_us), ...]} of the profiled ranges."""
    out = {}
    for ev in prof.events():
        if ev.name.startswith(prefix):
            out.setdefault(ev.name[len(prefix):], []).append(
                (ev.time_range.start, ev.time_range.end))
    return out


@pytest.mark.parametrize("arch,algo,codec", CASES)
def test_step_phases_on_the_profiler(arch, algo, codec):
    _, step, params, opt_state, batch = _step(arch, algo, codec)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt_state, batch)
    got = _ranges(prof)
    assert {k: len(v) for k, v in got.items() if k not in PHASES} == \
        MODEL_SPANS[arch]
    got = {k: v for k, v in got.items() if k in PHASES}
    assert sorted(got) == sorted(PHASES)
    assert all(len(got[p]) == 1 for p in PHASES), got
    (b0, b1), (d0, d1) = got["backward"][0], got["downlink"][0]
    assert b0 <= d0 <= d1 <= b1
    order = [got[p][0][0] for p in ("client_forward", "uplink",
                                    "server_forward", "backward",
                                    "optimizer")]
    assert order == sorted(order)


@pytest.mark.parametrize("arch", sorted(OVER))
def test_each_resplit_call_holds_one_span(arch):
    cfg, _, params, _, _ = _step(arch, "sfl_ga", "fp32", cut=1)
    opt_state = make_optimizer("adamw", 0.05).init(params)
    old, new = lm.build_plan(cfg, 1), lm.build_plan(cfg, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        alg.resplit_lm_params(params, old, new)
    assert [len(v) for v in _ranges(prof).values()] == [1]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        alg.resplit_opt_state(opt_state, old, new)  # two moments, one span
    assert {k: len(v) for k, v in _ranges(prof).items()} == {"resplit": 1}


def test_null_span_when_the_profiler_is_off(monkeypatch):
    assert obs.get_recorder() is recorder.null_recorder
    assert not torch.autograd._profiler_enabled()
    assert obs.span("backward") is recorder._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.span("backward") is not recorder._NULL_SPAN
    # with torch not imported no profiler can run, and obs looks no further
    monkeypatch.delitem(sys.modules, "torch")
    assert obs.span("backward") is recorder._NULL_SPAN


@pytest.mark.parametrize("arch,algo,codec", CASES)
def test_profiled_step_is_bit_identical(arch, algo, codec):
    _, step, params, opt_state, batch = _step(arch, algo, codec)
    p0, s0, m0 = step(params, opt_state, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        p1, s1, m1 = step(params, opt_state, batch)
    for a, b in zip(tree_leaves((p0, s0, m0["loss"])),
                    tree_leaves((p1, s1, m1["loss"]))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,algo,codec", CASES[:2])
def test_recorder_span_events(arch, algo, codec):
    _, step, params, opt_state, batch = _step(arch, algo, codec)
    rec = obs.Recorder()
    with obs.use_recorder(rec), rec.span("step", cut=2):
        step(params, opt_state, batch)
    spans = [e for e in rec.events if e["kind"] == "span"]
    parents = {e["name"]: e["parent"] for e in spans}
    assert parents == {"client_forward": "step", "uplink": "step",
                       "server_forward": "step", "backward": "step",
                       "downlink": "backward", "optimizer": "step",
                       "step": None}
    keys = {"kind", "name", "dur_s", "depth", "parent", "round", "seq",
            "ts"}
    assert all(set(e) == keys for e in spans if e["name"] != "step")
    assert set(spans[-1]) == keys | {"cut"}
    assert [e["depth"] for e in spans if e["name"] == "downlink"] == [2]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_downlink_on_the_autograd_thread_on_the_card(cuda):
    _, step, params, opt_state, batch = _step("granite-8b", "sfl_ga", "int8",
                                              device=cuda)
    step(params, opt_state, batch)  # builds the kernels
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    evs = [e for e in prof.events()  # host ranges, not their device views
           if e.name.startswith(recorder.PROFILER_PREFIX)
           and e.device_type == torch.autograd.DeviceType.CPU]
    names = sorted(e.name[len(recorder.PROFILER_PREFIX):] for e in evs)
    assert names == sorted(PHASES)
    by = {e.name[len(recorder.PROFILER_PREFIX):]: e for e in evs}
    assert by["downlink"].thread != by["backward"].thread
    assert by["downlink"].device_time_total > 0
