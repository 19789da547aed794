"""torch's process-wide f32 flags around the port's engines.

``FedSimulator`` and ``ServeEngine`` compute in full f32 (the
reference's precision) and the trainer reproducibly, through
``repro_torch.full_f32``. The flags are torch's, shared by the whole
process, so the engines set them only around their own device work and
hand the caller's settings back: a model run outside an engine must not
change precision because an engine ran before it. On the CPU the flags
change no number, which lets these tests see the scoping.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import full_f32  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.paper_cnn import LIGHT_CONFIG  # noqa: E402
from repro_torch.core.serve_engine import ServeEngine, make_requests  # noqa: E402
from repro_torch.core.simulator import FedSimulator, SimConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

EXACT = (False, False)  # matmul.allow_tf32, cudnn.allow_tf32 inside


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)


@pytest.fixture
def caller_flags(request):
    """Set the caller's flags for one test and restore torch's after."""
    saved = _flags()
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = request.param
    yield request.param
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


# (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic): every flag
# off its default, and every flag where the engines must change it
CALLERS = [(True, False, True), (True, True, False)]


@pytest.mark.parametrize("caller_flags", CALLERS, indirect=True)
@pytest.mark.parametrize("deterministic", [False, True])
def test_full_f32_sets_exact_f32_inside_and_restores(caller_flags,
                                                     deterministic):
    with full_f32(deterministic):
        inside = _flags()
    assert inside[:2] == EXACT
    assert inside[2] == (True if deterministic else caller_flags[2])
    assert _flags() == caller_flags
    with pytest.raises(ValueError):  # restored on the way out of an error
        with full_f32(deterministic):
            raise ValueError
    assert _flags() == caller_flags


@pytest.mark.parametrize("caller_flags", CALLERS, indirect=True)
def test_simulator_scopes_the_flags_to_its_compute(caller_flags,
                                                   monkeypatch):
    sim = FedSimulator(LIGHT_CONFIG, SimConfig(scheme="sfl_ga", cut=2,
                                               n_clients=2, batch=4,
                                               uplink_codec="int8"),
                       device="cpu")
    assert _flags() == caller_flags
    seen = []
    round_ = sim._round

    def spy(*args):
        seen.append(_flags())
        return round_(*args)

    monkeypatch.setattr(sim, "_round", spy)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 1, 4, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, (2, 1, 4)).astype(np.int32)
    out = sim.run_round(x, y)
    assert np.isfinite(out["loss"])
    assert seen == [EXACT + (True,)]
    assert _flags() == caller_flags
    sim.set_cut(1)
    sim.evaluate(x.reshape(-1, 28, 28, 1), y.reshape(-1))
    assert _flags() == caller_flags


@pytest.mark.parametrize("caller_flags", CALLERS, indirect=True)
def test_serve_engine_scopes_the_flags_to_its_compute(caller_flags,
                                                      monkeypatch):
    cfg = reduced_config(get_config("granite-8b"))
    plan = lm.build_plan(cfg, 1)
    params = lm.init_lm(0, plan, torch.float32, "cpu")
    engine = ServeEngine(params, plan, slots=2, max_len=12, page_size=8,
                         device="cpu")
    assert _flags() == caller_flags
    seen = {}
    for name in ("_prefill", "_decode"):
        fn = getattr(engine, name)

        def spy(*args, _fn=fn, _name=name):
            seen[_name] = _flags()
            return _fn(*args)

        monkeypatch.setattr(engine, name, spy)
    for r in make_requests(2, 5, 3, vocab_size=cfg.vocab_size, seed=0):
        engine.submit(r)
    engine.step()
    # the engine's flags inside, the trainer's cuDNN determinism untouched
    want = EXACT + (caller_flags[2],)
    assert seen == {"_prefill": want, "_decode": want}
    assert bool(torch.isfinite(engine.last_logits).all())
    assert _flags() == caller_flags
