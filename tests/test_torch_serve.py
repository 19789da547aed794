"""The whole serve slice: the port's ServeEngine against the reference's.

Both engines serve the same ``make_requests`` on the same weights (the
reference's ``init_lm``, carried over with ``params_from_jax``) on the
reduced granite. Greedy with the fp32 codec, the token streams and the
admission and retirement steps are identical; with int8 the run
completes and every step's measured ledger equals the reference's
``decode_step_traffic``/``prefill_traffic`` exactly. The launcher runs
on the CPU when asked and fails without a card otherwise.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.core import serve_engine as ref_serve  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.sysmodel import traffic as ref_traffic  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.serve_engine import (Request, ServeEngine,  # noqa: E402
                                           make_requests)
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs.ledger import reconcile_events  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PROMPT, GENS, USERS, SLOTS, PAGE = 9, [7, 3, 5], 8, 3, 8
MAX_LEN = PROMPT + max(GENS)
# the two frameworks' f32 logits agree to about 1e-6 (test_torch_model);
# a greedy step is only meaningful as a parity check when its top-2 gap
# is well above that
MARGIN = 1e-4


@pytest.fixture(scope="module")
def granite():
    rcfg = ref_reduced(ref_get_config("granite-8b"))
    cfg = reduced_config(get_config("granite-8b"))
    rplan, plan = rlm.build_plan(rcfg, 1), lm.build_plan(cfg, 1)
    rparams = rlm.init_lm(jax.random.key(0), rplan, jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), plan)
    return (rcfg, rplan, rparams), (cfg, plan, params)


def _reqs(vocab, users=USERS):
    return make_requests(users, PROMPT, GENS, vocab_size=vocab, seed=0)


def _run_ref(ref, codec):
    cfg, plan, params = ref
    rec = ref_obs.Recorder()
    with ref_obs.use_recorder(rec):
        e = ref_serve.ServeEngine(params, plan, slots=SLOTS, max_len=MAX_LEN,
                                  page_size=PAGE, codec=codec)
        for r in ref_serve.make_requests(USERS, PROMPT, GENS,
                                         vocab_size=cfg.vocab_size, seed=0):
            e.submit(r)
        e.run()
    return e, rec


def _run_port(port, codec, users=USERS, margins=None, **kw):
    cfg, plan, params = port
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        e = ServeEngine(params, plan, slots=SLOTS, max_len=MAX_LEN,
                        page_size=PAGE, codec=codec, device="cpu", **kw)
        for r in _reqs(cfg.vocab_size, users):
            e.submit(r)
        while e.queue or e._live.any():
            live = e._live.copy()
            e.step()
            if margins is not None and live.any():
                top2 = e.last_logits[torch.from_numpy(live)].topk(2).values
                margins.append(float((top2[:, 0] - top2[:, 1]).min()))
    return e, rec


def _streams(e):
    return {c.uid: list(c.tokens) for c in e.completions}


def _schedule(e):
    return {c.uid: (c.admitted_step, c.finished_step) for c in e.completions}


@pytest.fixture(scope="module")
def fp32_pair(granite):
    ref, port = granite
    margins = []
    return _run_ref(ref, "fp32"), _run_port(port, "fp32", margins=margins), \
        margins


@pytest.fixture(scope="module")
def int8_pair(granite):
    ref, port = granite
    return _run_ref(ref, "int8"), _run_port(port, "int8")


def test_requests_match_reference(granite):
    cfg = granite[1][0]
    for a, b in zip(_reqs(cfg.vocab_size), ref_serve.make_requests(
            USERS, PROMPT, GENS, vocab_size=cfg.vocab_size, seed=0)):
        assert a.uid == b.uid and a.max_new_tokens == b.max_new_tokens
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_greedy_token_streams_match_reference(fp32_pair):
    (ref, _), (port, _), margins = fp32_pair
    assert len(port.completions) == USERS
    assert _streams(port) == _streams(ref)
    # the check means something only if no step was a near-tie
    assert margins and min(margins) > MARGIN, min(margins)


def test_admission_and_retirement_steps_match_reference(fp32_pair):
    (ref, _), (port, _), _ = fp32_pair
    assert _schedule(port) == _schedule(ref)
    assert port.step_count == ref.step_count
    assert port.allocator.free_pages == ref.allocator.free_pages == \
        SLOTS * port.max_pages


def test_serve_token_events_match_reference(fp32_pair):
    (_, rrec), (port, rec), _ = fp32_pair
    keys = ("step", "batch", "admitted", "retired", "live_tokens",
            "pages_in_use", "pages_total")

    def rows(r):
        return [tuple(ev[k] for k in keys) for ev in r.events
                if ev["kind"] == "serve_token"]

    assert rows(rec) == rows(rrec)
    assert len(rows(rec)) == port.step_count


def test_int8_run_completes_and_ledger_reconciles_exactly(int8_pair, granite):
    (_, rrec), (port, rec), = int8_pair
    cfg = granite[1][0]
    assert sorted(c.num_tokens for c in port.completions) == sorted(
        GENS[i % len(GENS)] for i in range(USERS))
    steps = [ev for ev in rec.events if ev["kind"] == "serve_token"]
    traffic_ev = [ev for ev in rec.events if ev["kind"] == "traffic"]
    assert len(traffic_ev) == len(steps) > 0
    for st, tr in zip(steps, traffic_ev):
        want = ref_traffic.decode_step_traffic(
            n_live=st["batch"], d_model=cfg.d_model, codec="int8")
        pf = ref_traffic.prefill_traffic(prompt_len=PROMPT,
                                         d_model=cfg.d_model, codec="int8")
        for k in want:
            want[k] += st["admitted"] * pf[k]
        assert tr["measured"] == want
    rows, bad = reconcile_events(rec.events)
    assert bad == 0 and rows
    assert [ev["measured"] for ev in traffic_ev] == [
        ev["measured"] for ev in rrec.events if ev["kind"] == "traffic"]


def test_backfill_and_neighbours_do_not_change_tokens(granite, fp32_pair):
    _, port = granite
    (_, _), (cont, _), _ = fp32_pair
    seq, _ = _run_port(port, "fp32", backfill=False)
    solo, _ = _run_port(port, "fp32", users=1)
    assert _streams(seq) == _streams(cont)
    assert seq.step_count > cont.step_count
    assert _streams(solo)[0] == _streams(cont)[0]


def test_temperature_sampling_deterministic_per_seed(granite):
    _, port = granite
    a, _ = _run_port(port, "fp32", users=3, temperature=0.8, seed=7)
    b, _ = _run_port(port, "fp32", users=3, temperature=0.8, seed=7)
    assert _streams(a) == _streams(b)


def test_engine_validates_like_reference(granite):
    _, (cfg, plan, params) = granite
    with pytest.raises(ValueError, match="cut"):
        ServeEngine(params, lm.build_plan(cfg, 0), slots=2, max_len=16,
                    device="cpu")
    e = ServeEngine(params, plan, slots=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        e.submit(Request(uid=0, prompt=np.zeros(12, np.int32),
                         max_new_tokens=8))
    with pytest.raises(ValueError, match="empty"):
        e.submit(Request(uid=1, prompt=np.zeros(0, np.int32)))


def test_engine_without_a_card_raises_unless_asked_for_cpu(granite):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, (cfg, plan, params) = granite
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(params, plan, slots=2, max_len=16)


def _launch(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-8b", "--preset", "smoke", "--users", "3", "--slots", "2",
         "--prompt-len", "8", "--gen", "4", "--quiet", *args],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_launcher_serves_on_cpu_when_asked(tmp_path):
    out = _launch("--device", "cpu", "--codec", "int8", "--metrics-dir",
                  str(tmp_path))
    assert out.returncode == 0, out.stderr
    from repro.obs.ledger import reconcile_events as ref_reconcile
    from repro.obs.recorder import read_events

    events = read_events(str(tmp_path))
    rows, bad = ref_reconcile(events)  # the reference's report reads it
    assert rows and bad == 0
    assert any(ev["kind"] == "serve_summary" and ev["users"] == 3
               for ev in events)


def test_launcher_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _launch()
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
