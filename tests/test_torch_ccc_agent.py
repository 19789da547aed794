"""The port's DDQN and Algorithm 1 drivers against the reference's, on
the CPU.

The Q-networks start from the same weights: the reference's
``init_qnet`` draw carried over with ``convert.qnet_params_from_jax``
(jax's PRNG is not torch's). Tolerances:

* Q-values 1e-6: the same three f32 GEMMs in two libraries.
* One update: the loss within 1e-6 relative; the parameters within 1e-6
  of the network's largest parameter. The reference computes AdamW's
  bias corrections in f32 (1 - 0.999f = 0.99998713e-3) where torch
  computes them in float64, which scales every step by about
  (1 - 6.4e-6): below 1e-7 of the O(1) weights, but the zero-initialised
  biases after one step ARE that step, so they are pinned instead to the
  reference's times that f32 factor, within 1e-6.
* Algorithm 1 over two episodes: equal actions and rewards (the scalar
  env is a numpy copy), TD losses within 1e-4 relative (a few updates of
  the above).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ccc import ddqn as jddqn  # noqa: E402
from repro.ccc import env as jenv  # noqa: E402
from repro.ccc import strategy as jstrategy  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs.recorder import read_events  # noqa: E402
from repro.optim.optimizers import adamw as jadamw  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.ccc import ddqn, env, strategy  # noqa: E402
from repro_torch.convert import qnet_params_from_jax  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


def _ref_params(cfg):
    return jax.tree.map(np.asarray, jddqn.init_qnet(
        jax.random.key(cfg.seed), cfg.state_dim, cfg.n_actions, cfg.hidden))


def _batch(n, state_dim, n_actions, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, state_dim).astype(np.float32),
            rng.randint(0, n_actions, n).astype(np.int32),
            rng.randn(n).astype(np.float32),
            rng.randn(n, state_dim).astype(np.float32),
            rng.randint(0, 2, n).astype(np.float32))


def _params_np(agent):
    return {k: v.detach().cpu().numpy()
            for k, v in agent.qnet.state_dict().items()}


def test_init_and_carried_q_values():
    cfg = ddqn.DDQNConfig(state_dim=11, n_actions=4, seed=3)
    net = ddqn.init_qnet(cfg.seed, cfg.state_dim, cfg.n_actions)
    for lin in (net.l1, net.l2, net.l3):  # He-normal scale, zero bias
        assert not lin.bias.any()
        std = float(lin.weight.detach().std()) / np.sqrt(2.0 / lin.in_features)
        assert 0.8 < std < 1.2
    ref = _ref_params(cfg)
    agent = ddqn.DDQNAgent(cfg, device="cpu",
                           params=qnet_params_from_jax(ref))
    assert agent.qnet.l1.weight.shape == (64, 11)  # nn.Linear: (out, in)
    x = np.random.RandomState(0).randn(32, 11).astype(np.float32)
    np.testing.assert_allclose(agent._q(x).numpy(),
                               np.asarray(jddqn.qnet_apply(ref, x)),
                               rtol=1e-6, atol=1e-6)


def test_update_matches_reference():
    cfg = ddqn.DDQNConfig(state_dim=5, n_actions=4, batch=16, seed=0)
    ref = _ref_params(cfg)
    agent = ddqn.DDQNAgent(cfg, device="cpu",
                           params=qnet_params_from_jax(ref))
    batch = _batch(16, 5, 4)
    opt = jadamw(cfg.lr)
    p1, _, loss = jddqn.ddqn_update(
        jax.tree.map(jnp.asarray, ref), jax.tree.map(jnp.asarray, ref),
        opt.init(ref), *map(jnp.asarray, batch), opt=opt, gamma=cfg.gamma)
    got = agent.train_step(batch)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-6)
    want = qnet_params_from_jax(jax.tree.map(np.asarray, p1))
    have = _params_np(agent)
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for k, v in want.items():
        assert np.abs(have[k] - v.numpy()).max() <= 1e-6 * scale, k
    # the biases were zero: each is one step, the reference's scaled by
    # its f32 bias corrections (step 1: (1 - b1)/bc1, sqrt(bc2/(1 - b2)))
    f32 = np.float32
    factor = (f32(1 - 0.9) / (f32(1) - f32(0.9))) \
        * np.sqrt((f32(1) - f32(0.999)) / f32(1 - 0.999))
    for name in ("l1.bias", "l2.bias", "l3.bias"):
        np.testing.assert_allclose(want[name].numpy(),
                                   have[name] * factor, rtol=1e-6, atol=1e-12)


def test_scalar_and_batched_updates_bit_identical():
    """Same seed, same network; one batch through the scalar agent's and
    the batched agent's update gives bit-identical results."""
    cfg = ddqn.DDQNConfig(state_dim=4, n_actions=3, batch=8, seed=0)
    scalar = ddqn.DDQNAgent(cfg, device="cpu")
    batched = ddqn.BatchedDDQNAgent(cfg, device="cpu")
    batch = _batch(8, 4, 3)
    for _ in range(3):
        ls = scalar.train_step(batch)
        lb = batched.train_step(batch)
        assert float(ls) == float(lb)
    for k, v in _params_np(scalar).items():
        np.testing.assert_array_equal(v, _params_np(batched)[k])


def test_target_sync_counts_gradient_steps():
    cfg = ddqn.DDQNConfig(state_dim=2, n_actions=2, batch=4,
                          target_update=2, seed=0)
    agent = ddqn.DDQNAgent(cfg, device="cpu")
    s = np.ones(2, np.float32)
    for _ in range(3):  # below warm-up: no gradient steps
        agent.observe(s, 0, 0.0, s, True)
    assert (agent.steps, agent.grad_steps) == (3, 0)
    before = agent.target.l1.weight.clone()
    agent.observe(s, 0, 0.0, s, True)  # first gradient step
    assert agent.grad_steps == 1
    assert torch.equal(agent.target.l1.weight, before)
    assert not torch.equal(agent.qnet.l1.weight, before)
    agent.observe(s, 0, 0.0, s, True)  # second: the target syncs
    assert agent.grad_steps == 2
    assert torch.equal(agent.target.l1.weight, agent.qnet.l1.weight)


def test_ring_buffer_wraps_and_samples_filled_slots():
    buf = ddqn.replay_init(8, 3)
    s = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    a = torch.arange(5)
    r, d = torch.ones(5), torch.zeros(5)
    buf = ddqn.replay_add_batch(buf, s, a, r, s, d)
    assert (buf.n, buf.ptr) == (5, 5)
    buf = ddqn.replay_add_batch(buf, s, a + 10, r, s, d)
    assert (buf.n, buf.ptr) == (8, 2)  # capped, wrapped
    # the wrap overwrote slots 0-1 with the newest transitions
    assert buf.a.tolist() == [13, 14, 2, 3, 4, 10, 11, 12]
    small = ddqn.replay_add_batch(ddqn.replay_init(16, 2), torch.ones(4, 2),
                                  torch.full((4,), 7), torch.ones(4),
                                  torch.ones(4, 2), torch.zeros(4))
    sample = ddqn.replay_sample(small, torch.Generator().manual_seed(0), 32)
    assert sample[1].shape == (32,) and bool((sample[1] == 7).all())


def test_fused_step_trains():
    cfg = env.cnn_env_config(horizon=3, batch=8, epsilon=0.001, seed=2)
    benv = env.BatchedCuttingPointEnv(cfg, n_envs=4, device="cpu")
    agent = ddqn.BatchedDDQNAgent(ddqn.DDQNConfig(
        state_dim=benv.state_dim, n_actions=benv.n_actions, batch=8,
        target_update=3, seed=0), device="cpu")
    state, ob = benv.reset()
    p0 = agent.qnet.l1.weight.clone()
    losses = []
    for _ in range(4):  # 4 steps x 4 envs = 16 transitions > warm-up 8
        state, ob, r, done, info, loss = agent.fused_step(benv, state, ob)
        assert r.shape == (4,) and bool(torch.isfinite(r).all())
        losses.append(float(loss))
    assert agent.env_steps == 16 and agent.replay.n == 16
    assert losses[0] == 0.0 and all(x > 0 for x in losses[1:])
    assert agent.grad_steps == 3  # the third synced the target
    assert torch.equal(agent.target.l1.weight, agent.qnet.l1.weight)
    assert not torch.equal(agent.qnet.l1.weight, p0)


class _Trace:
    """Wraps an agent's ``act``/``observe`` to record actions and TD
    losses."""

    def __init__(self, agent):
        self.actions, self.losses = [], []
        act, observe = agent.act, agent.observe

        def traced_act(s, greedy=False):
            a = act(s, greedy=greedy)
            self.actions.append(int(a))
            return a

        def traced_observe(*args):
            loss = observe(*args)
            self.losses.append(float(loss))
            return loss

        agent.act, agent.observe = traced_act, traced_observe


def test_algorithm1_matches_reference():
    kw = dict(horizon=5, batch=8, epsilon=0.001, seed=4)
    cfg = env.cnn_env_config(**kw)
    dcfg = dict(state_dim=11, n_actions=4, batch=4, eps_decay_steps=4,
                eps_end=0.3, target_update=3, seed=6)
    jagent = jddqn.DDQNAgent(jddqn.DDQNConfig(**dcfg))
    agent = ddqn.DDQNAgent(ddqn.DDQNConfig(**dcfg), device="cpu",
                           params=qnet_params_from_jax(
                               jax.tree.map(np.asarray, jagent.params)))
    jtrace, trace = _Trace(jagent), _Trace(agent)
    jres = jstrategy.run_algorithm1(jenv.CuttingPointEnv(
        jenv.cnn_env_config(**kw)), episodes=2, agent=jagent)
    res = strategy.run_algorithm1(env.CuttingPointEnv(cfg), episodes=2,
                                  agent=agent)
    assert trace.actions == jtrace.actions
    assert len(set(trace.actions)) > 1
    assert res.episode_rewards == jres.episode_rewards
    assert res.episode_latencies == jres.episode_latencies
    assert res.greedy_policy == jres.greedy_policy
    assert sum(x > 0 for x in trace.losses) >= 6
    np.testing.assert_allclose(trace.losses, jtrace.losses, rtol=1e-4)
    sched = res.cut_schedule()
    assert [sched(t) for t in range(5)] == res.greedy_policy


def test_algorithm1_improves_over_random():
    """The reference's check (``test_ccc.py``) on the port."""
    def mk():
        return env.CuttingPointEnv(env.cnn_env_config(
            horizon=4, batch=8, epsilon=0.001, seed=2))

    res = strategy.run_algorithm1(mk(), episodes=40, device="cpu")
    e = mk()
    greedy_cost, s, done = 0.0, e.reset(), False
    while not done:
        s, r, done, _ = e.step(res.agent.act(s, greedy=True))
        greedy_cost += -r
    rand = strategy.random_cut_policy_cost(mk(), rounds=4, seed=0)
    assert greedy_cost <= rand["cost"] * 1.15


def test_algorithm1_batched_smoke():
    cfg = env.cnn_env_config(horizon=3, batch=8, epsilon=0.001, seed=2,
                             codecs=("fp32", "int8"))
    benv = env.BatchedCuttingPointEnv(cfg, n_envs=8, device="cpu")
    res = strategy.run_algorithm1_batched(benv, episodes=12)
    assert len(res.episode_rewards) == 12
    assert all(np.isfinite(res.episode_rewards))
    assert len(res.greedy_policy) == 3
    assert all(v in range(1, 5) and c in cfg.codecs
               for v, c in res.greedy_policy)
    assert res.agent.device.type == "cpu"
    sched = res.cut_schedule(env.CuttingPointEnv(cfg))
    assert sched(0, np.zeros(benv.state_dim, np.float32)) in range(1, 5)


def test_device_classes_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = env.cnn_env_config(horizon=2, batch=8)
    dcfg = ddqn.DDQNConfig(state_dim=11, n_actions=4)
    for make in (lambda: env.BatchedCuttingPointEnv(cfg, n_envs=2),
                 lambda: ddqn.DDQNAgent(dcfg),
                 lambda: ddqn.BatchedDDQNAgent(dcfg),
                 lambda: strategy.run_algorithm1(env.CuttingPointEnv(cfg), 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_episode_events_render_in_reference_report(tmp_path):
    rec = obs.Recorder(str(tmp_path))
    with obs.use_recorder(rec):
        e = env.CuttingPointEnv(env.cnn_env_config(horizon=3, batch=8))
        strategy.run_algorithm1(e, episodes=2, device="cpu")
        benv = env.BatchedCuttingPointEnv(env.cnn_env_config(
            horizon=3, batch=8), n_envs=2, device="cpu")
        strategy.run_algorithm1_batched(benv, episodes=2)
    rec.close()
    events = read_events(str(tmp_path))
    eps = [ev for ev in events if ev["kind"] == "ddqn_episode"]
    assert [ev["episode"] for ev in eps] == [0, 1, 0, 1]
    assert set(eps[0]) >= {"reward", "latency", "eps", "td_loss", "chi",
                           "psi", "gamma_conv", "penalties", "q"}
    text = jreport.render_ddqn(events)
    assert text.startswith("== DDQN episodes ==")
    assert f"{eps[0]['reward']:.4f}" in text
