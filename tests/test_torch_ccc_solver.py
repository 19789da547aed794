"""The port's CCC system model, P2.1 solvers and environments against
the reference's, on the CPU.

* ``sysmodel`` copies (``comm``, ``comp``, ``privacy``): bit for bit on
  numpy inputs; the torch branch of ``comm`` keeps the input's device
  and dtype and agrees with numpy in float64.
* Solvers: the scalar ``solve_p21`` and ``latency_fixed_alloc`` are
  numpy copies, so they equal the reference exactly. The batched solver
  on numpy inputs runs the same candidate sequence in torch float64:
  within 1e-6 of the reference's scalar solver (the reference's own
  bound for its batched numpy path). On f32 tensors it is held against
  the reference's jax f32 solver: equal feasibility, χ and ψ within
  rtol 1e-4, the reference's own f32-against-f64 bound.
* Environments: the scalar env is a numpy copy on the same
  ``RandomState``, so states, rewards and info equal the reference's
  bit for bit. The batched env draws its own gains (a torch generator is
  not jax's PRNG), so its ``step`` is held against the reference's on
  injected gains and actions, within rtol 1e-4 (two f32 solvers).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ccc import convex as jconvex  # noqa: E402
from repro.ccc import convex_jax as jconvex_b  # noqa: E402
from repro.ccc import env as jenv  # noqa: E402
from repro.sysmodel import comm as jcomm  # noqa: E402
from repro.sysmodel import comp as jcomp  # noqa: E402
from repro.sysmodel import privacy as jprivacy  # noqa: E402
from repro_torch.ccc import convex, env  # noqa: E402
from repro_torch.sysmodel import comm, comp, privacy  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


def _batch_instance(B, N, seed=0, x_lo=1e5, x_hi=5e7):
    rng = np.random.RandomState(seed)
    gains = np.stack([jcomm.path_loss_gain(rng.uniform(0.05, 0.5, N), rng)
                      for _ in range(B)])
    X = rng.uniform(x_lo, x_hi, B)
    return gains, X


# ---------------------------------------------------------------- sysmodel

def test_comm_copy_bit_for_bit():
    rng = np.random.RandomState(0)
    d = rng.uniform(0.0, 0.6, (7, 5))  # includes d below the 1e-3 floor
    d[0, 0] = 0.0
    np.testing.assert_array_equal(comm.path_loss_linear(d),
                                  jcomm.path_loss_linear(d))
    np.testing.assert_array_equal(
        comm.path_loss_gain(d, np.random.RandomState(3)),
        jcomm.path_loss_gain(d, np.random.RandomState(3)))
    gains = jcomm.path_loss_gain(d, rng)
    bw = rng.uniform(0.0, 4e6, d.shape)
    bw[1, 1] = 0.0  # the 1e-9 floor
    for bandwidth in (20e6, 2e5):
        p, jp = comm.CommParams(total_bandwidth=bandwidth), \
            jcomm.CommParams(total_bandwidth=bandwidth)
        assert (p.noise_psd, p.client_power, p.server_power) == \
            (jp.noise_psd, jp.client_power, jp.server_power)
        np.testing.assert_array_equal(
            comm.uplink_rate(bw, p.client_power, gains, p),
            jcomm.uplink_rate(bw, jp.client_power, gains, jp))
        np.testing.assert_array_equal(comm.downlink_rate(gains, p),
                                      jcomm.downlink_rate(gains, jp))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_comm_torch_branch_keeps_dtype_and_agrees(dtype):
    rng = np.random.RandomState(1)
    d = rng.uniform(0.05, 0.5, (4, 6))
    bw = rng.uniform(1e3, 4e6, d.shape)
    p = comm.CommParams()
    gains = comm.path_loss_linear(d)
    # f32: the path loss exponentiates a dB value of ~120, whose f32 ulp
    # (7.6e-6 dB) alone moves the gain by 1.8e-6 relative; the rates
    # round only their own few operations
    tol = {"path_loss": 1e-5, "uplink": 1e-6, "downlink": 1e-6}
    if dtype == torch.float64:
        tol = dict.fromkeys(tol, 1e-14)
    outs = {
        "path_loss": (comm.path_loss_linear(torch.tensor(d, dtype=dtype)),
                      gains),
        "uplink": (comm.uplink_rate(torch.tensor(bw, dtype=dtype),
                                    p.client_power,
                                    torch.tensor(gains, dtype=dtype), p),
                   comm.uplink_rate(bw, p.client_power, gains, p)),
        "downlink": (comm.downlink_rate(torch.tensor(gains, dtype=dtype), p),
                     comm.downlink_rate(gains, p)),
    }
    for name, (t, ref) in outs.items():
        assert isinstance(t, torch.Tensor) and t.dtype == dtype, name
        np.testing.assert_allclose(t.numpy(), ref, rtol=tol[name],
                                   err_msg=name)


def test_comp_and_privacy_copies_bit_for_bit():
    base, jbase = comp.CompParams(), jcomp.CompParams()
    assert dataclasses.asdict(base) == dataclasses.asdict(jbase)
    rng = np.random.RandomState(2)
    f = rng.uniform(0.0, 2e8, 9)
    f[0] = 0.0  # the 1e-3 floor
    for frac in (0.06112869774042135, 0.5, rng.uniform(0, 1, (3, 1))):
        c, jc = comp.scale_by_cut(base, frac), jcomp.scale_by_cut(jbase, frac)
        for field in dataclasses.fields(jc):
            np.testing.assert_array_equal(getattr(c, field.name),
                                          getattr(jc, field.name))
        for fn in ("client_fp_latency", "server_latency",
                   "client_bp_latency"):
            np.testing.assert_array_equal(
                getattr(comp, fn)(16, c, f), getattr(jcomp, fn)(16, jc, f))
    phis, q = [100, 1000, 10000, 50000], 100000
    for eps in (0.0, 0.001, 0.05, 1.0):
        assert privacy.min_cut_for_privacy(phis, q, eps) == \
            jprivacy.min_cut_for_privacy(phis, q, eps)
        for phi in phis:
            assert privacy.privacy_leakage(phi, q) == \
                jprivacy.privacy_leakage(phi, q)
            assert privacy.privacy_ok(phi, q, eps) == \
                jprivacy.privacy_ok(phi, q, eps)


# ----------------------------------------------------------------- solvers

@pytest.mark.parametrize("bandwidth,N,seed,X", [
    (20e6, 10, 0, 16 * 1568 * 32), (20e6, 8, 3, 16 * 784 * 32),
    (5e6, 4, 1, 3e7), (2e5, 6, 2, 5e7), (1e3, 6, 4, 5e7)])
def test_scalar_solver_equals_reference(bandwidth, N, seed, X):
    """The last case is infeasible (the bracket runs out)."""
    rng = np.random.RandomState(seed)
    gains = jcomm.path_loss_gain(rng.uniform(0.05, 0.5, N), rng)
    p, jp = comm.CommParams(total_bandwidth=bandwidth), \
        jcomm.CommParams(total_bandwidth=bandwidth)
    c, jc = comp.CompParams(), jcomp.CompParams()
    got = convex.solve_p21(gains, X, 16, p, c)
    ref = jconvex.solve_p21(gains, X, 16, jp, jc)
    assert got.feasible == ref.feasible
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, field.name),
                                      getattr(ref, field.name))
    assert convex.latency_fixed_alloc(gains, X, 16, p, c) == \
        jconvex.latency_fixed_alloc(gains, X, 16, jp, jc)


def test_batched_f64_within_1e6_of_reference_scalar():
    """The three instance sets of the reference's
    ``test_numpy_backend_parity_32_rounds``."""
    c, jc = comp.CompParams(), jcomp.CompParams()
    worst = 0.0
    for bandwidth, (B, N, seed) in [(20e6, (16, 10, 0)), (20e6, (8, 4, 1)),
                                    (2e5, (8, 6, 2))]:
        p, jp = comm.CommParams(total_bandwidth=bandwidth), \
            jcomm.CommParams(total_bandwidth=bandwidth)
        gains, X = _batch_instance(B, N, seed)
        res = convex.solve_p21_batched(gains, X, 16.0, p, c)
        assert isinstance(res.chi, np.ndarray)  # numpy in -> numpy out
        assert res.chi.dtype == np.float64
        for i in range(B):
            ref = jconvex.solve_p21(gains[i], X[i], 16, jp, jc)
            assert bool(res.feasible[i]) == ref.feasible
            if not ref.feasible:
                continue
            worst = max(worst, abs(res.chi[i] - ref.chi) / ref.chi,
                        abs(res.psi[i] - ref.psi) / ref.psi)
            np.testing.assert_allclose(res.bandwidth[i], ref.bandwidth,
                                       rtol=1e-6)
            np.testing.assert_allclose(res.f_server[i], ref.f_server,
                                       rtol=1e-6)
    assert worst <= 1e-6, worst


@pytest.mark.parametrize("bandwidth", [20e6, 2e5])
def test_batched_f32_against_reference_jax_f32(bandwidth):
    p, jp = comm.CommParams(total_bandwidth=bandwidth), \
        jcomm.CommParams(total_bandwidth=bandwidth)
    gains, X = _batch_instance(32, 10, 3)
    ref = jconvex_b.solve_p21_batched(jnp.asarray(gains, jnp.float32),
                                      jnp.asarray(X, jnp.float32), 16.0, jp,
                                      jcomp.CompParams())
    res = convex.solve_p21_batched(torch.tensor(gains, dtype=torch.float32),
                                   torch.tensor(X, dtype=torch.float32), 16.0,
                                   p, comp.CompParams())
    assert isinstance(res.chi, torch.Tensor) and res.chi.dtype == torch.float32
    np.testing.assert_array_equal(res.feasible.numpy(),
                                  np.asarray(ref.feasible))
    np.testing.assert_allclose(res.chi.numpy(), np.asarray(ref.chi), rtol=1e-4)
    np.testing.assert_allclose(res.psi.numpy(), np.asarray(ref.psi), rtol=1e-4)


def test_per_round_comp_split_matches_scalar():
    """(B, 1) FLOP fields (a cut per round), numpy and tensor."""
    base = comp.CompParams()
    gains, X = _batch_instance(4, 6, 8)
    frac = np.array([0.02, 0.1, 0.3, 0.6])
    res = convex.solve_p21_batched(gains, X, 16.0, comm.CommParams(),
                                   comp.scale_by_cut(base, frac[:, None]))
    res_t = convex.solve_p21_batched(
        torch.tensor(gains), torch.tensor(X), 16.0, comm.CommParams(),
        comp.scale_by_cut(base, torch.tensor(frac)[:, None]))
    for i in range(4):
        ref = jconvex.solve_p21(gains[i], X[i], 16, jcomm.CommParams(),
                                jcomp.scale_by_cut(jcomp.CompParams(),
                                                   frac[i]))
        for r in (res.chi[i], float(res_t.chi[i])):
            np.testing.assert_allclose(r, ref.chi, rtol=1e-6)
        np.testing.assert_allclose(res.psi[i], ref.psi, rtol=1e-6)


def test_feasibility_oracle_brackets_chi_star():
    p, c = comm.CommParams(), comp.CompParams()
    gains, X = _batch_instance(8, 8, 5)
    res = convex.solve_p21_batched(gains, X, 16.0, p, c)
    assert res.feasible.all()
    assert not convex.p21_feasible_at(gains, X, res.chi * 0.5, 16.0, p,
                                      c).any()
    assert convex.p21_feasible_at(gains, X, res.chi * 1.05, 16.0, p, c).all()
    g32, x32 = (torch.tensor(a, dtype=torch.float32) for a in (gains, X))
    assert not convex.p21_feasible_at(g32, x32, torch.tensor(res.chi * 0.5),
                                      16.0, p, c).any()
    assert convex.p21_feasible_at(g32, x32, torch.tensor(res.chi * 1.05),
                                  16.0, p, c).all()


# ------------------------------------------------------------ environments

ENV_CASES = {
    "default": dict(horizon=4, batch=8, epsilon=0.001, seed=3),
    "codecs": dict(horizon=4, batch=8, epsilon=0.001, seed=5,
                   codecs=("fp32", "bf16", "int8", "int4")),
    "cohort": dict(horizon=4, batch=8, epsilon=0.001, seed=1, cohort=4),
    "mig_phis": dict(horizon=4, batch=8, epsilon=0.001, seed=2,
                     mig_phis=(10, 200, 4000, 5000)),
}


def test_cnn_env_config_equals_reference():
    for kw in ({}, dict(light=False), dict(flop_aware=True, seed=4)):
        assert dataclasses.asdict(env.cnn_env_config(**kw)) == \
            dataclasses.asdict(jenv.cnn_env_config(**kw))


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_scalar_env_bit_for_bit(case):
    kw = ENV_CASES[case]
    e = env.CuttingPointEnv(env.cnn_env_config(**kw))
    je = jenv.CuttingPointEnv(jenv.cnn_env_config(**kw))
    assert (e.n_actions, e.state_dim) == (je.n_actions, je.state_dim)
    actions = np.random.RandomState(0).randint(0, e.n_actions, 11)
    np.testing.assert_array_equal(e.reset(), je.reset())
    for a in actions:  # crosses an episode end (horizon 4): reset inside
        s, r, done, info = e.step(a)
        js, jr, jdone, jinfo = je.step(a)
        np.testing.assert_array_equal(s, js)
        assert (r, done) == (jr, jdone)
        assert info == jinfo
        if done:
            np.testing.assert_array_equal(e.reset(), je.reset())


def test_batched_env_tables_equal_reference():
    cfg = env.cnn_env_config(**ENV_CASES["codecs"])
    b = env.BatchedCuttingPointEnv(cfg, n_envs=2, device="cpu")
    jb = jenv.BatchedCuttingPointEnv(jenv.cnn_env_config(
        **ENV_CASES["codecs"]), n_envs=2)
    assert (b.n_actions, b.state_dim) == (jb.n_actions, jb.state_dim)
    for name in ("xbits_table", "gamma_conv_table", "gamma_dist_table",
                 "gamma_table", "frac_table", "priv_table"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["default", "codecs"])
def test_batched_step_matches_reference_on_injected_gains(case):
    kw = dict(ENV_CASES[case], seed=7)
    B = 6
    b = env.BatchedCuttingPointEnv(env.cnn_env_config(**kw), n_envs=B,
                                   device="cpu")
    jb = jenv.BatchedCuttingPointEnv(jenv.cnn_env_config(**kw), n_envs=B)
    gains, _ = _batch_instance(B, 10, 11)
    actions = np.arange(B) % b.n_actions
    cum = np.linspace(0.0, 3.0, B).astype(np.float32)
    t = np.full(B, 2, np.int32)
    st, _ = b.reset()
    st = st._replace(t=torch.tensor(t), cum_cost=torch.tensor(cum),
                     gains=torch.tensor(gains, dtype=torch.float32))
    jst, _ = jb.reset()
    jst = jst._replace(t=jnp.asarray(t), cum_cost=jnp.asarray(cum),
                       gains=jnp.asarray(gains, jnp.float32))
    st2, _, r, done, info = b.step(st, torch.tensor(actions))
    jst2, _, jr, jdone, jinfo = jb.step(jst, jnp.asarray(actions, jnp.int32))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-4)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(st2.cum_cost.numpy(),
                               np.asarray(jst2.cum_cost), rtol=1e-4)
    np.testing.assert_array_equal(st2.t.numpy(), np.asarray(jst2.t))
    for k in ("chi", "psi", "latency", "bits", "gamma", "gamma_conv",
              "gamma_dist"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(jinfo[k]),
                                   rtol=1e-4, err_msg=k)
    for k in ("v", "privacy_ok"):
        np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]))


def test_batched_reward_matches_scalar_env():
    """The port's batched env against the port's scalar env on the same
    gains, for every action (the reference's bound, rtol 1e-3)."""
    cfg = env.cnn_env_config(**ENV_CASES["default"])
    scalar = env.CuttingPointEnv(cfg)
    scalar.reset()
    b = env.BatchedCuttingPointEnv(cfg, n_envs=scalar.n_actions,
                                   device="cpu")
    st, _ = b.reset()
    st = st._replace(gains=torch.tensor(
        np.broadcast_to(scalar.gains, (b.n_envs, cfg.n_clients)),
        dtype=torch.float32))
    _, _, r, _, info = b.step(st, torch.arange(b.n_envs))
    for a in range(scalar.n_actions):
        v, codec = scalar.decode_action(a)
        gamma, chi, psi, alloc = scalar.cost_terms(v, codec)
        np.testing.assert_allclose(float(info["chi"][a]), chi, rtol=1e-3)
        np.testing.assert_allclose(float(info["psi"][a]), psi, rtol=1e-3)
        ok = privacy.privacy_ok(cfg.phis[v - 1], cfg.total_params,
                                cfg.epsilon) and alloc.feasible
        want = -(cfg.w * gamma + chi + psi) if ok else -cfg.penalty
        np.testing.assert_allclose(float(r[a]), want, rtol=1e-3)


def test_batched_env_lockstep_cohort_and_mig_phis():
    cfg = env.cnn_env_config(**ENV_CASES["cohort"])
    b = env.BatchedCuttingPointEnv(cfg, n_envs=3, device="cpu")
    st, obs = b.reset()
    assert obs.shape == (3, 5) and obs.dtype == torch.float32
    a = torch.full((3,), b.n_codecs)  # v=2 everywhere
    for t in range(cfg.horizon):
        st, obs, r, done, _ = b.step(st, a)
        assert bool(torch.isfinite(r).all())
        assert bool(done.all()) == (t == cfg.horizon - 1)
    assert bool((st.t == 0).all()) and bool((st.cum_cost == 0).all())
    # a second env from the same seed draws the same fading
    st_b, _ = env.BatchedCuttingPointEnv(cfg, n_envs=3, device="cpu").reset()
    st_c, _ = env.BatchedCuttingPointEnv(cfg, n_envs=3, device="cpu").reset()
    assert torch.equal(st_b.gains, st_c.gains)
    with pytest.raises(ValueError, match="mig_phis"):
        env.BatchedCuttingPointEnv(env.cnn_env_config(**ENV_CASES["mig_phis"]),
                                   n_envs=2, device="cpu")
