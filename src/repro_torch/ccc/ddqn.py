"""Double-DQN (§IV-B-2, eqs. 38-40) in PyTorch: the port of
``repro.ccc.ddqn``.

Q-network: MLP state -> |A| action values. Double-DQN target (eq. 40):
   y = r + γ Q_target(s', argmax_a Q_online(s', a))

Two drivers share the same network/update math (``ddqn_update``):

* ``DDQNAgent`` — the scalar paper-faithful loop: host-side numpy
  replay, one transition per ``observe``. Its ε and replay draws use the
  reference's ``RandomState``, so with the same Q-network it takes the
  same actions.
* ``BatchedDDQNAgent`` — the device-resident loop: the replay buffer
  lives in tensors on the agent's device, and ``fused_step`` runs
  ε-greedy act → env.step → store → sample → update → target sync over
  B parallel envs. The reference jits that step; here it runs eagerly
  and decides on the host, without a device sync, what is a pure
  function of the step count (the warm-up mask, the target-sync
  cadence, ε).

The optimizer is ``torch.optim.AdamW`` with the reference's ``adamw``
settings stated (b1 0.9, b2 0.999, eps 1e-8, and weight decay 0.0, not
torch's default 0.01). Q-values are computed in full f32
(``repro_torch.full_f32``), so a caller's TF32 flag cannot flip an
argmax.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import full_f32, obs, require_device


class QNet(nn.Module):
    """The reference's ``init_qnet``/``qnet_apply`` MLP. ``nn.Linear``
    keeps its weight as (out, in); the reference's ``w`` is (in, out)
    (``convert.qnet_params_from_jax`` transposes)."""

    def __init__(self, state_dim: int, n_actions: int, hidden: int = 64):
        super().__init__()
        # skip_init: no draw from torch's global RNG (init_qnet draws)
        self.l1 = nn.utils.skip_init(nn.Linear, state_dim, hidden)
        self.l2 = nn.utils.skip_init(nn.Linear, hidden, hidden)
        self.l3 = nn.utils.skip_init(nn.Linear, hidden, n_actions)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.l1(s))
        h = torch.relu(self.l2(h))
        return self.l3(h)


def init_qnet(seed: int, state_dim: int, n_actions: int, hidden: int = 64,
              device="cpu") -> QNet:
    """He-normal weights of scale sqrt(2/in) and zero biases, as the
    reference; drawn on the CPU from ``seed`` (so every device starts
    from the same network), then moved to ``device``."""
    net = QNet(state_dim, n_actions, hidden)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lin in (net.l1, net.l2, net.l3):
            lin.weight.normal_(generator=gen).mul_(
                math.sqrt(2.0 / lin.in_features))
            lin.bias.zero_()
    return net.to(device)


def adamw(params, lr: float) -> torch.optim.AdamW:
    """The reference's ``optim.adamw(lr)``, every setting stated."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.0)


def ddqn_update(qnet: QNet, target: QNet, opt, s, a, r, s2, done, *,
                gamma: float) -> torch.Tensor:
    """One gradient step on one sampled batch (eq. 38-40), in place on
    ``qnet`` and ``opt``; returns the loss. Shared by the scalar and
    batched agents — the B=1 bit-identity test pins this."""
    with full_f32():
        q_sa = qnet(s).gather(1, a.long()[:, None])[:, 0]
        with torch.no_grad():  # the stop-gradient on q_next (eq. 40)
            # double-DQN: online net picks a*, target net evaluates
            a_star = qnet(s2).argmax(dim=1)
            q_next = target(s2).gather(1, a_star[:, None])[:, 0]
        y = r + gamma * (1.0 - done) * q_next
        loss = (q_sa - y).square().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return loss.detach()


class ReplayBuffer:
    def __init__(self, capacity: int, state_dim: int):
        self.capacity = capacity
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity,), np.int32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.n = 0
        self.ptr = 0

    def add(self, s, a, r, s2, done):
        i = self.ptr
        self.s[i], self.a[i], self.r[i], self.s2[i], self.done[i] = s, a, r, s2, done
        self.ptr = (self.ptr + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)

    def sample(self, batch: int, rng: np.random.RandomState):
        idx = rng.randint(0, self.n, size=batch)
        return (self.s[idx], self.a[idx], self.r[idx], self.s2[idx],
                self.done[idx])


@dataclass
class DDQNConfig:
    state_dim: int
    n_actions: int
    hidden: int = 64
    lr: float = 1e-3
    gamma: float = 0.9
    batch: int = 64
    buffer: int = 20000
    target_update: int = 100  # hard update period (gradient steps)
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 2000
    seed: int = 0


class _Agent:
    """What both agents share: the online and target networks on the
    agent's device, the optimizer, the ε schedule and the update."""

    def __init__(self, cfg: DDQNConfig, device, params):
        self.cfg = cfg
        self.device = require_device(device)
        self.qnet = init_qnet(cfg.seed, cfg.state_dim, cfg.n_actions,
                              cfg.hidden, self.device)
        if params is not None:
            self.qnet.load_state_dict(params)
        self.target = copy.deepcopy(self.qnet).requires_grad_(False)
        self.opt = adamw(self.qnet.parameters(), cfg.lr)
        self.grad_steps = 0  # gradient updates (drives target sync)

    def _epsilon_at(self, steps: int) -> float:
        c = self.cfg
        t = min(1.0, steps / c.eps_decay_steps)
        return c.eps_start + (c.eps_end - c.eps_start) * t

    def _q(self, states) -> torch.Tensor:
        """Q-values of a state or a batch of states (numpy or tensor)."""
        if not isinstance(states, torch.Tensor):
            states = np.asarray(states, np.float32)
        s = torch.as_tensor(states, device=self.device)
        with torch.no_grad(), full_f32():
            return self.qnet(s)

    def train_step(self, batch) -> torch.Tensor:
        """One gradient update on an explicit batch (s, a, r, s2, done),
        then the target sync on the gradient-step cadence. Pre-warm-up
        transitions never reach here, so they do not burn the counter."""
        s, a, r, s2, done = (torch.as_tensor(x, device=self.device)
                             for x in batch)
        loss = ddqn_update(self.qnet, self.target, self.opt, s, a, r, s2,
                           done, gamma=self.cfg.gamma)
        self.grad_steps += 1
        if self.grad_steps % self.cfg.target_update == 0:
            self.target.load_state_dict(self.qnet.state_dict())
        return loss


class DDQNAgent(_Agent):
    """The scalar agent: numpy replay, one transition per ``observe``.
    Runs on the card unless the caller passes ``device="cpu"``;
    ``params`` is a Q-network state dict (e.g.
    ``convert.qnet_params_from_jax``)."""

    def __init__(self, cfg: DDQNConfig, device="cuda",
                 params: Optional[dict] = None):
        super().__init__(cfg, device, params)
        self.buffer = ReplayBuffer(cfg.buffer, cfg.state_dim)
        self.rng = np.random.RandomState(cfg.seed)
        self.steps = 0       # env transitions (drives ε decay)
        # obs: recorder captured at construction; gauges are sampled
        # every ~50 transitions so the scalar training loop stays cheap
        self._rec = obs.get_recorder()

    def epsilon(self) -> float:
        return self._epsilon_at(self.steps)

    def act(self, state: np.ndarray, greedy: bool = False) -> int:
        if not greedy and self.rng.rand() < self.epsilon():
            return int(self.rng.randint(self.cfg.n_actions))
        return int(self._q(np.asarray(state)[None])[0].argmax())

    def observe(self, s, a, r, s2, done) -> float:
        self.buffer.add(s, a, r, s2, float(done))
        self.steps += 1
        loss = 0.0
        if self.buffer.n >= self.cfg.batch:
            loss = float(self.train_step(
                self.buffer.sample(self.cfg.batch, self.rng)))
        if self._rec.enabled and self.steps % 50 == 0:
            self._rec.gauge("ddqn_td_loss", loss, step=self.steps)
            self._rec.gauge("ddqn_epsilon", self.epsilon(), step=self.steps)
            self._rec.gauge("ddqn_q", self.q_stats(s), step=self.steps)
        return loss

    def q_stats(self, state) -> dict:
        """Q(s,·) summary for one state (obs / diagnostics)."""
        q = self._q(np.asarray(state)[None])[0].cpu().numpy()
        return {"q_mean": float(q.mean()), "q_max": float(q.max()),
                "q_min": float(q.min()), "q_argmax": int(q.argmax())}


# ------------------------------------------------------------------
# Device-resident batched agent
# ------------------------------------------------------------------

class ReplayState(NamedTuple):
    """Ring buffer: tensors on the device, and the write pointer and fill
    count on the host (both are pure functions of the insert count, so
    reading them needs no device sync)."""
    s: Any
    a: Any
    r: Any
    s2: Any
    done: Any
    ptr: int  # next write slot
    n: int    # filled entries


def replay_init(capacity: int, state_dim: int, device="cpu") -> ReplayState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayState(s=zeros(capacity, state_dim),
                       a=zeros(capacity, dtype=torch.int64), r=zeros(capacity),
                       s2=zeros(capacity, state_dim), done=zeros(capacity),
                       ptr=0, n=0)


def replay_add_batch(buf: ReplayState, s, a, r, s2, done) -> ReplayState:
    """Insert B transitions at the rolling pointer (wraparound scatter).
    Writes into ``buf``'s tensors in place and returns the state with the
    pointer and count advanced."""
    B = s.shape[0]
    cap = buf.s.shape[0]
    idx = (buf.ptr + torch.arange(B, device=buf.s.device)) % cap
    for dst, src in zip(buf[:5], (s, a, r, s2, done)):
        dst[idx] = src.to(dst.dtype)
    return buf._replace(ptr=(buf.ptr + B) % cap, n=min(buf.n + B, cap))


def replay_sample(buf: ReplayState, gen: torch.Generator, batch: int):
    idx = torch.randint(0, max(buf.n, 1), (batch,), generator=gen,
                        device=buf.s.device)
    return tuple(x[idx] for x in buf[:5])


class BatchedDDQNAgent(_Agent):
    """DDQN whose replay buffer lives on the device (the card unless the
    caller passes ``device="cpu"``).

    ``fused_step(env, env_state, obs)`` performs ε-greedy action
    selection for all B envs → ``env.step`` (the batched P2.1 solve
    inside the reward) → B replay insertions → one sampled gradient
    update (skipped until warm-up) → target sync on the gradient-step
    cadence. The gradient update is the same ``ddqn_update`` the scalar
    agent runs. ε, replay draws and exploration come from the agent's
    ``torch.Generator`` on its device, seeded from ``cfg.seed``.
    """

    def __init__(self, cfg: DDQNConfig, device="cuda",
                 params: Optional[dict] = None):
        super().__init__(cfg, device, params)
        self.replay = replay_init(cfg.buffer, cfg.state_dim, self.device)
        self.env_steps = 0  # total env transitions (drives ε)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(cfg.seed)

    def epsilon(self) -> float:
        return self._epsilon_at(self.env_steps)

    def act(self, obs) -> torch.Tensor:
        """Greedy batched policy. ε-greedy exploration exists only inside
        the fused step, which owns the generator."""
        return self._q(obs).reshape(-1, self.cfg.n_actions).argmax(dim=1)

    def fused_step(self, env, env_state, obs):
        """One fused act+observe+train step over env's B episodes.
        Returns (env_state', obs', reward, done, info, loss)."""
        cfg = self.cfg
        B = obs.shape[0]
        greedy_a = self._q(obs).argmax(dim=1)
        rand_a = torch.randint(0, cfg.n_actions, (B,), generator=self.gen,
                               device=self.device)
        explore = torch.rand(B, generator=self.gen, device=self.device) \
            < self.epsilon()
        a = torch.where(explore, rand_a, greedy_a)
        env_state2, obs2, r, done, info = env.step(env_state, a)
        self.replay = replay_add_batch(self.replay, obs, a, r, obs2,
                                       done.to(torch.float32))
        self.env_steps += B
        if self.replay.n >= cfg.batch:  # warm-up mask, decided on the host
            loss = self.train_step(replay_sample(self.replay, self.gen,
                                                 cfg.batch))
        else:
            loss = torch.zeros((), device=self.device)
        return env_state2, obs2, r, done, info, loss
