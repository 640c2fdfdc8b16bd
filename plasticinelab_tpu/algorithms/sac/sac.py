"""SAC with automatic entropy tuning, in JAX/flax/optax.

Behavioral reference: plb/algorithms/discor/algorithm/sac.py — twin soft-Q,
tanh-Gaussian policy, target entropy -|A|, log-alpha optimized; same default
hyperparameters (gamma 0.99, lrs 3e-4, tau 0.005, hidden 256x256).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..common import GaussianPolicy, ReplayBuffer, TwinQ, soft_update


class SACState(NamedTuple):
    policy: dict
    policy_opt: optax.OptState
    q: dict
    q_target: dict
    q_opt: optax.OptState
    log_alpha: jnp.ndarray
    alpha_opt: optax.OptState


class SAC:
    def __init__(self, state_dim, action_dim, gamma=0.99, policy_lr=3e-4,
                 q_lr=3e-4, entropy_lr=3e-4, target_update_coef=0.005, seed=0,
                 alpha_cap=2.0):
        """state_dim: int (state-vector obs, reference parity) or a 3-tuple
        (H, W, C) image shape (visual-obs extension, BASELINE configs[3]) —
        networks switch to ConvEncoder torsos; explore/exploit then expect
        uint8 images and scale to [0, 1].

        alpha_cap: upper bound on the entropy temperature (see the
        _update_impl clamp). None = uncapped = exact reference dynamics
        (discor/algorithm/sac.py:130-137 has no cap)."""
        self.gamma = gamma
        self.tau = target_update_coef
        self.target_entropy = -float(action_dim)
        # cap for the entropy temperature (see _update_impl alpha clamp)
        self.log_alpha_max = (float(np.log(alpha_cap))
                              if alpha_cap is not None else float("inf"))

        self.visual = isinstance(state_dim, (tuple, list))
        if self.visual:
            from ..common import VisualGaussianPolicy, VisualTwinQ

            self.policy_def = VisualGaussianPolicy(action_dim=action_dim)
            self.q_def = VisualTwinQ()
            obs = jnp.zeros((1,) + tuple(state_dim))
        else:
            self.policy_def = GaussianPolicy(action_dim=action_dim)
            self.q_def = TwinQ()
            obs = jnp.zeros((1, state_dim))
        key = jax.random.PRNGKey(seed)
        k1, k2, self._key = jax.random.split(key, 3)
        act = jnp.zeros((1, action_dim))
        policy_params = self.policy_def.init(k1, obs)
        q_params = self.q_def.init(k2, obs, act)

        self.policy_tx = optax.adam(policy_lr)
        self.q_tx = optax.adam(q_lr)
        self.alpha_tx = optax.adam(entropy_lr)
        log_alpha = jnp.zeros(())
        self.state = SACState(
            policy=policy_params, policy_opt=self.policy_tx.init(policy_params),
            q=q_params, q_target=q_params, q_opt=self.q_tx.init(q_params),
            log_alpha=log_alpha, alpha_opt=self.alpha_tx.init(log_alpha),
        )
        self._update = jax.jit(self._update_impl)
        self._update_many = jax.jit(self._update_many_impl)
        self._update_many_device = jax.jit(
            self._update_many_device_impl, static_argnums=(4, 5))
        self._explore = jax.jit(self._explore_impl)
        self._exploit = jax.jit(self._exploit_impl)

    # ---- acting ----
    def _explore_impl(self, params, obs, key):
        key, sub = jax.random.split(key)
        mean, log_std = self.policy_def.apply(params, obs)
        action, _ = GaussianPolicy.sample(mean, log_std, sub)
        return action, key

    def _exploit_impl(self, params, obs):
        mean, _ = self.policy_def.apply(params, obs)
        return jnp.tanh(mean)

    def _prep(self, state: np.ndarray) -> np.ndarray:
        if self.visual:
            return state[None].astype(np.float32) / 255.0
        return state[None]

    def explore(self, state: np.ndarray) -> np.ndarray:
        # The key split lives inside the jit — one dispatch, no host-side
        # split round-trip per action.
        action, self._key = self._explore(
            self.state.policy, self._prep(state), self._key)
        return np.asarray(action)[0]

    def exploit(self, state: np.ndarray) -> np.ndarray:
        return np.asarray(self._exploit(self.state.policy, self._prep(state)))[0]

    def explore_batch(self, states: np.ndarray) -> np.ndarray:
        """Batched explore: one dispatch for a (B, ...) observation stack
        (vectorized collection, run_sac.train_vec)."""
        if self.visual:
            states = np.asarray(states, np.float32) / 255.0
        actions, self._key = self._explore(
            self.state.policy, states, self._key)
        return np.asarray(actions)

    # ---- learning ----
    def _update_impl(self, ts: SACState, batch, key):
        state, action, next_state, reward, not_done = batch
        key, k1, k2 = jax.random.split(key, 3)
        alpha = jnp.exp(ts.log_alpha)

        mean, log_std = self.policy_def.apply(ts.policy, next_state)
        next_action, next_logp = GaussianPolicy.sample(mean, log_std, k1)
        tq1, tq2 = self.q_def.apply(ts.q_target, next_state, next_action)
        target_q = reward + not_done * self.gamma * (
            jnp.minimum(tq1, tq2) - alpha * next_logp
        )
        target_q = jax.lax.stop_gradient(target_q)

        def q_loss_fn(qp):
            q1, q2 = self.q_def.apply(qp, state, action)
            return jnp.mean((q1 - target_q) ** 2) + jnp.mean((q2 - target_q) ** 2)

        qloss, qgrad = jax.value_and_grad(q_loss_fn)(ts.q)
        qupd, qopt = self.q_tx.update(qgrad, ts.q_opt)
        q = optax.apply_updates(ts.q, qupd)

        def policy_loss_fn(pp):
            m, ls = self.policy_def.apply(pp, state)
            a, logp = GaussianPolicy.sample(m, ls, k2)
            q1, q2 = self.q_def.apply(q, state, a)
            return jnp.mean(alpha * logp - jnp.minimum(q1, q2)), logp

        (ploss, logp), pgrad = jax.value_and_grad(policy_loss_fn, has_aux=True)(ts.policy)
        pupd, popt = self.policy_tx.update(pgrad, ts.policy_opt)
        policy = optax.apply_updates(ts.policy, pupd)

        def alpha_loss_fn(la):
            # Optimize in log-space with the LINEAR form the reference uses
            # (discor/algorithm/sac.py:134-136: loss ∝ log_alpha, so
            # d loss/d log_alpha is bounded by |logp + target_entropy|).
            # The exp(la) form has gradient ∝ alpha itself — a positive
            # entropy deficit then grows alpha exponentially (observed:
            # alpha 0.2 → 3e5 in 50k steps, collapsing the policy).
            return -jnp.mean(
                la * jax.lax.stop_gradient(logp + self.target_entropy)
            )

        _, agrad = jax.value_and_grad(alpha_loss_fn)(ts.log_alpha)
        aupd, aopt = self.alpha_tx.update(agrad, ts.alpha_opt)
        log_alpha = optax.apply_updates(ts.log_alpha, aupd)
        # Stability guard (deviation from reference, PARITY.md): cap alpha.
        # Saturated-action optima (|a|→1 is genuinely optimal when pushing)
        # make the tanh-corrected target entropy unreachable; alpha then
        # ratchets up at the full Adam rate forever and the entropy term
        # destroys the learned policy (probe: eval IoU 0.79 → 0.0 as alpha
        # crossed ~1). The cap bounds the entropy weight at a level where
        # exploitation still wins; healthy equilibria observed are ≤ 0.5.
        log_alpha = jnp.clip(log_alpha, -9.2, self.log_alpha_max)

        q_target = soft_update(ts.q_target, q, self.tau)
        return SACState(
            policy=policy, policy_opt=popt, q=q, q_target=q_target, q_opt=qopt,
            log_alpha=log_alpha, alpha_opt=aopt,
        ), qloss, key

    def update(self, replay_buffer: ReplayBuffer, batch_size=256, rng=None):
        rng = rng or np.random.default_rng(0)
        batch = replay_buffer.sample(batch_size, rng)
        self.state, loss, self._key = self._update(
            self.state, batch, self._key)
        # Device scalar — float() it at the logging site; fetching here would
        # block the host on every update step.
        return loss

    def _update_many_impl(self, ts: SACState, batches, key):
        def body(carry, batch):
            ts, key = carry
            ts, loss, key = self._update_impl(ts, batch, key)
            return (ts, key), loss

        (ts, key), losses = jax.lax.scan(body, (ts, key), batches)
        return ts, losses[-1], key

    def update_many(self, replay_buffer, batch_size=256, rng=None, n=1):
        """n gradient updates in ONE dispatch: sample n minibatches and scan
        the update step over them. Dispatch latency (not FLOPs) dominates
        small conv updates, so the vectorized visual collection loop calls
        this instead of n separate update()s."""
        if n <= 1:
            return self.update(replay_buffer, batch_size, rng)
        rng = rng or np.random.default_rng(0)
        parts = [replay_buffer.sample(batch_size, rng) for _ in range(n)]
        batches = tuple(np.stack(p) for p in zip(*parts))
        self.state, loss, self._key = self._update_many(
            self.state, batches, self._key)
        return loss

    def _update_many_device_impl(self, ts, bufs, size, key, batch_size, n,
                                 obs_stats=None):
        from ..common import normalize_obs, sample_device_batch

        def body(carry, _):
            ts, key = carry
            key, ks = jax.random.split(key)
            batch = sample_device_batch(bufs, size, batch_size, ks)
            if self.visual:  # uint8-stored frames -> float [0, 1] in-graph
                batch = ((batch[0].astype(jnp.float32) / 255.0, batch[1],
                          batch[2].astype(jnp.float32) / 255.0)
                         + batch[3:])
            elif obs_stats is not None:
                # raw obs in the buffer, current running stats at update
                # time (VecNormalize-style; reference run_ppo.py analog)
                batch = ((normalize_obs(batch[0], obs_stats), batch[1],
                          normalize_obs(batch[2], obs_stats)) + batch[3:])
            ts, loss, key = self._update_impl(ts, batch, key)
            return (ts, key), loss

        (ts, key), losses = jax.lax.scan(body, (ts, key), None, length=n)
        return ts, losses[-1], key

    def update_many_device(self, replay_buffer, batch_size=256, n=1,
                           obs_stats=None):
        """n gradient updates in ONE dispatch with minibatches sampled
        IN-GRAPH from a DeviceReplayBuffer — no host round-trip for the
        training data (the host ReplayBuffer path moves ~n*batch*obs_dim
        floats host<->device per call). obs_stats: optional
        (mean, inv_std) arrays — buffers hold RAW obs, minibatches are
        normalized in-graph with the stats current at update time."""
        self.state, loss, self._key = self._update_many_device(
            self.state, replay_buffer.arrays(),
            jnp.asarray(replay_buffer.size), self._key, batch_size, n,
            obs_stats)
        return loss

    def save_models(self, path):
        import pickle, os

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "sac_state.pkl"), "wb") as f:
            pickle.dump(jax.device_get(self.state), f)

    def load_models(self, path):
        import pickle, os

        with open(os.path.join(path, "sac_state.pkl"), "rb") as f:
            self.state = jax.device_put(pickle.load(f))
