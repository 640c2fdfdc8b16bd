"""Shared RL building blocks: flax MLPs and a NumPy ring replay buffer.

Behavioral reference: the vendored PyTorch baselines in plb/algorithms/
(TD3/utils.py ring buffer; discor network.py MLPs). Networks are flax so the
update steps jit/fuse on the device; the buffer stays host-side NumPy (sampling is
host logic between env steps).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np


class MLP(nn.Module):
    hidden: Sequence[int]
    out_dim: int
    activate_final: bool = False

    @nn.compact
    def __call__(self, x):
        for h in self.hidden:
            x = nn.relu(nn.Dense(h)(x))
        x = nn.Dense(self.out_dim)(x)
        if self.activate_final:
            x = nn.relu(x)
        return x


class GaussianPolicy(nn.Module):
    """Tanh-squashed diagonal Gaussian (reference discor/network.py)."""

    action_dim: int
    hidden: Sequence[int] = (256, 256)
    log_std_min: float = -20.0
    log_std_max: float = 2.0

    @nn.compact
    def __call__(self, obs):
        h = obs
        for w in self.hidden:
            h = nn.relu(nn.Dense(w)(h))
        mean = nn.Dense(self.action_dim)(h)
        log_std = nn.Dense(self.action_dim)(h)
        log_std = jnp.clip(log_std, self.log_std_min, self.log_std_max)
        return mean, log_std

    @staticmethod
    def sample(mean, log_std, key):
        std = jnp.exp(log_std)
        eps = jax.random.normal(key, mean.shape)
        pre_tanh = mean + std * eps
        action = jnp.tanh(pre_tanh)
        # log prob with tanh correction
        log_prob = (
            -0.5 * (eps**2) - log_std - 0.5 * jnp.log(2 * jnp.pi)
        ).sum(-1) - jnp.log(1 - action**2 + 1e-6).sum(-1)
        return action, log_prob


class TwinQ(nn.Module):
    """Twin state-action value functions (TD3.py:12-49 / discor network.py)."""

    hidden: Sequence[int] = (256, 256)

    @nn.compact
    def __call__(self, obs, act):
        x = jnp.concatenate([obs, act], axis=-1)
        q1 = MLP(self.hidden, 1)(x)
        q2 = MLP(self.hidden, 1)(x)
        return q1.squeeze(-1), q2.squeeze(-1)


class Actor(nn.Module):
    """Deterministic tanh actor (reference TD3.py:12-27)."""

    action_dim: int
    max_action: float = 1.0
    hidden: Sequence[int] = (256, 256)

    @nn.compact
    def __call__(self, obs):
        h = obs
        for w in self.hidden:
            h = nn.relu(nn.Dense(w)(h))
        return self.max_action * jnp.tanh(nn.Dense(self.action_dim)(h))


class ConvEncoder(nn.Module):
    """NatureCNN-style torso for (H, W, 3) image observations in [0, 1]
    (visual-RL extension — BASELINE configs[3]; the reference has no
    pixel-observation path, its obs are state vectors, plb/envs/env.py:33)."""

    feature_dim: int = 256

    @nn.compact
    def __call__(self, img):
        h = nn.relu(nn.Conv(32, (8, 8), strides=(4, 4))(img))
        h = nn.relu(nn.Conv(64, (4, 4), strides=(2, 2))(h))
        h = nn.relu(nn.Conv(64, (3, 3), strides=(1, 1))(h))
        h = h.reshape((h.shape[0], -1))
        return nn.relu(nn.Dense(self.feature_dim)(h))


class VisualGaussianPolicy(nn.Module):
    """ConvEncoder + tanh-Gaussian head on image obs."""

    action_dim: int

    @nn.compact
    def __call__(self, img):
        f = ConvEncoder()(img)
        return GaussianPolicy(action_dim=self.action_dim, hidden=(256,))(f)

    sample = GaussianPolicy.sample


class VisualActor(nn.Module):
    """ConvEncoder + deterministic tanh head on image obs (visual-RL
    extension for TD3 — BASELINE configs[3])."""

    action_dim: int
    max_action: float = 1.0

    @nn.compact
    def __call__(self, img):
        f = ConvEncoder()(img)
        return Actor(action_dim=self.action_dim,
                     max_action=self.max_action, hidden=(256,))(f)


class VisualTwinQ(nn.Module):
    """ConvEncoder + twin Q heads on image obs (own encoder — standard
    practice: critic gradients shape the representation)."""

    @nn.compact
    def __call__(self, img, act):
        f = ConvEncoder()(img)
        return TwinQ(hidden=(256,))(f, act)


class ImageReplayBuffer:
    """Ring buffer for uint8 image observations (stored compact; sampled as
    float32 in [0, 1]). 100k 64^2 rgb frames ~ 2.5 GB host RAM."""

    def __init__(self, obs_shape: Tuple[int, ...], action_dim: int,
                 max_size: int = 100_000):
        self.max_size = max_size
        self.ptr = 0
        self.size = 0
        self.state = np.zeros((max_size,) + tuple(obs_shape), np.uint8)
        self.action = np.zeros((max_size, action_dim), np.float32)
        self.next_state = np.zeros((max_size,) + tuple(obs_shape), np.uint8)
        self.reward = np.zeros((max_size,), np.float32)
        self.not_done = np.zeros((max_size,), np.float32)

    def add(self, state, action, next_state, reward, done):
        self.state[self.ptr] = state
        self.action[self.ptr] = action
        self.next_state[self.ptr] = next_state
        self.reward[self.ptr] = reward
        self.not_done[self.ptr] = 1.0 - done
        self.ptr = (self.ptr + 1) % self.max_size
        self.size = min(self.size + 1, self.max_size)

    def sample(self, batch_size: int, rng: np.random.Generator):
        ind = rng.integers(0, self.size, size=batch_size)
        return (
            self.state[ind].astype(np.float32) / 255.0,
            self.action[ind],
            self.next_state[ind].astype(np.float32) / 255.0,
            self.reward[ind],
            self.not_done[ind],
        )


class ReplayBuffer:
    """Ring buffer (reference TD3/utils.py:5-40)."""

    def __init__(self, state_dim: int, action_dim: int, max_size: int = int(1e6)):
        self.max_size = max_size
        self.ptr = 0
        self.size = 0
        self.state = np.zeros((max_size, state_dim), np.float32)
        self.action = np.zeros((max_size, action_dim), np.float32)
        self.next_state = np.zeros((max_size, state_dim), np.float32)
        self.reward = np.zeros((max_size,), np.float32)
        self.not_done = np.zeros((max_size,), np.float32)

    def add(self, state, action, next_state, reward, done):
        self.state[self.ptr] = state
        self.action[self.ptr] = action
        self.next_state[self.ptr] = next_state
        self.reward[self.ptr] = reward
        self.not_done[self.ptr] = 1.0 - done
        self.ptr = (self.ptr + 1) % self.max_size
        self.size = min(self.size + 1, self.max_size)

    def sample(self, batch_size: int, rng: np.random.Generator):
        ind = rng.integers(0, self.size, size=batch_size)
        return (
            self.state[ind], self.action[ind], self.next_state[ind],
            self.reward[ind], self.not_done[ind],
        )


class DeviceReplayBuffer:
    """Device-resident ring buffer: transitions never leave the accelerator.

    The host-side ``ReplayBuffer`` (reference TD3/utils.py:5-40 semantics)
    costs two transfers per learner step — D2H for every collected
    observation and H2D for every sampled minibatch. Here the storage is
    jnp arrays in device memory, writes land as one jitted batched scatter per env step,
    and the learners sample indices *inside* their scanned update program
    (``SAC.update_many_device`` / ``TD3.train_many_device``), so the only
    per-step host traffic is the scalar episode bookkeeping.

    Capacity is a real HBM commitment (max_size × obs_dim × 8 bytes for the
    two obs arrays) — size it to the run budget, not the reference's 1e6.
    """

    def __init__(self, state_dim, action_dim: int,
                 max_size: int = 1 << 18, obs_dtype=jnp.float32):
        obs_shape = (tuple(state_dim) if isinstance(state_dim, (tuple, list))
                     else (state_dim,))
        self.max_size = max_size
        self.ptr = 0
        self.size = 0
        self.obs_dtype = obs_dtype
        self.state = jnp.zeros((max_size,) + obs_shape, obs_dtype)
        self.action = jnp.zeros((max_size, action_dim), jnp.float32)
        self.next_state = jnp.zeros((max_size,) + obs_shape, obs_dtype)
        self.reward = jnp.zeros((max_size,), jnp.float32)
        self.not_done = jnp.zeros((max_size,), jnp.float32)
        self._write = jax.jit(self._write_impl)

    def _write_impl(self, bufs, ptr, state, action, next_state, reward,
                    not_done):
        idx = (ptr + jnp.arange(state.shape[0])) % self.max_size
        st, ac, ns, rw, nd = bufs
        return (st.at[idx].set(state), ac.at[idx].set(action),
                ns.at[idx].set(next_state), rw.at[idx].set(reward),
                nd.at[idx].set(not_done))

    def add_batch(self, state, action, next_state, reward, done):
        """Append B transitions (device or host arrays) in one dispatch."""
        state = jnp.asarray(state, self.obs_dtype)
        b = state.shape[0]
        bufs = (self.state, self.action, self.next_state, self.reward,
                self.not_done)
        (self.state, self.action, self.next_state, self.reward,
         self.not_done) = self._write(
            bufs, self.ptr, state, jnp.asarray(action, jnp.float32),
            jnp.asarray(next_state, self.obs_dtype),
            jnp.asarray(reward, jnp.float32),
            1.0 - jnp.asarray(done, jnp.float32))
        self.ptr = (self.ptr + b) % self.max_size
        self.size = min(self.size + b, self.max_size)

    def arrays(self):
        return (self.state, self.action, self.next_state, self.reward,
                self.not_done)


class DeviceImageReplayBuffer(DeviceReplayBuffer):
    """Device-resident ring buffer for uint8 image observations. Frames are
    stored compact (uint8) in HBM and scaled to float32 [0, 1] in-graph by
    the learner's sampled-update program (64k 64^2 rgb frames ~ 1.5 GB HBM
    for both obs arrays)."""

    def __init__(self, obs_shape, action_dim: int, max_size: int = 1 << 16):
        super().__init__(obs_shape, action_dim, max_size, jnp.uint8)


def sample_device_batch(bufs, size, batch_size, key):
    """In-graph uniform minibatch draw from a DeviceReplayBuffer's arrays."""
    idx = jax.random.randint(key, (batch_size,), 0, size)
    return tuple(b[idx] for b in bufs)


def normalize_obs(x, stats, clip: float = 10.0):
    """(x - mean) * inv_std, clipped (VecNormalize semantics — the same
    normalization the PPO loop applies host-side, run_ppo.RunningMeanStd)."""
    mean, inv_std = stats
    return jnp.clip((x - mean) * inv_std, -clip, clip)


class DeviceObsRMS:
    """Running observation mean/var kept as device arrays (parallel-merge
    Welford, identical update rule to ppo.run_ppo.RunningMeanStd). One tiny
    jitted dispatch per collected batch; stats() feeds the in-graph
    normalization of SAC.update_many_device / TD3.train_many_device, so raw
    observations never cross the host boundary for normalization."""

    def __init__(self, dim: int):
        self.mean = jnp.zeros((dim,), jnp.float32)
        self.var = jnp.ones((dim,), jnp.float32)
        self.count = 1e-4
        self._merge = jax.jit(self._merge_impl)

    @staticmethod
    def _merge_impl(mean, var, count, x):
        bmean, bvar = x.mean(0), x.var(0)
        bcount = x.shape[0]
        delta = bmean - mean
        tot = count + bcount
        new_mean = mean + delta * bcount / tot
        m_a = var * count
        m_b = bvar * bcount
        new_var = (m_a + m_b + delta**2 * count * bcount / tot) / tot
        return new_mean, new_var

    def update(self, x):
        x = jnp.asarray(x, jnp.float32)
        self.mean, self.var = self._merge(
            self.mean, self.var, jnp.float32(self.count), x)
        self.count += x.shape[0]

    def stats(self):
        return self.mean, 1.0 / (jnp.sqrt(self.var) + 1e-8)


def soft_update(target_params, online_params, tau: float):
    return jax.tree.map(
        lambda t, o: t * (1.0 - tau) + o * tau, target_params, online_params
    )
