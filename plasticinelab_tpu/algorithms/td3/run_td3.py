"""TD3 training loop (behavioral reference: plb/algorithms/TD3/run_td3.py —
same cadence: 2500 random warmup steps, train every step after warmup,
eval every 200 episodes over 5 episodes, save final actor)."""
from __future__ import annotations

import os

import numpy as np

from ..common import ReplayBuffer
from .ddpg import DDPG, OriginalDDPG
from .td3 import TD3


def eval_policy(policy, env, seed, eval_episodes=5):
    avg_reward = 0.0
    ep_iou, ep_last_iou = 0.0, 0.0
    for _ in range(eval_episodes):
        state, done = _reset(env), False
        t = 0
        while not done and t < env._max_episode_steps:
            action = policy.select_action(np.array(state))
            state, reward, done, info = _step(env, action)
            avg_reward += reward
            ep_iou += info["incremental_iou"]
            t += 1
        ep_last_iou += info["incremental_iou"]
    avg_reward /= eval_episodes
    print("---------------------------------------")
    print(f"Evaluation over {eval_episodes} episodes: {avg_reward:.3f}")
    print("---------------------------------------")
    return avg_reward, ep_iou / eval_episodes, ep_last_iou / eval_episodes


def _reset(env):
    out = env.reset()
    return out[0] if isinstance(out, tuple) else out


def _step(env, action):
    out = env.step(action)
    if len(out) == 5:  # gymnasium
        obs, r, term, trunc, info = out
        return obs, r, bool(term or trunc), info
    return out


def train_td3(env, path, logger, old_args):
    start_timesteps = int(getattr(old_args, "start_timesteps", 2500))
    eval_freq = 200  # episodes
    max_timesteps = old_args.num_steps
    expl_noise = 0.1
    batch_size = 256

    os.makedirs(path, exist_ok=True)
    obs_shape = env.observation_space.shape
    visual = len(obs_shape) == 3  # rgb obs_mode (BASELINE configs[3])
    state_dim = obs_shape if visual else obs_shape[0]
    action_dim = env.action_space.shape[0]
    max_action = float(env.action_space.high[0])

    # policy dispatch (reference TD3/main.py:99-107: TD3 | OurDDPG | DDPG)
    which = getattr(old_args, "policy", "TD3")
    if which == "TD3":
        policy = TD3(
            state_dim, action_dim, max_action=max_action, discount=0.99,
            tau=0.005, policy_noise=0.2 * max_action,
            noise_clip=0.5 * max_action, policy_freq=2, seed=old_args.seed,
        )
    elif which == "OurDDPG":
        assert not visual, "rgb obs_mode is wired for --policy TD3"
        policy = DDPG(state_dim, action_dim, max_action=max_action,
                      discount=0.99, tau=0.005, seed=old_args.seed)
    elif which == "DDPG":
        assert not visual, "rgb obs_mode is wired for --policy TD3"
        policy = OriginalDDPG(state_dim, action_dim, max_action=max_action,
                              discount=0.99, seed=old_args.seed)
    else:
        raise ValueError(f"unknown policy {which!r}")
    vec = int(getattr(old_args, "vec_envs", 0) or 0)
    if vec > 1:
        return train_td3_vec(policy, old_args, path, batch=vec)

    if visual:
        from ..common import ImageReplayBuffer

        replay_buffer = ImageReplayBuffer(obs_shape, action_dim, 100_000)
    else:
        replay_buffer = ReplayBuffer(state_dim, action_dim)
    rng = np.random.default_rng(old_args.seed)

    state, done = _reset(env), False
    episode_timesteps = 0
    episode_num = 0
    logger.reset()

    for t in range(int(max_timesteps)):
        episode_timesteps += 1
        if t < start_timesteps:
            action = env.action_space.sample()
        else:
            action = (
                policy.select_action(np.array(state))
                + rng.normal(0, max_action * expl_noise, size=action_dim)
            ).clip(-max_action, max_action)

        next_state, reward, done, info = _step(env, action)
        done_bool = float(done) if episode_timesteps < env._max_episode_steps else 0.0
        replay_buffer.add(state, action, next_state, reward, done_bool)
        state = next_state
        logger.step(None, None, reward, None,
                    episode_timesteps >= env._max_episode_steps, info)

        if t >= start_timesteps:
            policy.train(replay_buffer, batch_size, rng)

        if done or episode_timesteps >= env._max_episode_steps:
            state, done = _reset(env), False
            episode_timesteps = 0
            episode_num += 1
            logger.reset()
            if episode_num % eval_freq == 0:
                eval_policy(policy, env, old_args.seed)

    policy.save(os.path.join(path, "model"))
    return policy


def train_td3_vec(policy, old_args, path, batch=8, horizon=50, venv=None,
                  start_timesteps=2500):
    """Collect transitions with the batched on-device env
    (parallel/rollout.VecPlasticineEnv): B envs step in one jitted program,
    one learner update per collected transition-batch — the batched
    alternative to the reference's one-env host loop (TD3/run_td3.py)."""
    import time

    from ...parallel.rollout import VecPlasticineEnv

    if venv is None:
        venv = VecPlasticineEnv(
            old_args.env_name, batch=batch, seed=old_args.seed,
            horizon=horizon,
            obs_mode=getattr(old_args, "obs_mode", "state"),
            image_obs_res=getattr(old_args, "image_obs_res", 64),
            image_obs_spp=getattr(old_args, "image_obs_spp", 2))
    batch, horizon = venv.batch, venv.horizon
    # Device-resident replay: collected obs never leave the device and the
    # update samples its minibatches in-graph — no per-step D2H/H2D
    # transfers of the host numpy buffer.
    if venv.obs_mode == "rgb":
        from ..common import DeviceImageReplayBuffer

        replay = DeviceImageReplayBuffer(venv.obs_shape, venv.action_dim)
    else:
        from ..common import DeviceReplayBuffer

        replay = DeviceReplayBuffer(venv.obs_dim, venv.action_dim)
    rng = np.random.default_rng(old_args.seed)
    os.makedirs(path, exist_ok=True)

    import jax.numpy as jnp

    zeros_done = jnp.zeros((batch,))
    expl_noise = 0.1
    steps = 0
    t0 = time.perf_counter()
    obs = venv.reset()
    ep_t = 0
    while steps < old_args.num_steps:
        if steps < start_timesteps:
            actions = rng.uniform(
                -1, 1, (batch, venv.action_dim)).astype(np.float32)
        else:
            acts = policy.select_action_batch(np.asarray(obs))
            actions = (
                acts + rng.normal(0, expl_noise, acts.shape)
            ).clip(-1, 1).astype(np.float32)
        nobs, reward, done, _ = venv.step(actions)
        ep_t += 1
        replay.add_batch(obs, actions, nobs, reward, zeros_done)
        obs = nobs
        steps += batch
        if steps >= start_timesteps:
            # reference cadence: one gradient update per env step collected
            policy.train_many_device(replay, 256, n=batch)
        if ep_t >= horizon:
            obs = venv.reset()
            ep_t = 0
    dt = time.perf_counter() - t0
    print(f"[TD3 vec] {steps} env steps in {dt:.1f}s "
          f"({steps / dt:.1f} steps/s, batch={batch})")
    policy.save(os.path.join(path, "model"))
    return policy
