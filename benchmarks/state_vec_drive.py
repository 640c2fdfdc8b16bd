"""State-observation RL training drive at batch scale: SAC/DisCor/TD3 on B
vectorized on-device envs (the reference's 500k-env-step benchmark,
run_sac.py / agent.py in /root/reference/plb/algorithms/discor, re-hosted on
the batched on-device rollout path).

Training cadence matches the reference agent loop (agent.py:94-111 +
run_sac.py:30-38): start_steps=2500 uniform exploration, then ONE gradient
update per collected env step (B scanned updates per venv.step), batch 256.
Optional (opt-in, PLB_STATERL_OBSNORM=1): VecNormalize-style running
observation normalization applied in-graph at update time from raw stored
obs — the reference's PPO path normalizes, its SAC/TD3 don't, so the
default is OFF for reference parity.

Every `eval_every` episode batches the drive runs one EXPLOITATION episode
(mean-action policy, reference algo.exploit / agent.evaluate) and logs mean
return plus mean final-step **incremental IoU** — the benchmark's headline
metric (reference loss.py:293-294).

The whole data path is device-resident: obs/reward stay on the device, the
replay buffer is a DeviceReplayBuffer (one batched-scatter write per step),
and updates sample their minibatches in-graph.

Usage: python benchmarks/state_vec_drive.py [num_steps] [env_name] [batch]
                                            [algo: sac|discor|td3]
Env:   PLB_STATERL_EPLOG=path  append per-episode JSONL rows
       PLB_STATERL_UPDATES=n   gradient updates per collected batch
                               (default B = reference's 1 per env step)
       PLB_STATERL_OBSNORM=1   enable obs normalization (off by default =
                               reference parity for SAC/TD3)
       PLB_STATERL_EVAL_EVERY=k  exploit-eval every k episode batches
       PLB_STATERL_SAVE=path   save final models under path
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(num_steps=200_000, env_name="Move-v1", batch=32, algo_name="sac"):
    import jax.numpy as jnp

    from plasticinelab_tpu.algorithms.common import (
        DeviceObsRMS, DeviceReplayBuffer, normalize_obs)
    from plasticinelab_tpu.parallel.rollout import VecPlasticineEnv

    venv = VecPlasticineEnv(env_name, batch=batch, seed=0)
    if algo_name == "td3":
        from plasticinelab_tpu.algorithms.td3.td3 import TD3

        algo = TD3(venv.obs_dim, venv.action_dim, max_action=1.0, seed=0)
    else:
        if algo_name == "discor":
            from plasticinelab_tpu.algorithms.sac.discor import DisCor as cls
        else:
            from plasticinelab_tpu.algorithms.sac.sac import SAC as cls
        algo = cls(state_dim=venv.obs_dim, action_dim=venv.action_dim,
                   gamma=0.99, policy_lr=3e-4, q_lr=3e-4, entropy_lr=3e-4,
                   target_update_coef=0.005, seed=0)
        # PLB_STATERL_ALPHA_CAP: "none" = uncapped (exact reference alpha
        # dynamics), else a float cap (default 2.0, sac.py)
        cap_env = os.environ.get("PLB_STATERL_ALPHA_CAP")
        if cap_env is not None:
            algo.log_alpha_max = (float("inf")
                                  if cap_env.lower() in ("none", "inf")
                                  else float(np.log(float(cap_env))))
    # 2^18 transitions x obs_dim~1214 x 2 obs arrays = ~2.5 GB HBM
    replay = DeviceReplayBuffer(venv.obs_dim, venv.action_dim,
                                max_size=1 << 18)
    rng = np.random.default_rng(0)

    # default OFF = exact reference parity (the reference's SAC/TD3 feed raw
    # obs); opt in with PLB_STATERL_OBSNORM=1. All committed artifacts since
    # r04 were produced with it off.
    obs_norm = os.environ.get("PLB_STATERL_OBSNORM", "0") == "1"
    rms = DeviceObsRMS(venv.obs_dim) if obs_norm else None

    # reference run_sac.py:35: start_steps=2500 uniform exploration
    start_steps = min(2500, max(num_steps // 10, 2 * batch))
    horizon = venv.horizon
    sac_batch = 256  # reference discor batch_size
    # reference update_interval=1: one gradient update per env step collected
    n_updates = int(os.environ.get("PLB_STATERL_UPDATES", batch))
    eval_every = int(os.environ.get("PLB_STATERL_EVAL_EVERY", "5"))

    def policy_obs(o):
        return normalize_obs(o, rms.stats()) if obs_norm else o

    def run_eval():
        """One exploitation episode over the B envs (reference
        agent.evaluate / algo.exploit). Returns (mean return, mean final
        incremental IoU). Uses the training venv; callers reset after."""
        eobs = venv.reset()
        ret = jnp.zeros((batch,))
        inc = None
        for _ in range(horizon):
            if algo_name == "td3":
                acts = algo._select(algo.state.actor,
                                    jnp.asarray(policy_obs(eobs)))
            else:
                acts = algo._exploit(algo.state.policy,
                                     jnp.asarray(policy_obs(eobs)))
            eobs, r, _, info = venv.step(acts)
            ret = ret + r
            inc = info["incremental_iou"]
        return float(jnp.mean(ret)), float(jnp.mean(inc))

    ep_rewards = []   # per-episode-batch mean step reward (exploration)
    ep_ious = []      # per-episode-batch mean final-step incremental IoU
    evals = []        # (steps, eval_return, eval_incremental_iou)
    # Best-eval policy protection (round-4 verdict: the probe solved the
    # scene then destroyed the policy; nothing kept the result). JAX params
    # are immutable — snapshotting is keeping a reference, zero copies.
    best = {"iou": -1.0, "state": None, "steps": 0}
    steps = 0
    t_start = time.perf_counter()
    t_steady = None
    ep_log = os.environ.get("PLB_STATERL_EPLOG")
    obs = venv.reset()
    ep_t = 0
    ep_r = jnp.zeros((batch,))
    zeros_done = jnp.zeros((batch,))
    last_inc = None
    while steps < num_steps:
        if steps < start_steps:
            actions = rng.uniform(
                -1, 1, (batch, venv.action_dim)).astype(np.float32)
        elif algo_name == "td3":
            # reference TD3 exploration: actor + N(0, 0.1) noise, clipped
            actions = np.clip(
                np.asarray(algo.select_action_batch(
                    np.asarray(policy_obs(obs))))
                + rng.normal(0, 0.1, (batch, venv.action_dim)),
                -1, 1).astype(np.float32)
        else:
            actions = algo.explore_batch(policy_obs(obs))
        nobs, reward, done, info = venv.step(actions)
        last_inc = info["incremental_iou"]
        ep_t += 1
        ep_r = ep_r + reward
        replay.add_batch(obs, actions, nobs, reward, zeros_done)
        if obs_norm:
            rms.update(obs)
        obs = nobs
        steps += batch
        if steps >= start_steps:
            if t_steady is None:
                t_steady = (time.perf_counter(), steps)
            stats = rms.stats() if obs_norm else None
            if algo_name == "td3":
                algo.train_many_device(replay, sac_batch, n_updates,
                                       obs_stats=stats)
            else:
                algo.update_many_device(replay, sac_batch, n_updates,
                                        obs_stats=stats)
        if ep_t >= horizon:
            ep_rewards.append(float(jnp.mean(ep_r)) / ep_t)
            ep_ious.append(float(jnp.mean(last_inc)))
            row = {
                "episode_batch": len(ep_rewards), "steps": steps,
                "mean_step_reward": round(ep_rewards[-1], 5),
                "mean_final_incremental_iou": round(ep_ious[-1], 5),
                "wall_s": round(time.perf_counter() - t_start, 1),
            }
            if algo_name != "td3":  # entropy-temperature diagnostic
                row["alpha"] = round(float(jnp.exp(algo.state.log_alpha)), 5)
            if len(ep_rewards) % eval_every == 0 and steps >= start_steps:
                er, ei = run_eval()
                evals.append({"steps": steps,
                              "eval_return": round(er, 3),
                              "eval_incremental_iou": round(ei, 5)})
                row.update(evals[-1])
                if ei > best["iou"]:
                    best.update(iou=ei, state=algo.state, steps=steps)
            if ep_log:
                with open(ep_log, "a") as f:
                    f.write(json.dumps(row) + "\n")
            obs = venv.reset()
            ep_t = 0
            ep_r = jnp.zeros((batch,))

    # Restore the best-eval policy (the reference trains past its peak too;
    # we additionally KEEP the peak) and verify it still evaluates.
    best_restored = None
    if best["state"] is not None:
        final_state = algo.state
        algo.state = best["state"]
        er, ei = run_eval()
        best_restored = {"steps": best["steps"],
                         "best_eval_incremental_iou": round(best["iou"], 5),
                         "restored_eval_return": round(er, 3),
                         "restored_eval_incremental_iou": round(ei, 5)}
        save_dir = os.environ.get("PLB_STATERL_SAVE")
        if save_dir:  # save BOTH: best under best/, final at the root
            if algo_name == "td3":
                algo.save(os.path.join(save_dir, "best", "td3"))
            else:
                algo.save_models(os.path.join(save_dir, "best"))
        algo.state = final_state

    save_dir = os.environ.get("PLB_STATERL_SAVE")
    if save_dir:
        if algo_name == "td3":
            algo.save(os.path.join(save_dir, "td3"))
        else:
            algo.save_models(save_dir)

    total = time.perf_counter() - t_start
    steady_sps = ((steps - t_steady[1]) / (time.perf_counter() - t_steady[0])
                  if t_steady and steps > t_steady[1] else None)
    k = max(len(ep_rewards) // 4, 1)
    first_q = float(np.mean(ep_rewards[:k])) if ep_rewards else None
    last_q = float(np.mean(ep_rewards[-k:])) if ep_rewards else None
    iou_first = float(np.mean(ep_ious[:k])) if ep_ious else None
    iou_last = float(np.mean(ep_ious[-k:])) if ep_ious else None
    ek = max(len(evals) // 4, 1)
    out = ({
        "metric": f"state_{algo_name}_vec_learning",
        "value": round(steps / total, 3),
        "unit": f"env steps/s ({algo_name.upper()}, state obs, {env_name}, "
                f"B={batch} vectorized explore+update)",
        "vs_baseline": None,
        "extra": {
            "num_steps": steps,
            "wallclock_s": round(total, 1),
            "steady_steps_per_sec": (round(steady_sps, 3)
                                     if steady_sps else None),
            "episode_batches": len(ep_rewards),
            "mean_reward_first_quarter": (round(first_q, 4)
                                          if first_q is not None else None),
            "mean_reward_last_quarter": (round(last_q, 4)
                                         if last_q is not None else None),
            "explore_incremental_iou_first_quarter": (
                round(iou_first, 4) if iou_first is not None else None),
            "explore_incremental_iou_last_quarter": (
                round(iou_last, 4) if iou_last is not None else None),
            "evals": evals,
            "eval_iou_first_quarter": (round(float(np.mean(
                [e["eval_incremental_iou"] for e in evals[:ek]])), 5)
                if evals else None),
            "eval_iou_last_quarter": (round(float(np.mean(
                [e["eval_incremental_iou"] for e in evals[-ek:]])), 5)
                if evals else None),
            "best_eval": best_restored,
            "obs_norm": obs_norm,
            "batch": batch, "start_steps": start_steps,
            "sac_update_batch": sac_batch, "updates_per_batch": n_updates,
        },
    })
    print(json.dumps(out))
    out_path = os.environ.get("PLB_STATERL_OUT")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main(*[(int(a) if a.isdigit() else a) for a in sys.argv[1:]])
