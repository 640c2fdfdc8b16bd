"""Headline benchmark: MPM substeps/sec fwd+bwd on Move-v1 (64^3 grid, ~10k
particles, one GPU). Refuses to run without a GPU.

Measures the steady-state wallclock of the full 50-env-step trajectory
gradient (950 substeps forward + checkpointed backward) — the reference's
core solver iteration (plb/optimizer/solver.py:31-44 under ti.Tape).
vs_baseline is measured against the BASELINE.json north-star target of the
whole gradient in <1s, i.e. 950 substeps/s fwd+bwd.

Prints exactly one JSON line.
"""
import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform}")

    from plasticinelab_tpu.config.loader import load_scene
    from plasticinelab_tpu.engine import losses as losses_mod
    from plasticinelab_tpu.engine import mpm
    from plasticinelab_tpu.engine.shapes import build_particles
    from plasticinelab_tpu.engine.state import default_materials, initial_state

    spec_path = os.path.join(
        os.path.dirname(__file__), "plasticinelab_tpu", "envs", "specs",
        "move-v1.json",
    )
    scene = load_scene(spec_path)
    remat = os.environ.get("BENCH_REMAT")
    if remat:
        import dataclasses

        scene = dataclasses.replace(
            scene, simulator=dataclasses.replace(scene.simulator,
                                                 remat=remat))
    particles, _ = build_particles(scene.shapes)
    scene = scene.with_n_particles(len(particles))
    mats = default_materials(scene)
    state = initial_state(scene, particles)

    asset = os.path.join(
        os.path.dirname(__file__), "plasticinelab_tpu", "envs", "assets",
        scene.env.loss.target_path,
    )
    loss_state = losses_mod.make_loss_state(scene, np.load(asset))

    horizon = 50
    substeps = scene.simulator.substeps  # 19

    def rollout_loss(state0, actions, softness):
        rscene = mpm.resolve_remat(scene, int(actions.shape[0]),
                                   mpm.device_memory_bytes(dev))

        def step_fn(carry, action):
            st, gm, off = mpm.env_step_with_grid_m(
                rscene, mats, carry, action, softness)
            info = losses_mod.loss_from_crop(rscene, loss_state, gm, off, st)
            return st, info["loss"]

        if rscene.simulator.remat in ("env_step", "both"):
            step_fn = jax.checkpoint(step_fn)
        _, per_step = jax.lax.scan(step_fn, state0, actions)
        return jnp.sum(per_step)

    vg = jax.jit(jax.value_and_grad(rollout_loss, argnums=1))
    actions = jnp.asarray(
        np.random.default_rng(0).uniform(-1e-4, 1e-4, (horizon, scene.action_dim)),
        dtype=state.x.dtype,
    )
    softness = jnp.asarray(666.0, dtype=state.x.dtype)

    # compile + warmup
    loss, grad = vg(state, actions, softness)
    jax.block_until_ready(grad)
    assert np.isfinite(float(loss)) and np.all(np.isfinite(np.asarray(grad)))

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, g = vg(state, actions, softness)
        jax.block_until_ready(g)
        times.append(time.perf_counter() - t0)
    best = min(times)

    total_substeps = horizon * substeps
    substeps_per_sec = total_substeps / best
    baseline = 950.0  # north-star: 950-substep trajectory gradient in 1 s
    print(
        json.dumps(
            {
                "metric": "mpm_substeps_per_sec_fwd_bwd_move_v1",
                "value": round(substeps_per_sec, 2),
                "unit": "substeps/s (fwd+bwd, 64^3 grid, 10k particles)",
                "vs_baseline": round(substeps_per_sec / baseline, 4),
                "extra": {
                    "trajectory_grad_wallclock_s": round(best, 4),
                    "run_times_s": [round(t, 4) for t in times],
                    "platform": dev.platform,
                    "device": str(dev.device_kind),
                    "device_count": len(jax.devices()),
                    "horizon_env_steps": horizon,
                    "n_particles": scene.simulator.n_particles,
                    "n_grid": scene.simulator.n_grid,
                    "loss": float(loss),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
