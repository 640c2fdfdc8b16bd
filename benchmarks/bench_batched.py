"""Batched-env benchmark: vmapped Move-v1 envs on the available device mesh
(BASELINE.json config 5 calls for 256 envs x 25k particles; this measures
what the available devices support — on one device the mesh is 1-D of size
1 and vmap carries the whole batch).

Prints one JSON line per configuration.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(batch=int(os.environ.get("BENCH_BATCH", "32")),
         horizon=int(os.environ.get("BENCH_HORIZON", "10"))):
    import jax
    import jax.numpy as jnp

    from plasticinelab_tpu.config.loader import load_scene
    from plasticinelab_tpu.engine import losses as losses_mod
    from plasticinelab_tpu.engine.shapes import build_particles
    from plasticinelab_tpu.engine.state import default_materials, initial_state
    from plasticinelab_tpu.parallel.mesh import (
        batch_states, build_batched_rollout_grad, make_mesh,
    )

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = load_scene(os.path.join(
        here, "plasticinelab_tpu", "envs", "specs", "move-v1.json"))
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
    asset = os.path.join(here, "plasticinelab_tpu", "envs", "assets",
                         scene.env.loss.target_path)
    loss_state = losses_mod.make_loss_state(scene, np.load(asset))

    mesh = make_mesh()
    step = build_batched_rollout_grad(scene, mats, loss_state, mesh)
    states = batch_states(state, batch, jitter=1e-3)
    actions = jnp.zeros((batch, horizon, scene.action_dim), state.x.dtype)
    softness = jnp.asarray(666.0, state.x.dtype)

    t0 = time.perf_counter()
    loss, grad = step(states, actions, softness)
    jax.block_until_ready(grad)
    compile_s = time.perf_counter() - t0
    assert np.isfinite(float(loss))

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, grad = step(states, actions, softness)
        jax.block_until_ready(grad)
        times.append(time.perf_counter() - t0)
    best = min(times)
    total_env_substeps = batch * horizon * scene.simulator.substeps
    print(json.dumps({
        "metric": "batched_env_substeps_per_sec_fwd_bwd",
        "value": round(total_env_substeps / best, 1),
        "unit": f"env-substeps/s (batch={batch}, fwd+bwd, "
                f"{len(jax.devices())} device(s))",
        "vs_baseline": None,
        "extra": {"batch": batch, "horizon": horizon,
                  "wallclock_s": round(best, 3),
                  "compile_s": round(compile_s, 1),
                  "n_particles": scene.simulator.n_particles,
                  "device": jax.devices()[0].device_kind},
    }))


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])
