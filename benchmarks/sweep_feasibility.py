"""BASELINE config-5 feasibility: 256 envs x 25k particles batched sweep.

Two modes:
  - virtual mesh (default under JAX_PLATFORMS=cpu +
    xla_force_host_platform_device_count=8): compiles and executes ONE
    batched rollout-gradient step for 256 envs sharded over 8 devices at
    25k particles — proving the sharded program and its memory plan.
  - real chip: binary-searches the largest per-chip batch at 25k particles
    and reports measured env-substeps/s and the HBM budget.

Prints one JSON line per result.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build(n_particles=25000):
    from plasticinelab_tpu.config.spec import (
        EnvSpec, LossSpec, PrimitiveSpec, SceneSpec, SimulatorSpec,
    )
    from plasticinelab_tpu.engine import losses as L
    from plasticinelab_tpu.engine.state import default_materials, initial_state

    sim = SimulatorSpec(quality=1.0, n_particles=n_particles,
                        dtype="float32",
                        remat=os.environ.get("SWEEP_REMAT", "substep"))
    prim = PrimitiveSpec(shape="Sphere", radius=0.08,
                         init_pos=(0.4, 0.5, 0.5), friction=0.9,
                         action_dim=3, action_scale=(0.01,) * 3)
    scene = SceneSpec(simulator=sim, primitives=(prim,),
                      env=EnvSpec(loss=LossSpec()))
    rng = np.random.default_rng(0)
    particles = rng.random((n_particles, 3)) * 0.25 + 0.4
    mats = default_materials(scene)
    state = initial_state(scene, particles)
    G = sim.n_grid
    target = np.zeros((G, G, G))
    target[24:40, 10:26, 24:40] = sim.p_mass * 4
    ls = L.make_loss_state(scene, target)
    return scene, mats, state, ls


def run_one(scene, mats, state, ls, mesh, B, T):
    import jax
    import jax.numpy as jnp

    from plasticinelab_tpu.parallel.mesh import (
        batch_states, build_batched_rollout_grad,
    )

    step = build_batched_rollout_grad(scene, mats, ls, mesh)
    states = batch_states(state, B, jitter=1e-3)
    actions = jnp.zeros((B, T, scene.action_dim), jnp.float32)
    loss, grad = step(states, actions, jnp.float32(666.0))
    jax.block_until_ready(grad)
    assert np.isfinite(float(loss))
    return step, states, actions


def main():
    import time

    import jax

    if os.environ.get("SWEEP_PLATFORM") == "cpu":
        # config.update works before first backend use
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from plasticinelab_tpu.parallel.mesh import make_mesh

    backend = jax.default_backend()
    scene, mats, state, ls = build()

    if backend == "cpu":
        # virtual-mesh memory/compile feasibility for the full 256-env
        # sweep. One vmapped SUBSTEP's value_and_grad has the same peak
        # working set as the full rollout (per-env-step remat keeps only
        # one substep's activations live), at ~1000x fewer host FLOPs.
        from jax.sharding import NamedSharding, PartitionSpec as P

        from plasticinelab_tpu.engine import mpm
        from plasticinelab_tpu.parallel.mesh import batch_states

        mesh = make_mesh()
        B = int(os.environ.get("SWEEP_B", "256"))
        states = batch_states(state, B, jitter=1e-3)
        ctrl = mpm.make_controls(scene, jnp.zeros((scene.action_dim,),
                                                  jnp.float32), jnp.float32)

        def one_loss(st):
            out = mpm.substep(scene, mats, st, ctrl, jnp.float32(666.0))
            return jnp.sum(out.x ** 2) + jnp.sum(out.v ** 2)

        def batched(sts):
            return jnp.mean(jax.vmap(one_loss)(sts))

        shard = NamedSharding(mesh, P("env"))
        step = jax.jit(jax.value_and_grad(batched),
                       in_shardings=(shard,), out_shardings=(None, shard))
        loss, grad = step(states)
        jax.block_until_ready(grad.x)
        assert np.isfinite(float(loss))
        assert np.all(np.isfinite(np.asarray(grad.x)))
        print(json.dumps({
            "metric": "sweep_256x25k_dryrun",
            "value": 1.0,
            "unit": f"ok (B={B} x 25k substep grad, "
                    f"{len(jax.devices())} virtual devices)",
            "vs_baseline": None,
            "extra": {"n_particles": 25000, "devices": len(jax.devices()),
                      "loss": float(loss)},
        }))
        return

    # accelerator: find the largest batch that fits, then measure. Each
    # halving retry costs a full recompile, so start conservatively via
    # SWEEP_B.
    mesh = make_mesh()
    T = int(os.environ.get("SWEEP_T", "2"))
    B = int(os.environ.get("SWEEP_B", "16"))
    best = None
    while B >= 1:
        try:
            step, states, actions = run_one(scene, mats, state, ls, mesh,
                                            B, T)
            best = (B, step, states, actions)
            break
        except Exception as e:  # OOM -> halve
            print(f"# B={B} failed: {str(e)[:120]}", file=sys.stderr)
            B //= 2
    if best is None:
        raise SystemExit("no batch size fits")
    B, step, states, actions = best
    softness = jnp.float32(666.0)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, grad = step(states, actions, softness)
        jax.block_until_ready(grad)
        times.append(time.perf_counter() - t0)
    bestt = min(times)
    stats = jax.devices()[0].memory_stats() or {}
    print(json.dumps({
        "metric": "sweep_max_batch_25k_env_substeps_per_sec",
        "value": round(B * T * scene.simulator.substeps / bestt, 1),
        "unit": f"env-substeps/s fwd+bwd (B={B}, 25k particles, 1 chip)",
        "vs_baseline": None,
        "extra": {
            "batch": B, "horizon": T,
            "wallclock_s": round(bestt, 3),
            "hbm_bytes_in_use": stats.get("bytes_in_use"),
            "hbm_peak_bytes": stats.get("peak_bytes_in_use"),
        },
    }))


if __name__ == "__main__":
    main()
