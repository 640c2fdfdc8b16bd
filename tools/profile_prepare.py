"""Stage-by-stage timing of Renderer texture preparation (compile + run)."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from plasticinelab_tpu.config.loader import load_scene
    from plasticinelab_tpu.engine.renderer import Renderer
    from plasticinelab_tpu.engine.shapes import build_particles
    from plasticinelab_tpu.engine.state import initial_state

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = load_scene(os.path.join(
        here, "plasticinelab_tpu", "envs", "specs", "move-v1.json"))
    particles, colors = build_particles(scene.shapes)
    scene = scene.with_n_particles(len(particles))
    state = initial_state(scene, particles)
    r = Renderer(scene)
    r.set_target_density(np.load(os.path.join(
        here, "plasticinelab_tpu", "envs", "assets",
        scene.env.loss.target_path)) / scene.simulator.p_mass)
    x = np.asarray(state.x, np.float32)
    lower = (np.floor(x.min(0) * r.inv_dx) - 6.0) * r.dx
    print("setup done", flush=True)

    t0 = time.perf_counter()
    sdf_flat, col_flat = r._voxelize(
        jnp.asarray(x), jnp.asarray(colors, jnp.int32),
        jnp.asarray(lower, jnp.float32))
    jax.block_until_ready(sdf_flat)
    print(f"voxelize cold: {time.perf_counter()-t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    sdf_flat, col_flat = r._voxelize(
        jnp.asarray(x), jnp.asarray(colors, jnp.int32),
        jnp.asarray(lower, jnp.float32))
    jax.block_until_ready(sdf_flat)
    print(f"voxelize warm: {time.perf_counter()-t0:.3f} s", flush=True)

    t0 = time.perf_counter()
    packed = r._pack_main(sdf_flat, col_flat)
    jax.block_until_ready(packed)
    print(f"pack_main cold: {time.perf_counter()-t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    packed = r._pack_main(sdf_flat, col_flat)
    jax.block_until_ready(packed)
    print(f"pack_main warm: {time.perf_counter()-t0:.3f} s", flush=True)

    t0 = time.perf_counter()
    tp = r._pack_target(r.target_density)
    jax.block_until_ready(tp)
    print(f"pack_target cold: {time.perf_counter()-t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
