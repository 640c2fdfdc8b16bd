"""Renderer benchmark: full frame (512x512, 50 spp by default) on the chip.

Target: <= 10 s/frame steady-state. Prints one JSON
line with seconds/frame and the per-sample cost.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(spp=int(os.environ.get("BENCH_SPP", "50")),
         target=int(os.environ.get("BENCH_TARGET", "1"))):
    import jax

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

    args = (np.asarray(state.x), colors, np.asarray(state.prim_pos),
            np.asarray(state.prim_rot), np.asarray(state.prim_gap))

    img = r.render_frame(*args, spp=spp, target=target)  # compile + warm
    assert np.isfinite(img).all() and img.max() > 0.05

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        img = r.render_frame(*args, spp=spp, target=target)
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(json.dumps({
        "metric": "render_seconds_per_frame",
        "value": round(best, 3),
        "unit": f"s/frame ({r.image_res[0]}x{r.image_res[1]}, {spp} spp)",
        "vs_baseline": round(10.0 / best, 3),
        "extra": {"per_sample_ms": round(best / spp * 1e3, 1),
                  "spp": spp, "image_res": list(r.image_res),
                  "target_ghost": bool(target)},
    }))


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])
