"""What the entry points need from their environment: the imports of the
differentiable-physics path, chip_smoke.py's refusal of a CPU-only process,
the remat budget rule and the compile-cache rule."""
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Installed here but not on every machine the simulator runs on; the
# differentiable-physics path must not need any of them.
BLOCKED = ("gymnasium", "gym", "flax", "yaml", "cv2", "matplotlib", "torch",
           "tensorboardX")


def _run(code, env=None, cwd=ROOT, timeout=300):
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=full_env, capture_output=True,
                          text=True, timeout=timeout)


def test_diff_physics_path_imports_without_optional_packages():
    code = f"""
    import importlib.abc, sys
    BLOCKED = {BLOCKED!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, {ROOT!r})
    import numpy as np
    import chip_smoke
    from plasticinelab_tpu.algorithms import solve
    from plasticinelab_tpu.config import loader
    from plasticinelab_tpu.config.spec import (PrimitiveSpec, SceneSpec,
                                               ShapeSpec, SimulatorSpec)
    from plasticinelab_tpu.engine import (local_transfer, losses, mpm,
                                          svd3, transfer)
    from plasticinelab_tpu.engine.sim import PhysicsEnv
    from plasticinelab_tpu.envs import task_scene
    from plasticinelab_tpu.optimizer import optim
    from plasticinelab_tpu.optimizer.solver import Solver, solve_action

    assert solve.get_args(["--algo", "action"]).algo == "action"
    move = task_scene("Move-v1")  # the shipped JSON spec, no YAML
    assert move.simulator.n_grid == 64 and len(move.primitives) == 2

    # construct and run a (tiny) device solve through the public objects
    scene = SceneSpec(
        simulator=SimulatorSpec(quality=0.25, dtype="float32"),
        primitives=(PrimitiveSpec(shape="Sphere", radius=0.06,
                                  init_pos=(0.5, 0.35, 0.5), action_dim=3,
                                  action_scale=(0.01,) * 3),),
        shapes=(ShapeSpec(shape="box", init_pos=(0.5, 0.2, 0.5), width=0.1,
                          n_particles=64),),
    )
    te = PhysicsEnv(scene)
    solver = Solver(te, None, None, n_iters=2, horizon=2)
    solver.solve_device(chunk=2)
    assert np.all(np.isfinite(solver.iter_losses))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("IMPORTS_OK")
    """
    r = _run(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORTS_OK" in r.stdout


def test_chip_smoke_refuses_cpu(tmp_path):
    """No accelerator: exit non-zero at the device phase, no result line.
    Alone in a directory (no package beside it) it fails as well."""
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr

    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       env=dict(os.environ, JAX_PLATFORMS="cpu",
                                PYTHONPATH=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("budget_gb, horizon, batch, want", [
    (1000.0, 1, 1, "none"),
    (60.0, 50, 1, "substep"),
    (60.0, 300, 1, "env_step"),
    (1.0, 50, 64, "both"),
])
def test_resolve_remat_from_explicit_budget(budget_gb, horizon, batch, want):
    """Move-v1 (10k particles, 64^3 grid): the cheapest policy whose stored
    residuals fit the given memory budget."""
    import dataclasses

    from plasticinelab_tpu.engine import mpm
    from plasticinelab_tpu.envs import task_scene

    scene = task_scene("Move-v1").with_n_particles(10_000)
    got = mpm.resolve_remat(scene, horizon, int(budget_gb * 1e9),
                            batch=batch).simulator.remat
    assert got == want
    fixed = scene.replace(simulator=dataclasses.replace(
        scene.simulator, remat="both"))
    assert mpm.resolve_remat(fixed, horizon, 1).simulator.remat == "both"


def test_device_memory_bytes_known_devices():
    import jax

    from plasticinelab_tpu.engine import mpm

    assert mpm.device_memory_bytes(jax.devices("cpu")[0]) > 0

    class Unknown:
        platform = "other"

        def memory_stats(self):
            return None

    with pytest.raises(ValueError):
        mpm.device_memory_bytes(Unknown())


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir_rule(tmp_path, env_dir):
    """$JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jaxcache."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    r = _run(f"""
    import os, sys
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None) if {not env_dir} else None
    sys.path.insert(0, {ROOT!r})
    import jax, plasticinelab_tpu
    print(jax.config.jax_compilation_cache_dir)
    """, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    want = str(tmp_path) if env_dir else os.path.join(ROOT, ".jaxcache")
    assert r.stdout.strip().splitlines()[-1] == want
