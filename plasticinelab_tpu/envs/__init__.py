"""Task registry: 10 tasks x 5 variants (reference plb/envs/__init__.py).

make() returns a TimeLimit-wrapped gymnasium PlasticineEnv; make_physics()
returns the bare differentiable PhysicsEnv and needs no gymnasium. Both
apply loss weights at build time (they specialize the jitted loss, so they
must precede compilation — the reference mutates Taichi fields instead,
envs/__init__.py:16-20).
"""
from __future__ import annotations

import dataclasses
import os
import re

from ..config.loader import load_scene
from ..config.spec import SceneSpec

SPEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "specs")

ENV_NAMES = [
    "Move", "Torus", "Rope", "Writer", "Pinch", "Rollingpin", "Chopsticks",
    "Table", "TripleMove", "Assembly",
]

ENVS = [f"{name}-v{v}" for name in ENV_NAMES for v in range(1, 6)]


def _parse(env_name: str):
    m = re.fullmatch(r"([A-Za-z]+)-v(\d+)", env_name)
    if not m or m.group(1) not in ENV_NAMES:
        raise ValueError(f"unknown env {env_name!r}; registered: {ENVS}")
    return m.group(1).lower(), int(m.group(2))


def load_task_scene(cfg_path: str, version: int) -> SceneSpec:
    """Resolve a task spec: resolved JSON in specs/ first, else a
    reference-schema YAML path with VARIANTS."""
    base = os.path.splitext(os.path.basename(cfg_path))[0]
    cand = os.path.join(SPEC_DIR, f"{base}-v{version}.json")
    if os.path.exists(cand):
        return load_scene(cand)
    return load_scene(cfg_path, version)


def task_scene(env_name: str, sdf_loss: float = 10, density_loss: float = 10,
               contact_loss: float = 1,
               soft_contact_loss: bool = False) -> SceneSpec:
    """The registered task's SceneSpec with the given loss weights."""
    task, version = _parse(env_name)
    scene = load_task_scene(f"{task}.yml", version)
    loss = dataclasses.replace(
        scene.env.loss,
        weight_sdf=sdf_loss, weight_density=density_loss,
        weight_contact=contact_loss, soft_contact=soft_contact_loss,
    )
    return scene.replace(env=dataclasses.replace(scene.env, loss=loss))


def make_physics(env_name: str, nn: bool = False, **loss_weights):
    """The task's PhysicsEnv (the reference's TaichiEnv) in copy mode, as
    the reference env holds it — the differentiable-physics entry point."""
    from ..engine.sim import PhysicsEnv

    te = PhysicsEnv(task_scene(env_name, **loss_weights), nn=nn)
    te.set_copy(True)
    return te


def make(env_name: str, nn: bool = False, sdf_loss: float = 10,
         density_loss: float = 10, contact_loss: float = 1,
         soft_contact_loss: bool = False, max_episode_steps: int = 50,
         obs_mode: str = "state", image_obs_res: int = 64,
         image_obs_spp: int = 2):
    from gymnasium.wrappers import TimeLimit as _TimeLimit

    from .env import PlasticineEnv

    class TimeLimit(_TimeLimit):
        """Forwards render(mode=...) like the classic gym API — the reference
        code calls env.render(mode='rgb_array') through wrappers
        (plb/optimizer/solver.py:99)."""

        def render(self, *args, **kwargs):
            return self.env.render(*args, **kwargs)

        def seed(self, seed=None):
            return self.env.seed(seed)

    task, version = _parse(env_name)
    scene = task_scene(env_name, sdf_loss, density_loss, contact_loss,
                       soft_contact_loss)
    env = PlasticineEnv(f"{task}.yml", version, nn=nn, scene=scene,
                        obs_mode=obs_mode, image_obs_res=image_obs_res,
                        image_obs_spp=image_obs_spp)
    wrapped = TimeLimit(env, max_episode_steps=max_episode_steps)
    wrapped._max_episode_steps = max_episode_steps
    return wrapped


def register_gymnasium():
    """Optionally register all tasks with gymnasium's global registry."""
    import gymnasium

    for name in ENV_NAMES:
        for v in range(1, 6):
            gymnasium.register(
                id=f"{name}-v{v}",
                entry_point="plasticinelab_tpu.envs.env:PlasticineEnv",
                kwargs={"cfg_path": f"{name.lower()}.yml", "version": v},
                max_episode_steps=50,
            )
