"""Vectorized on-device RL rollouts: B envs stepping in lockstep under jit.

The reference collects RL data by stepping ONE env from host Python
(plb/algorithms/sac/train_sac_gym.py, TD3/main.py) — each env.step is a
taichi launch plus host round trips for obs/reward. Here the whole batch
steps as one compiled program: vmapped physics, in-graph observations and
rewards (same layout/semantics as envs/env.py:33-57), optionally sharded
over a device mesh. One host sync per step for the full batch.
"""
from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config.loader import load_scene
from ..config.spec import SceneSpec
from ..engine import losses as losses_mod
from ..engine import mpm
from ..engine.shapes import build_particles
from ..engine.state import (
    SimState, default_materials, flat_primitive_states, initial_state,
    np_dtype,
)

ASSET_ROOT = os.path.join(os.path.dirname(__file__), "..", "envs")

__all__ = ["VecPlasticineEnv"]


def _obs_in_graph(scene: SceneSpec, state: SimState) -> jnp.ndarray:
    """In-graph observation, same layout as PhysicsEnv.get_obs (reference
    envs/env.py:33-41): strided particle x|v then flat primitive states."""
    n_obs = scene.env.n_observed_particles
    step = scene.simulator.n_particles // n_obs
    x = state.x[::step]
    v = state.v[::step]
    prim = flat_primitive_states(scene, state)
    return jnp.concatenate(
        [jnp.concatenate([x, v], axis=-1).reshape(-1), prim.reshape(-1)]
    )


class VecPlasticineEnv:
    """B independent copies of one task, stepped as a single jitted program.

    API (batch-first, device-resident):
      reset() -> obs (B, obs_dim)
      step(actions (B, act_dim)) -> (obs, reward (B,), done (B,), info)

    Reward semantics are the RL ("is_copy") mode of PhysicsEnv.compute_loss
    (reference env.py:43-57): r_t = start_loss - loss_t, with start_loss
    fixed at reset per env. Episodes are fixed-horizon (50 env steps) like
    the reference's TimeLimit; `done` is returned for buffer bookkeeping.
    """

    def __init__(self, env_name: Optional[str], batch: int, seed: int = 0,
                 jitter: float = 1e-3, mesh: Optional[Mesh] = None,
                 horizon: int = 50, scene: Optional[SceneSpec] = None,
                 target_density: Optional[np.ndarray] = None,
                 particles: Optional[np.ndarray] = None,
                 obs_mode: str = "state", image_obs_res: int = 64,
                 image_obs_spp: int = 2):
        assert obs_mode in ("state", "rgb"), obs_mode
        self.obs_mode = obs_mode
        if scene is None:
            spec = os.path.join(ASSET_ROOT, "specs",
                                f"{env_name.lower()}.json")
            scene = load_scene(spec)
        colors = None
        if particles is None:
            particles, colors = build_particles(scene.shapes)
        elif obs_mode == "rgb":
            colors = np.full((len(particles),), 0x999999, np.int32)
        scene = scene.with_n_particles(len(particles))
        # Batched stepping vmaps the physics; under vmap the windowed
        # transfer's dense fallback would run both arms, so use the dense
        # transfer throughout.
        scene = dataclasses.replace(
            scene, simulator=dataclasses.replace(scene.simulator,
                                                 transfer="dense"))
        self.scene = scene
        self.batch = batch
        self.horizon = horizon
        self.mats = default_materials(scene)
        self.dtype = np_dtype(scene)
        self._softness = jnp.asarray(666.0, self.dtype)

        if target_density is None:
            target_path = scene.env.loss.target_path
            cand = os.path.join(ASSET_ROOT, "assets",
                                os.path.basename(target_path))
            target_density = np.load(
                cand if os.path.exists(cand) else target_path)
        self.loss_state = losses_mod.make_loss_state(scene, target_density)
        # incremental-IoU normalizer: IoU of the goal with itself
        # (reference loss.py:294 target_iou semantics)
        td = self.loss_state.target_density
        self._target_iou = float(losses_mod.iou(td, td))

        base = initial_state(scene, particles)
        key = jax.random.PRNGKey(seed)
        tiled = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (batch,) + a.shape).copy(), base)
        if jitter > 0:
            noise = jax.random.uniform(
                key, tiled.x.shape, tiled.x.dtype, -jitter, jitter)
            tiled = tiled._replace(x=jnp.clip(tiled.x + noise, 0.0, 0.95))
        self._init_states = tiled

        if mesh is None and len(jax.devices()) > 1:
            nd = len(jax.devices())
            while batch % nd:  # largest device count dividing the batch
                nd -= 1
            if nd > 1:
                mesh = Mesh(np.array(jax.devices()[:nd]), ("env",))
        self._shard = (NamedSharding(mesh, P("env")) if mesh is not None
                       else None)
        if self._shard is not None:
            self._init_states = jax.device_put(self._init_states, self._shard)

        mats, loss_state = self.mats, self.loss_state

        obs_render_b = None
        if obs_mode == "rgb":
            # Batched in-graph visual observations (BASELINE configs[3]):
            # every env's 64x64 frame renders inside the stepping program —
            # vmapped voxelize + march + tone map, one launch for the batch.
            from ..engine.renderer import Renderer
            from ..engine.renderer.renderer import obs_scene

            rsc = obs_scene(scene, image_obs_res, image_obs_spp)
            renderer = Renderer(rsc)
            renderer.set_target_density(
                np.asarray(target_density, np.float32)
                / scene.simulator.p_mass)
            obs_fn = renderer.build_obs_fn()
            colors_j = jnp.asarray(colors, jnp.int32)
            vobs = jax.vmap(obs_fn, in_axes=(0, None, 0, 0, 0, 0))

            def obs_render_b(states, key):
                keys = jax.random.split(key, batch)
                img = vobs(states.x, colors_j, states.prim_pos,
                           states.prim_rot, states.prim_gap, keys)
                return (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)

            self.obs_shape = (image_obs_res, image_obs_res, 3)
            self._renderer = renderer

        def one_step(state, action, softness):
            st, gm, off = mpm.env_step_with_grid_m(
                scene, mats, state, action, softness)
            info = losses_mod.loss_from_crop(scene, loss_state, gm, off, st)
            return st, _obs_in_graph(scene, st), info["loss"], info["iou"]

        def one_loss(state):
            info = losses_mod.loss_and_components(scene, loss_state, state)
            iou0 = losses_mod.iou(info["grid_m"], loss_state.target_density)
            return info["loss"], _obs_in_graph(scene, state), iou0

        step_b = jax.vmap(one_step, in_axes=(0, 0, None))
        loss_b = jax.vmap(one_loss)
        if obs_mode == "rgb":
            state_step_b, state_loss_b = step_b, loss_b

            def step_b(states, actions, softness, key):
                key, sub = jax.random.split(key)
                st, _, loss, iou = state_step_b(states, actions, softness)
                return st, obs_render_b(st, sub), loss, iou, key

            def loss_b(states, key):
                key, sub = jax.random.split(key)
                loss, _, iou0 = state_loss_b(states)
                return loss, obs_render_b(states, sub), iou0, key

        if self._shard is not None:
            rep = NamedSharding(mesh, P())
            sh = self._shard
            if obs_mode == "rgb":
                self._step_b = jax.jit(
                    step_b, in_shardings=(sh, sh, rep, rep),
                    out_shardings=(sh, sh, sh, sh, rep))
                self._loss_b = jax.jit(loss_b, in_shardings=(sh, rep),
                                       out_shardings=(sh, sh, sh, rep))
            else:
                self._step_b = jax.jit(
                    step_b, in_shardings=(sh, sh, rep),
                    out_shardings=(sh, sh, sh, sh))
                self._loss_b = jax.jit(loss_b, in_shardings=(sh,),
                                       out_shardings=(sh, sh, sh))
        else:
            self._step_b = jax.jit(step_b)
            self._loss_b = jax.jit(loss_b)
        self._key = jax.random.PRNGKey(seed + 1)

        self.states = self._init_states
        self._start_loss = None
        self._t = 0

        self.action_dim = scene.action_dim
        self.obs_dim = (scene.env.n_observed_particles * 6
                        + sum(7 + (p.shape == "Chopsticks")
                              for p in scene.primitives))

    # ------------------------------------------------------------------
    def reset(self):
        self.states = self._init_states
        if self.obs_mode == "rgb":
            start_loss, obs, init_iou, self._key = self._loss_b(
                self.states, self._key)
        else:
            start_loss, obs, init_iou = self._loss_b(self.states)
        self._start_loss = start_loss
        self._init_iou = init_iou
        self._t = 0
        return obs

    def step(self, actions):
        """actions (B, act_dim) — device array or numpy."""
        actions = jnp.asarray(actions, self.dtype)
        if self.obs_mode == "rgb":
            self.states, obs, loss, iou, self._key = self._step_b(
                self.states, actions, self._softness, self._key)
        else:
            self.states, obs, loss, iou = self._step_b(
                self.states, actions, self._softness)
        reward = self._start_loss - loss
        self._t += 1
        done = jnp.full((self.batch,), self._t >= self.horizon)
        # benchmark headline metric (reference loss.py:293-294)
        inc = jnp.clip((iou - self._init_iou)
                       / (self._target_iou - self._init_iou), 0.0, 1.0)
        return obs, reward, done, {"loss": loss, "iou": iou,
                                   "incremental_iou": inc}
