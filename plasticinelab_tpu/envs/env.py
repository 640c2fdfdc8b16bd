"""Gym-style environment wrapper over PhysicsEnv.

Behavioral reference: plb/envs/env.py (obs layout :33-41, reward :43-57 via
loss deltas, NaN crash-dump guard :50-56) on the gymnasium API.
"""
from __future__ import annotations

import datetime
import pickle
from typing import Optional

import gymnasium as gym
import numpy as np
from gymnasium.spaces import Box

from ..config.spec import SceneSpec
from ..engine.sim import PhysicsEnv
from . import load_task_scene


class PlasticineEnv(gym.Env):
    metadata = {"render_modes": ["rgb_array", "human", "plt"]}

    def __init__(self, cfg_path: str, version: int = 1, nn: bool = False,
                 scene: Optional[SceneSpec] = None, obs_mode: str = "state",
                 image_obs_res: int = 64, image_obs_spp: int = 2):
        """obs_mode: "state" (reference layout, env.py:33-41) or "rgb"
        (rendered image_obs_res^2 uint8 frames — BASELINE configs[3]'s
        visual-observation benchmark; no reference counterpart)."""
        assert obs_mode in ("state", "rgb"), obs_mode
        self.cfg_path = cfg_path
        self.obs_mode = obs_mode
        self._image_obs_res = image_obs_res
        self._image_obs_spp = image_obs_spp
        if scene is None:
            scene = load_task_scene(cfg_path, version)
        self.taichi_env = PhysicsEnv(scene, nn=nn)
        self.taichi_env.initialize()
        self.cfg = self.taichi_env.scene.env
        self.taichi_env.set_copy(True)
        self._init_state = self.taichi_env.get_state()
        self._n_observed_particles = self.cfg.n_observed_particles
        self._max_episode_steps = 50

        obs, _ = self.reset()
        if obs_mode == "rgb":
            self.observation_space = Box(0, 255, obs.shape, dtype=np.uint8)
        else:
            self.observation_space = Box(-np.inf, np.inf, obs.shape)
        self.action_space = Box(-1.0, 1.0, (self.taichi_env.scene.action_dim,))

    # ------------------------------------------------------------------
    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self.taichi_env.set_state(**self._init_state)
        self._recorded_actions = []
        return self._get_obs(), {}

    def _get_obs(self):
        if self.obs_mode == "rgb":
            return self.taichi_env.render_obs(
                res=self._image_obs_res, spp=self._image_obs_spp)
        return self.taichi_env.get_obs()

    def step(self, action):
        self.taichi_env.step(action)
        loss_info = self.taichi_env.compute_loss()

        self._recorded_actions.append(action)
        obs = self._get_obs()
        r = loss_info["reward"]
        obs_nan = (False if obs.dtype == np.uint8 else np.isnan(obs).any())
        if obs_nan or np.isnan(r):
            if np.isnan(r):
                print("nan in r")
            with open(
                f"{self.cfg_path}_nan_action_{str(datetime.datetime.now())}", "wb"
            ) as f:
                pickle.dump(self._recorded_actions, f)
            raise Exception("NaN..")
        return obs, r, False, False, loss_info

    def render(self, mode="rgb_array"):
        return self.taichi_env.render(mode)

    def seed(self, seed=None):  # legacy-gym compatibility
        np.random.seed(seed)
