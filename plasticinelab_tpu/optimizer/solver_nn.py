"""Neural-policy trajectory optimization: the MLP runs inside the
differentiable rollout.

Behavioral reference: plb/optimizer/solver_nn.py — same skeleton as the
action solver but gradients flow loss -> actions -> MLP weights; lr is scaled
by 0.001 and bounds removed (solver_nn.py:6-7). Here the policy is a jnp MLP
(engine/nn.py) applied inside the jitted scan, so one value_and_grad call per
iteration returns d loss / d params directly.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..engine import losses as losses_mod
from ..engine import mpm
from ..engine.nn import MLPPolicy
from ..engine.sim import PhysicsEnv
from .optim import OPTIMS
from .solver import SolverConfig, Solver


class SolverNN:
    def __init__(self, env: PhysicsEnv, logger=None, cfg: Optional[SolverConfig] = None,
                 **kwargs):
        helper = Solver(env, None, cfg, **kwargs)  # reuse config plumbing
        self.cfg = helper.cfg
        self.cfg.optim.lr *= 0.001
        self.cfg.optim.bounds = (-np.inf, np.inf)
        self.optim_cfg = self.cfg.optim
        self.horizon = self.cfg.horizon
        self.env = env
        self.logger = logger
        self._vg = None

    def _build(self, policy: MLPPolicy):
        env, scene, mats = self.env, self.env.scene, self.env.mats
        loss_state = env.loss_state

        def rollout_loss(state0, params, softness):
            @jax.checkpoint
            def step_fn(carry, _):
                action = policy.act(params, carry)
                st = mpm.env_step(scene, mats, carry, action, softness)
                info = losses_mod.loss_and_components(scene, loss_state, st)
                return st, info["loss"]

            _, per_step = jax.lax.scan(
                step_fn, state0, None, length=self.horizon
            )
            return jnp.sum(per_step)

        self._vg = jax.jit(jax.value_and_grad(rollout_loss, argnums=1))

    def solve(self, callbacks=()):
        env = self.env
        policy: MLPPolicy = env.nn
        assert policy is not None, "nn must be an element of env .."
        if self._vg is None:
            self._build(policy)

        params_tree = getattr(env, "nn_params", None) or policy.init_params(
            dtype=jnp.float32 if env.dtype == np.float32 else jnp.float64
        )
        params = policy.get_params(params_tree)
        optim = OPTIMS[self.optim_cfg.type](params, self.optim_cfg)
        env_state = env.get_state()
        self.total_steps = 0

        def forward(sim_state, flat_params):
            ptree = policy.set_params(flat_params,
                                      jnp.float32 if env.dtype == np.float32 else jnp.float64)
            env.set_state(sim_state, self.cfg.softness, False)
            if self.logger is not None:
                self.logger.reset()
            loss, grad_tree = self._vg(
                env.state, ptree, env.dtype(self.cfg.softness)
            )
            self.total_steps += self.horizon
            if self.logger is not None:
                info = env.compute_loss()
                self.logger.step(None, None, info["reward"], None, True, info)
            return float(loss), policy.get_params(grad_tree)

        best_params, best_loss = None, 1e10
        for it in range(self.cfg.n_iters):
            self.params = params
            loss, grad = forward(env_state["state"], params)
            if loss < best_loss:
                best_loss, best_params = loss, params.copy()
            params = optim.step(grad)
            for callback in callbacks:
                callback(self, optim, loss, grad)

        env.set_state(**env_state)
        env.nn_params = policy.set_params(best_params if best_params is not None else params)
        self.best_loss = best_loss
        return best_params

    def solve_device(self, chunk: int = 10):
        """Device-resident variant of solve(): Adam/Momentum over the flat
        MLP parameter vector inside jitted lax.scan chunks, same structure as
        Solver.solve_device — the host only fetches per-iteration losses at
        chunk boundaries. No bounds clip (reference solver_nn.py:6-7)."""
        env = self.env
        policy: MLPPolicy = env.nn
        assert policy is not None, "nn must be an element of env .."
        cfg, ocfg = self.cfg, self.optim_cfg
        assert ocfg.type in ("Adam", "Momentum"), ocfg.type
        scene, mats = env.scene, env.mats
        loss_state = env.loss_state
        dtype = env.dtype
        jdtype = jnp.float32 if dtype == np.float32 else jnp.float64
        softness = dtype(cfg.softness)
        env_state = env.get_state()
        state0 = env.state

        params_tree = getattr(env, "nn_params", None) or policy.init_params(
            dtype=jdtype)
        params0 = jnp.asarray(policy.get_params(params_tree), jdtype)

        def unflatten(flat):
            # traced twin of policy.set_params (which is host-numpy only)
            params, o = {}, 0
            for i in range(policy.n_layer):
                fo, fi = policy.dims[i + 1], policy.dims[i]
                params[f"W{i}"] = flat[o:o + fo * fi].reshape(fo, fi)
                o += fo * fi
                params[f"b{i}"] = flat[o:o + fo]
                o += fo
            return params

        def rollout_loss(flat_params):
            ptree = unflatten(flat_params)

            @jax.checkpoint
            def step_fn(carry, _):
                action = policy.act(ptree, carry)
                st = mpm.env_step(scene, mats, carry, action, softness)
                info = losses_mod.loss_and_components(scene, loss_state, st)
                return st, info["loss"]

            _, per_step = jax.lax.scan(
                step_fn, state0, None, length=self.horizon)
            return jnp.sum(per_step)

        lr = dtype(ocfg.lr)
        b1, b2, eps = dtype(ocfg.beta_1), dtype(ocfg.beta_2), dtype(ocfg.epsilon)
        mom = dtype(ocfg.momentum)

        def iter_fn(carry, _):
            params, m, v, it, best_loss, best_params = carry
            loss, grad = jax.value_and_grad(rollout_loss)(params)
            better = loss < best_loss
            best_loss = jnp.where(better, loss, best_loss)
            best_params = jnp.where(better, params, best_params)
            if ocfg.type == "Adam":
                m = b1 * m + (1 - b1) * grad
                v = b2 * v + (1 - b2) * grad * grad
                m_cap = m / (1 - b1 ** (it + 1))
                v_cap = v / (1 - b2 ** (it + 1))
                upd = lr * m_cap / (jnp.sqrt(v_cap) + eps)
            else:
                m = m * mom + grad * (1 - mom)
                upd = lr * m
            return (params - upd, m, v, it + 1, best_loss, best_params), loss

        @jax.jit
        def run_chunk(carry):
            return jax.lax.scan(iter_fn, carry, None, length=chunk)

        carry = (params0, jnp.zeros_like(params0), jnp.zeros_like(params0),
                 jnp.zeros((), jdtype), jnp.asarray(1e10, jdtype), params0)
        self.iter_losses = []
        self.chunk_seconds = []
        done = 0
        import time as _time
        while done < cfg.n_iters:
            n = min(chunk, cfg.n_iters - done)
            if n < chunk:
                @jax.jit
                def run_chunk(carry, n=n):
                    return jax.lax.scan(iter_fn, carry, None, length=n)
            t0 = _time.perf_counter()
            carry, losses = run_chunk(carry)
            jax.block_until_ready(losses)
            self.chunk_seconds.append(_time.perf_counter() - t0)
            self.iter_losses.extend(np.asarray(losses, np.float64).tolist())
            done += n
            if self.logger is not None:
                for L in self.iter_losses[-n:]:
                    self.logger.reset()
                    self.logger.step(None, None, -L, None, True, {
                        "loss": L, "sdf_loss": 0.0, "density_loss": 0.0,
                        "contact_loss": 0.0, "incremental_iou": 0.0})

        env.set_state(**env_state)
        self.total_steps = cfg.n_iters * self.horizon
        self.best_loss = float(carry[4])
        best_params = np.asarray(carry[5], np.float64)
        env.nn_params = policy.set_params(best_params)
        return best_params


def solve_nn(taichi_env: PhysicsEnv, path, logger, args, T: int = 50):
    """CLI entry (reference solver_nn.py:73-123)."""
    os.makedirs(path, exist_ok=True)
    if taichi_env.nn is None:
        taichi_env.nn = MLPPolicy(taichi_env.scene)
    taichi_env.initialize()

    solver = SolverNN(
        taichi_env, logger, None,
        n_iters=(args.num_steps + T - 1) // T, softness=args.softness, horizon=T,
        **{"optim.lr": args.lr, "optim.type": args.optim, "init_range": 0.0001},
    )
    if getattr(args, "host_loop", False):
        params = solver.solve()
    else:
        params = solver.solve_device()

    # replay with the best params, dumping frames
    taichi_env.initialize()
    taichi_env.set_copy(True)
    policy = taichi_env.nn
    ptree = policy.set_params(params)
    try:
        import cv2
    except ImportError:
        cv2 = None
    for idx in range(T):
        action = np.asarray(policy.act(ptree, taichi_env.state))
        taichi_env.step(action)
        img = taichi_env.render(mode="rgb_array")
        if cv2 is not None:
            cv2.imwrite(f"{path}/{idx:04d}.png", img[..., ::-1])
        else:
            np.save(f"{path}/{idx:04d}.npy", img)
    return params
