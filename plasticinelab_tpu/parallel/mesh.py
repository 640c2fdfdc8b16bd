"""Batched / multi-chip execution: vmapped envs sharded over a device mesh.

The reference has no distributed backend at all (SURVEY.md §2.9: single
ti.init, one env per process). Here batching is a first-class capability:
a SimState with a leading batch axis, vmapped physics, and a 1-D
jax.sharding.Mesh over the batch axis so XLA (GSPMD) partitions the sweep
over the devices. Parameters / goal tensors are replicated; each env's 64^3
grid lives wholly on one device, so no halo exchange is needed — the only
collective is the mean-loss all-reduce XLA inserts for the gradient. The
mesh is 1-D over the batch and assumes no topology.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config.spec import SceneSpec
from ..engine import losses as losses_mod
from ..engine import mpm
from ..engine.state import Materials, SimState

__all__ = ["make_mesh", "batch_states", "build_batched_rollout_grad"]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "env") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def batch_states(state: SimState, batch: int, jitter: float = 0.0,
                 seed: int = 0) -> SimState:
    """Tile one SimState into a leading batch axis (optionally jittering
    particle positions so envs decorrelate)."""
    tiled = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape).copy(), state
    )
    if jitter > 0:
        key = jax.random.PRNGKey(seed)
        noise = jax.random.uniform(
            key, tiled.x.shape, tiled.x.dtype, -jitter, jitter
        )
        tiled = tiled._replace(x=jnp.clip(tiled.x + noise, 0.0, 0.95))
    return tiled


def build_batched_rollout_grad(scene: SceneSpec, mats: Materials,
                               loss_state, mesh: Mesh, axis_name: str = "env",
                               out_mode: str = "force"):
    """Compile d(mean rollout loss)/d(actions) for a batch of envs sharded
    over `mesh`. actions: (B, T, action_dim); states: SimState with leading B.

    The remat policy is resolved from the batch, the horizon and the first
    mesh device's memory (mpm.resolve_remat); per-env-step jax.checkpoint
    bounds memory at ~one env step's activations per step regardless of
    horizon (SURVEY.md §5 long-horizon strategy). Envs are vmapped over the
    dense transfer: under vmap the windowed transfer's dense fallback (a
    lax.cond) would run both arms.

    out_mode: "force" pins out_shardings to (replicated loss, batch-sharded
    grad); "auto" leaves them to XLA's propagation — used by the sharding
    test / dryrun to PROVE the compute partitioned (if the program silently
    replicated, propagation would not land P(axis) on the grad output).
    """
    import dataclasses

    scene = dataclasses.replace(
        scene, simulator=dataclasses.replace(scene.simulator,
                                             transfer="dense"))

    budget = mpm.device_memory_bytes(mesh.devices.flat[0])

    def batched_loss(states, actions, softness):
        # shapes are static at trace time: per-device batch and horizon
        B, T = actions.shape[0], actions.shape[1]
        rscene = mpm.resolve_remat(scene, T, budget,
                                   batch=max(1, B // mesh.devices.size))

        def rollout_loss(state0, actions):
            def step_fn(carry, action):
                st = mpm.env_step(rscene, mats, carry, action, softness)
                info = losses_mod.loss_and_components(rscene, loss_state, st)
                return st, info["loss"]

            if rscene.simulator.remat in ("env_step", "both"):
                step_fn = jax.checkpoint(step_fn)
            _, per_step = jax.lax.scan(step_fn, state0, actions)
            return jnp.sum(per_step)

        return jnp.mean(jax.vmap(rollout_loss)(states, actions))

    vg = jax.value_and_grad(batched_loss, argnums=1)
    shard_b = NamedSharding(mesh, P(axis_name))      # shard leading batch axis
    replicated = NamedSharding(mesh, P())
    kw = ({"out_shardings": (replicated, shard_b)} if out_mode == "force"
          else {})
    return jax.jit(vg, in_shardings=(shard_b, shard_b, replicated), **kw)
