"""Differentiable 3D MLS-MPM substep with von Mises plasticity — pure jnp.

Behavioral reference: plb/engine/mpm_simulator.py (p2g 157-184, grid_op
189-221, g2p 223-243, von Mises 124-141, substep 245-257). The reference's
hand-written recompute-then-grad backward (substep_grad, 260-278) is replaced
by jax.checkpoint over the per-env-step substep scan, which recomputes the
same intermediates.

Design:
- Particle<->grid transfers use the separable Khatri-Rao matmul formulation
  on a cropped grid (engine/transfer.py, engine/local_transfer.py) instead
  of the reference's atomic scatter/gather: deterministic and
  differentiable, with matmul VJPs.
- All particle ops are elementwise over the particle batch; the only
  data-dependent control flow is the windowed transfer's dense fallback
  (`lax.cond` in `substep`).
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp

# Physics needs full f32 multiply-accumulate in the small per-particle 3x3
# products: HIGHEST keeps XLA from running them in TF32 on the GPU.
from functools import partial as _partial
_einsum = _partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

from ..config.spec import SceneSpec
from . import local_transfer
from . import primitives as prim
from . import transfer as transfer_mod
from .state import Controls, Materials, SimState
from .svd3 import svd3
from .transfer import (
    axis_weights, crop_offset, crop_size, g2p_dense, grid_m_dense,
    kr_factors, p2g_dense,
)

__all__ = [
    "substep", "env_step", "compute_grid_m", "make_controls",
    "von_mises_project", "stress_affine", "grid_op", "resolve_remat",
    "device_memory_bytes",
]


def _det3(m):
    return jnp.sum(jnp.cross(m[..., 0, :], m[..., 1, :]) * m[..., 2, :], axis=-1)


def von_mises_project(F_tmp, U, sig, V, yield_stress, mu):
    """von Mises return mapping (reference compute_von_mises :124-141)."""
    dtype = F_tmp.dtype
    sig_c = jnp.maximum(sig, 0.05)  # NaN guard (reference :128)
    eps = jnp.log(sig_c)
    eps_hat = eps - jnp.mean(eps, axis=-1, keepdims=True)
    eps_hat_norm = jnp.sqrt(jnp.sum(eps_hat * eps_hat, axis=-1) + 1e-8)
    delta_gamma = eps_hat_norm - yield_stress / (2.0 * mu)
    yields = delta_gamma > 0

    eps_proj = eps - (delta_gamma / eps_hat_norm)[..., None] * eps_hat
    sig_proj = jnp.exp(eps_proj)
    F_proj = _einsum("...ij,...j,...kj->...ik", U, sig_proj, V)
    return jnp.where(yields[..., None, None], F_proj, F_tmp).astype(dtype)


def stress_affine(scene: SceneSpec, mats: Materials, C, F):
    """F-update + plasticity + Cauchy-like stress + APIC affine matrix
    (reference p2g :158-174). Returns (new_F, affine)."""
    sim = scene.simulator
    dtype = F.dtype
    F_tmp = _einsum("nij,njk->nik", jnp.eye(3, dtype=dtype) + sim.dt * C, F)
    U, sig, V = svd3(F_tmp)
    new_F = von_mises_project(F_tmp, U, sig, V, mats.yield_stress, mats.mu)

    J = _det3(new_F)
    r = _einsum("nij,nkj->nik", U, V)
    mu = jnp.reshape(mats.mu, (-1, 1, 1)) if mats.mu.ndim else mats.mu
    lam = jnp.reshape(mats.lam, (-1, 1, 1)) if mats.lam.ndim else mats.lam
    stress = 2.0 * mu * _einsum("nij,nkj->nik", new_F - r, new_F) + jnp.eye(
        3, dtype=dtype
    ) * (lam * (J * (J - 1.0))[..., None, None])
    stress = (-sim.dt * sim.p_vol * 4 * sim.inv_dx * sim.inv_dx) * stress
    affine = stress + sim.p_mass * C
    return new_F, affine


def grid_op(scene: SceneSpec, grid_v_in, grid_m, pose_f, pose_f1, softness,
            D: int, off):
    """Grid momentum update on the D^3 crop: mass-normalize, gravity,
    primitive collisions, wall/ground boundaries (reference grid_op :189-221).
    `off` (3,) int32 is the crop's global cell offset."""
    sim = scene.simulator
    dtype = grid_v_in.dtype
    G = sim.n_grid
    dt = sim.dt

    mask = grid_m > 1e-12
    m_safe = jnp.where(mask, grid_m, jnp.ones_like(grid_m))
    v = grid_v_in / m_safe[:, None]
    gravity = jnp.asarray(sim.gravity, dtype=dtype)
    v = v + dt * gravity * 30.0

    ii = jax.lax.broadcasted_iota(jnp.int32, (D, D, D), 0).reshape(-1)
    jj = jax.lax.broadcasted_iota(jnp.int32, (D, D, D), 1).reshape(-1)
    kk = jax.lax.broadcasted_iota(jnp.int32, (D, D, D), 2).reshape(-1)
    coords = jnp.stack([ii, jj, kk], axis=-1) + off[None, :]  # global cells
    grid_pos = coords.astype(dtype) * sim.dx

    pos_f, rot_f, gap_f = pose_f
    pos_f1, rot_f1, _ = pose_f1
    for i, p in enumerate(scene.primitives):
        v = prim.collide(
            p, pos_f[i], rot_f[i], gap_f[i], pos_f1[i], rot_f1[i],
            jnp.asarray(p.friction, dtype=dtype), softness, grid_pos, v, dt,
        )

    bound = 3
    coord_f = coords.astype(dtype)
    for d in range(3):
        cd = coords[:, d]
        low = jnp.logical_and(cd < bound, v[:, d] < 0)
        if d != 1 or sim.ground_friction == 0:
            v = v.at[:, d].set(jnp.where(low, jnp.zeros_like(v[:, d]), v[:, d]))
        elif sim.ground_friction < 10:
            # Coulomb-like ground friction (reference :206-215, including its
            # 1e-30 tie-breaker terms, which are denormal-representable in f32)
            lin = v[:, 1] + 1e-30
            vit = v - lin[:, None] * jnp.asarray([0.0, 1.0, 0.0], dtype=dtype) - coord_f * 1e-30
            lit = jnp.sqrt(jnp.sum(vit * vit, axis=-1) + 1e-8)
            scale = jnp.maximum(1.0 + sim.ground_friction * lin / lit, 0.0)
            fric_v = scale[:, None] * (vit + coord_f * 1e-30)
            fric_v = fric_v.at[:, 1].set(jnp.zeros_like(lin))
            v = jnp.where(low[:, None], fric_v, v)
        else:
            v = jnp.where(low[:, None], jnp.zeros_like(v), v)
        high = jnp.logical_and(cd > G - bound, v[:, d] > 0)
        v = v.at[:, d].set(jnp.where(high, jnp.zeros_like(v[:, d]), v[:, d]))

    if sim.grid_v_clamp > 0:
        vmax = sim.grid_v_clamp * sim.dx / sim.dt
        v = jnp.clip(v, -vmax, vmax)

    # cells with no mass keep zero velocity (reference only writes masked cells)
    return jnp.where(mask[:, None], v, jnp.zeros_like(v))


def grid_op_core(scene: SceneSpec, g4c, coords, pose_f, pose_f1, softness):
    """Shape-generic channel-major grid_op core (reference grid_op :189-221).

    g4c: 4-tuple of momentum x/y/z + mass arrays of ANY common shape;
    coords: (ci, cj, ck) int32 GLOBAL cell index arrays of the same shape;
    pose_f/pose_f1: (pos, rot, gap) where pos/rot/gap are indexable per
    primitive (arrays or tuples of scalars). Returns the 3 velocity
    components as a list."""
    from . import primitives_cm as pcm

    sim = scene.simulator
    dtype = g4c[3].dtype
    G = sim.n_grid
    dt = sim.dt

    m = g4c[3]
    mask = m > 1e-12
    inv_m = 1.0 / jnp.where(mask, m, jnp.ones_like(m))
    gravity = sim.gravity
    v = [g4c[d] * inv_m + dt * gravity[d] * 30.0 for d in range(3)]

    gp = tuple(c.astype(dtype) * sim.dx for c in coords)

    pos_f, rot_f, gap_f = pose_f
    pos_f1, rot_f1, _ = pose_f1
    vt = tuple(v)
    for i, p in enumerate(scene.primitives):
        vt = pcm.collide_cm(
            p, pos_f[i], rot_f[i], gap_f[i], pos_f1[i], rot_f1[i],
            jnp.asarray(p.friction, dtype=dtype), softness, gp, vt, dt,
        )
    v = list(vt)

    bound = 3
    coord_f = tuple(c.astype(dtype) for c in coords)
    zero = jnp.zeros_like(v[0])
    for d in range(3):
        cd = coords[d]
        low = jnp.logical_and(cd < bound, v[d] < 0)
        if d != 1 or sim.ground_friction == 0:
            v[d] = jnp.where(low, zero, v[d])
        elif sim.ground_friction < 10:
            # Coulomb-like ground friction with the reference's 1e-30
            # tie-breakers (grid_op :206-215)
            lin = v[1] + 1e-30
            vit = [v[c] - coord_f[c] * 1e-30 for c in range(3)]
            vit[1] = vit[1] - lin
            lit = jnp.sqrt(vit[0] ** 2 + vit[1] ** 2 + vit[2] ** 2 + 1e-8)
            scale = jnp.maximum(1.0 + sim.ground_friction * lin / lit, 0.0)
            fric = [scale * (vit[c] + coord_f[c] * 1e-30) for c in range(3)]
            fric[1] = zero
            v = [jnp.where(low, fric[c], v[c]) for c in range(3)]
        else:
            v = [jnp.where(low, zero, vc) for vc in v]
        high = jnp.logical_and(cd > G - bound, v[d] > 0)
        v[d] = jnp.where(high, zero, v[d])

    if sim.grid_v_clamp > 0:
        vmax = sim.grid_v_clamp * sim.dx / sim.dt
        v = [jnp.clip(vc, -vmax, vmax) for vc in v]

    return [jnp.where(mask, vc, zero) for vc in v]


def grid_op_cm(scene: SceneSpec, grid4, pose_f, pose_f1, softness, D: int,
               off):
    """Channel-major grid_op: grid4 (4, M) rows = momentum x/y/z + mass on
    the D^3 crop -> (3, M) velocities. Same math as grid_op (reference
    grid_op :189-221) re-expressed on per-component (M,) arrays instead of
    (M, 3) vectors (tests/test_primitives_cm.py holds the two equal)."""
    ii = jax.lax.broadcasted_iota(jnp.int32, (D, D, D), 0).reshape(-1) + off[0]
    jj = jax.lax.broadcasted_iota(jnp.int32, (D, D, D), 1).reshape(-1) + off[1]
    kk = jax.lax.broadcasted_iota(jnp.int32, (D, D, D), 2).reshape(-1) + off[2]
    v = grid_op_core(
        scene, (grid4[0], grid4[1], grid4[2], grid4[3]), (ii, jj, kk),
        pose_f, pose_f1, softness,
    )
    return jnp.stack(v)


def substep(scene: SceneSpec, mats: Materials, state: SimState, ctrl: Controls,
            softness) -> SimState:
    """One MLS-MPM substep (reference substep :245-257): p2g, primitive FK,
    grid ops with collision, g2p + advection."""
    sim = scene.simulator
    D = crop_size(scene)
    use_local = local_transfer.enabled(scene, D)

    new_F, affine = stress_affine(scene, mats, state.C, state.F)
    if use_local:
        # Locality-chunked transfer with a dense fallback: the `ok` flag is
        # true iff every particle chunk fits its static window (see
        # local_transfer.py); when material spreads past the windows the
        # substep falls back to the dense crop transfer — same math, more
        # FLOPs — so the fast path is never a correctness assumption.
        plan = local_transfer.plan_for(scene, D)
        off = crop_offset(scene, state.x, D)
        ctx = local_transfer.chunk_offsets(scene, plan, state.x, off, D)

        def _p2g_loc(x, v, aff):
            return local_transfer.p2g_local(
                scene, plan, x, v, aff, ctx, off, D)

        def _p2g_den(x, v, aff):
            aw = axis_weights(scene, x, D, off=off)
            return p2g_dense(scene, aw, v, aff, D)

        grid_v_in, grid_m = jax.lax.cond(
            ctx.ok, _p2g_loc, _p2g_den, state.x, state.v, affine
        )
    else:
        aw = axis_weights(scene, state.x, D)
        # share the KR factors between p2g and g2p only when they fit —
        # above the chunk threshold the transfers stream particle blocks
        kr = (kr_factors(aw, D)
              if state.x.shape[0] <= transfer_mod._DENSE_CHUNK else None)
        off = aw.off
        grid_v_in, grid_m = p2g_dense(scene, aw, state.v, affine, D, kr)

    # forward kinematics: pose at f -> f+1 (runs between p2g and grid_op)
    pose_f = (state.prim_pos, state.prim_rot, state.prim_gap)
    pose_f1 = _fk_step(scene, pose_f, ctrl)
    prim_pos1, prim_rot1, prim_gap1 = pose_f1

    grid_v_out = grid_op(
        scene, grid_v_in, grid_m, pose_f, pose_f1, softness, D, off,
    )
    if use_local:
        def _g2p_loc(x, gv):
            return local_transfer.g2p_local(scene, plan, x, gv, ctx, off, D)

        def _g2p_den(x, gv):
            aw = axis_weights(scene, x, D, off=off)
            return g2p_dense(scene, aw, gv, D)

        new_v, new_C = jax.lax.cond(
            ctx.ok, _g2p_loc, _g2p_den, state.x, grid_v_out
        )
    else:
        new_v, new_C = g2p_dense(scene, aw, grid_v_out, D, kr)
    new_x = jnp.maximum(
        jnp.minimum(state.x + sim.dt * new_v, 1.0 - 3 * sim.dx), 0.0
    )
    return SimState(
        x=new_x, v=new_v, C=new_C, F=new_F,
        prim_pos=prim_pos1, prim_rot=prim_rot1, prim_gap=prim_gap1,
    )


# remat="auto" resolution constants, f32, from compiled.memory_analysis()
# temp bytes of the Move-v1 rollout gradient at 600 and 2400 particles
# (slope and intercept of the per-substep growth, XLA CPU backend): with NO
# checkpoint each substep stores ~162 KB per particle (the Khatri-Rao
# factors of both arms of the windowed transfer's dense-fallback cond
# dominate) plus ~1.5 KB per crop cell; "substep" remat stores ~1 KB per
# particle-substep.
_REMAT_RESID_BYTES = 162_000
_REMAT_GRID_BYTES = 1_520
_REMAT_CARRY_BYTES = 1_100
# Shares of the device's memory limit that stored residuals / carries may
# take; the rest is headroom for one substep's live intermediates.
_REMAT_RESID_SHARE = 0.6
_REMAT_CARRY_SHARE = 0.8


def device_memory_bytes(device=None) -> int:
    """Memory the allocator may hand out on `device` (default: the first
    device): `memory_stats()["bytes_limit"]` on an accelerator, physical RAM
    on the CPU backend, which reports no stats. Any other device without a
    limit is an error — remat budgets are never guessed."""
    device = device or jax.devices()[0]
    stats = device.memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if device.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise ValueError(f"device {device} reports no memory limit")


def resolve_remat(scene: SceneSpec, horizon: int, budget_bytes: int,
                  batch: int = 1) -> SceneSpec:
    """Resolve SimulatorSpec.remat == "auto" to a concrete policy for a
    rollout of `horizon` env steps over `batch` envs on a device with
    `budget_bytes` of memory (device_memory_bytes), cheapest-first:

    - "none":     store all substep residuals (no recompute)
    - "substep":  store per-substep carries, recompute substep internals
    - "env_step": store per-env-step carries, recompute each env step once
                  (residuals live for one env step x batch at a time)
    - "both":     both checkpoint levels (third forward pass; last resort)

    Called at trace time (horizon/batch are Python ints); rollouts that
    already carry a concrete policy pass through unchanged."""
    sim = scene.simulator
    if sim.remat != "auto":
        return scene
    resid_budget = _REMAT_RESID_SHARE * budget_bytes
    carry_budget = _REMAT_CARRY_SHARE * budget_bytes
    S = horizon * sim.substeps * batch
    n = sim.n_particles
    per_substep = (n * _REMAT_RESID_BYTES
                   + crop_size(scene) ** 3 * _REMAT_GRID_BYTES)
    if S * per_substep < resid_budget:
        policy = "none"
    elif S * n * _REMAT_CARRY_BYTES < carry_budget:
        policy = "substep"
    elif batch * sim.substeps * per_substep < resid_budget:
        policy = "env_step"
    else:
        policy = "both"
    return dataclasses.replace(
        scene, simulator=dataclasses.replace(sim, remat=policy))


def _fk_step(scene: SceneSpec, poses, ctrl):
    """Forward kinematics for all primitives: poses -> poses at f+1."""
    pos_f, rot_f, gap_f = poses
    new_pos, new_rot, new_gap = [], [], []
    for i, p in enumerate(scene.primitives):
        np_, nr_, ng_ = prim.forward_kinematics(
            p, pos_f[i], rot_f[i], gap_f[i], ctrl.v[i], ctrl.w[i],
            ctrl.gap_vel[i],
        )
        new_pos.append(np_)
        new_rot.append(nr_)
        new_gap.append(jnp.reshape(ng_, ()))
    if not scene.primitives:
        return poses
    return (jnp.stack(new_pos), jnp.stack(new_rot), jnp.stack(new_gap))


def make_controls(scene: SceneSpec, action, dtype) -> Controls:
    """Full action vector (action_dim,) -> per-substep Controls, clipped to
    [-1, 1] (reference primitives.py:289-293)."""
    k = len(scene.primitives)
    n_sub = scene.simulator.substeps
    offs = scene.action_dims
    vs, ws, gs = [], [], []
    if action is not None:
        action = jnp.clip(jnp.asarray(action, dtype=dtype).reshape(-1), -1.0, 1.0)
    for i, p in enumerate(scene.primitives):
        if action is None or p.action_dim == 0:
            a = jnp.zeros((max(p.action_dim, 1),), dtype=dtype)
        else:
            a = action[offs[i] : offs[i + 1]]
        v, w, g = prim.action_to_velocity(p, a, n_sub, dtype)
        vs.append(v)
        ws.append(w)
        gs.append(g)
    if k == 0:
        z3 = jnp.zeros((0, 3), dtype=dtype)
        return Controls(v=z3, w=z3, gap_vel=jnp.zeros((0,), dtype=dtype))
    return Controls(v=jnp.stack(vs), w=jnp.stack(ws), gap_vel=jnp.stack(gs))


def env_step(scene: SceneSpec, mats: Materials, state: SimState, action,
             softness) -> SimState:
    """One environment step = `substeps` physics substeps under constant
    manipulator velocities (reference MPMSimulator.step :365-376)."""
    ctrl = make_controls(scene, action, state.x.dtype)
    use_local = local_transfer.enabled(scene, crop_size(scene))

    if use_local:
        # Sort particles by raster cell once per env step so consecutive
        # chunks are spatially tight (local_transfer windows). The state is
        # un-sorted before returning, so particle order — which is semantic
        # for observations (x[::step]) and get_state round-trips — is
        # preserved at env-step boundaries.
        key = local_transfer.sort_keys(scene, state.x)
        (x, v, C, F), order, rank = local_transfer.sort_rows(
            key, (state.x, state.v, state.C, state.F)
        )
        state = state._replace(x=x, v=v, C=C, F=F)

    # Per-substep remat: without it, an env step's backward materializes all
    # `substeps` copies of the transfer intermediates (the Khatri-Rao
    # factors dominate) at once, which forbids batching. With it, peak
    # memory is one substep's intermediates. (remat="none" opts out for
    # unbatched runs — see SimulatorSpec.remat.)
    def body(s, _):
        return substep(scene, mats, s, ctrl, softness), None

    if scene.simulator.remat in ("substep", "both"):
        body = jax.checkpoint(body)

    state, _ = jax.lax.scan(body, state, None, length=scene.simulator.substeps)

    if use_local:
        x, v, C, F = local_transfer.unsort_rows(
            order, rank, (state.x, state.v, state.C, state.F)
        )
        state = state._replace(x=x, v=v, C=C, F=F)
    return state


def env_step_with_grid_m(scene: SceneSpec, mats: Materials, state: SimState,
                         action, softness):
    """env_step + the final state's crop grid-mass in one fused graph:
    (new_state, grid_m_crop (D^3,), off (3,)), the mass from the dense
    transfer. Consumed by losses.loss_from_crop — together they replace the
    loss's full-grid dense mass transfer (reference compute_loss_kernel's
    grid_m refill, loss.py:186-208)."""
    dtype = state.x.dtype
    D = crop_size(scene)
    new_state = env_step(scene, mats, state, action, softness)
    aw = axis_weights(scene, new_state.x, D)
    n = new_state.x.shape[0]
    zeros_v = jnp.zeros((n, 3), dtype)
    zeros_aff = jnp.zeros((n, 3, 3), dtype)
    gm = p2g_dense(scene, aw, zeros_v, zeros_aff, D)[1]
    return new_state, gm, aw.off


def compute_grid_m(scene: SceneSpec, x):
    """Global grid mass field from particle positions (reference
    compute_grid_m_kernel :382-392). Returns (G^3,)."""
    return grid_m_dense(scene, x, crop_size(scene))
