"""Rigid SDF manipulators: analytic SDF/normal, contact response, kinematics.

Behavioral reference: plb/engine/primitive/{primive_base.py, primitives.py}.
Shape polymorphism is resolved at trace time from the static PrimitiveSpec
(the JAX analogue of Taichi's ti.static specialization): every function below
is pure jnp over a single primitive's pose, broadcastable over grid points /
particles, so the per-scene jitted program inlines exactly the shapes it uses.

Conventions carried over from the reference:
- `length` eps is 1e-14 inside shape SDFs/normals (primitives.py:8-10) and
  1e-8 in the contact response (primive_base.py imports utils.length).
- Sphere's sdf/normal are world-frame and ignore rotation (primitives.py:22-28).
- Box normals are central finite differences with d=1e-4 (primitives.py:240-251).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config.spec import PrimitiveSpec
from .quat import inv_trans, qmul, qrot, quat_conj, w2quat

__all__ = [
    "sdf", "normal", "collide", "collider_v", "forward_kinematics",
    "action_to_velocity",
]


def _length(x, eps=1e-14):
    return jnp.sqrt(jnp.sum(x * x, axis=-1) + eps)


def _normalize(x, eps=1e-14):
    return x / _length(x, eps)[..., None]


# --------------------------------------------------------------------------
# local-frame sdf / normal per shape
# --------------------------------------------------------------------------

def _capsule_sdf(spec: PrimitiveSpec, p):
    y = p[..., 1] + spec.h / 2
    y = y - jnp.clip(y, 0.0, spec.h)
    p2 = jnp.stack([p[..., 0], y, p[..., 2]], axis=-1)
    return _length(p2) - spec.r


def _capsule_normal(spec: PrimitiveSpec, p):
    y = p[..., 1] + spec.h / 2
    y = y - jnp.clip(y, 0.0, spec.h)
    p2 = jnp.stack([p[..., 0], y, p[..., 2]], axis=-1)
    return _normalize(p2)


def _chopsticks_parts(spec: PrimitiveSpec, p, gap):
    delta = jnp.stack(
        [gap / 2, jnp.zeros_like(gap), jnp.zeros_like(gap)], axis=-1
    )
    mid = jnp.asarray([0.0, -spec.h / 2, 0.0], dtype=p.dtype)
    pp = p - mid
    return pp - delta, pp + delta


def _cylinder_sdf(spec: PrimitiveSpec, p):
    # NB the reference swaps the usual roles: h is radial extent, r is the
    # half-height (primitives.py:163-167).
    d0 = jnp.abs(_length(jnp.stack([p[..., 0], p[..., 2]], axis=-1))) - spec.h
    d1 = jnp.abs(p[..., 1]) - spec.r
    d0c = jnp.maximum(d0, 0.0)
    d1c = jnp.maximum(d1, 0.0)
    return jnp.minimum(jnp.maximum(d0, d1), 0.0) + jnp.sqrt(
        d0c * d0c + d1c * d1c + 1e-14
    )


def _cylinder_normal(spec: PrimitiveSpec, p):
    xz = jnp.stack([p[..., 0], p[..., 2]], axis=-1)
    l = _length(xz)
    d = jnp.stack([l, jnp.abs(p[..., 1])], axis=-1) - jnp.asarray(
        [spec.h, spec.r], dtype=p.dtype
    )
    f = (d[..., 0] > d[..., 1]).astype(p.dtype)
    inside = (jnp.maximum(d[..., 0], d[..., 1]) <= 0.0).astype(p.dtype)
    n2 = jnp.maximum(d, 0.0) + inside[..., None] * jnp.stack([f, 1.0 - f], axis=-1)
    n2 = _normalize(n2)
    p2 = xz / l[..., None]
    ysign = (p[..., 1] >= 0).astype(p.dtype) * 2.0 - 1.0
    n3 = jnp.stack(
        [p2[..., 0] * n2[..., 0], n2[..., 1] * ysign, p2[..., 1] * n2[..., 0]],
        axis=-1,
    )
    return _normalize(n3)


def _torus_sdf(spec: PrimitiveSpec, p):
    xz = jnp.stack([p[..., 0], p[..., 2]], axis=-1)
    q = jnp.stack([_length(xz) - spec.tx, p[..., 1]], axis=-1)
    return _length(q) - spec.ty


def _torus_normal(spec: PrimitiveSpec, p):
    xz = jnp.stack([p[..., 0], p[..., 2]], axis=-1)
    l = _length(xz)
    q = jnp.stack([l - spec.tx, p[..., 1]], axis=-1)
    n2 = q / _length(q)[..., None]
    x2 = xz / l[..., None]
    n3 = jnp.stack(
        [x2[..., 0] * n2[..., 0], n2[..., 1], x2[..., 1] * n2[..., 0]], axis=-1
    )
    return _normalize(n3)


def _box_sdf(spec: PrimitiveSpec, p):
    size = jnp.asarray(spec.size, dtype=p.dtype)
    q = jnp.abs(p) - size
    out = _length(jnp.maximum(q, 0.0))
    return out + jnp.minimum(jnp.max(q, axis=-1), 0.0)


def _box_normal(spec: PrimitiveSpec, p):
    # central FD with d=1e-4, like the reference (primitives.py:240-251)
    d = 1e-4
    comps = []
    for i in range(3):
        e = jnp.zeros((3,), dtype=p.dtype).at[i].set(d)
        comps.append((_box_sdf(spec, p + e) - _box_sdf(spec, p - e)) * (0.5 / d))
    n = jnp.stack(comps, axis=-1)
    return _normalize(n)


def _local_sdf(spec: PrimitiveSpec, p, gap):
    shape = spec.shape
    if shape in ("Capsule", "RollingPin"):
        return _capsule_sdf(spec, p)
    if shape == "Chopsticks":
        a, b = _chopsticks_parts(spec, p, gap)
        return jnp.minimum(_capsule_sdf(spec, a), _capsule_sdf(spec, b))
    if shape == "Cylinder":
        return _cylinder_sdf(spec, p)
    if shape == "Torus":
        return _torus_sdf(spec, p)
    if shape == "Box":
        return _box_sdf(spec, p)
    raise NotImplementedError(shape)


def _local_normal(spec: PrimitiveSpec, p, gap):
    shape = spec.shape
    if shape in ("Capsule", "RollingPin"):
        return _capsule_normal(spec, p)
    if shape == "Chopsticks":
        a, b = _chopsticks_parts(spec, p, gap)
        m = (_capsule_sdf(spec, a) <= _capsule_sdf(spec, b)).astype(p.dtype)
        return m[..., None] * _capsule_normal(spec, a) + (1.0 - m[..., None]) * _capsule_normal(spec, b)
    if shape == "Cylinder":
        return _cylinder_normal(spec, p)
    if shape == "Torus":
        return _torus_normal(spec, p)
    if shape == "Box":
        return _box_normal(spec, p)
    raise NotImplementedError(shape)


# --------------------------------------------------------------------------
# world-frame interface
# --------------------------------------------------------------------------

def sdf(spec: PrimitiveSpec, pos, rot, gap, p):
    """World-frame signed distance at point(s) p (...,3)."""
    if spec.shape == "Sphere":
        return _length(p - pos) - spec.radius
    local = inv_trans(p, pos, rot)
    return _local_sdf(spec, local, gap)


def bounding_radius(spec: PrimitiveSpec, gap):
    """Radius of a sphere centered at the primitive's world position that
    contains its entire {sdf <= 0} set (conservative; used by the renderer
    to start sphere-trace rays at the bounding-sphere entry instead of the
    camera — a pure optimization, the traced hit is unchanged)."""
    shape = spec.shape
    if shape == "Sphere":
        return jnp.asarray(spec.radius, jnp.float32)
    if shape in ("Capsule", "RollingPin"):
        return jnp.asarray(spec.h / 2 + spec.r, jnp.float32)
    if shape == "Chopsticks":
        # parts span y in [-h, 0] around the handle origin, offset +-gap/2
        return spec.h + spec.r + jnp.abs(gap) / 2
    if shape == "Cylinder":
        return jnp.asarray(np.hypot(spec.h, spec.r), jnp.float32)
    if shape == "Torus":
        return jnp.asarray(spec.tx + spec.ty, jnp.float32)
    if shape == "Box":
        return jnp.asarray(float(np.linalg.norm(spec.size)), jnp.float32)
    raise NotImplementedError(shape)


def normal(spec: PrimitiveSpec, pos, rot, gap, p):
    """World-frame outward normal at point(s) p (...,3)."""
    if spec.shape == "Sphere":
        return _normalize(p - pos)
    local = inv_trans(p, pos, rot)
    return qrot(rot, _local_normal(spec, local, gap))


def collider_v(pos_f, rot_f, pos_f1, rot_f1, p, dt):
    """Rigid-body velocity of the collider surface at point(s) p
    (reference primive_base.py:82-89)."""
    rel = qrot(quat_conj(rot_f), p - pos_f)
    new_pos = qrot(rot_f1, rel) + pos_f1
    return (new_pos - p) / dt


def collide(spec: PrimitiveSpec, pos_f, rot_f, gap_f, pos_f1, rot_f1,
            friction, softness, grid_pos, v_out, dt):
    """Softness-weighted friction contact response on grid velocities
    (reference primive_base.py:91-115). Fully branchless: the update is
    computed everywhere and selected with the reference's condition."""
    dtype = v_out.dtype
    dist = sdf(spec, pos_f, rot_f, gap_f, grid_pos)
    influence = jnp.minimum(jnp.exp(-dist * softness), 1.0)
    cond = jnp.logical_or(
        jnp.logical_and(softness > 0, influence > 0.1), dist <= 0
    )

    D = normal(spec, pos_f, rot_f, gap_f, grid_pos)
    cv = collider_v(pos_f, rot_f, pos_f1, rot_f1, grid_pos, dt)

    input_v = v_out - cv
    normal_component = jnp.sum(input_v * D, axis=-1)
    grid_v_t = input_v - jnp.minimum(normal_component, 0.0)[..., None] * D
    grid_v_t_norm = _length(grid_v_t, 1e-8)  # utils.length eps
    scale = jnp.maximum(0.0, grid_v_t_norm + normal_component * friction)
    grid_v_t_friction = grid_v_t / grid_v_t_norm[..., None] * scale[..., None]
    flag = jnp.logical_and(
        normal_component < 0,
        jnp.sqrt(jnp.sum(grid_v_t * grid_v_t, axis=-1)) > 1e-30,
    ).astype(dtype)[..., None]
    grid_v_t = grid_v_t_friction * flag + grid_v_t * (1.0 - flag)
    new_v = cv + input_v * (1.0 - influence[..., None]) + grid_v_t * influence[..., None]
    return jnp.where(cond[..., None], new_v, v_out)


# --------------------------------------------------------------------------
# kinematics & actions
# --------------------------------------------------------------------------

def forward_kinematics(spec: PrimitiveSpec, pos, rot, gap, v, w, gap_vel):
    """One-substep pose integration -> (pos', rot', gap').

    Base: primive_base.py:117-121; RollingPin: primitives.py:66-80;
    Chopsticks: primitives.py:94-99.
    """
    dtype = pos.dtype
    lb = jnp.asarray(spec.lower_bound, dtype=dtype)
    ub = jnp.asarray(spec.upper_bound, dtype=dtype)

    if spec.shape == "RollingPin":
        dw, dth, dy = v[..., 0], v[..., 1], v[..., 2]
        y_dir = qrot(rot, jnp.asarray([0.0, -1.0, 0.0], dtype=dtype))
        x_dir = jnp.cross(jnp.asarray([0.0, 1.0, 0.0], dtype=dtype), y_dir) * dw[..., None] * 0.03
        x_dir = x_dir.at[..., 1].set(dy)
        zeros = jnp.zeros_like(dth)
        new_rot = qmul(
            w2quat(jnp.stack([zeros, -dth, zeros], axis=-1)),
            qmul(rot, w2quat(jnp.stack([zeros, dw, zeros], axis=-1))),
        )
        new_pos = jnp.maximum(jnp.minimum(pos + x_dir, ub), lb)
        return new_pos, new_rot, gap

    new_pos = jnp.maximum(jnp.minimum(pos + v, ub), lb)
    if spec.shape == "Chopsticks":
        new_gap = jnp.maximum(gap - gap_vel, spec.minimal_gap)
        new_rot = qmul(rot, w2quat(w))
        return new_pos, new_rot, new_gap
    new_rot = qmul(w2quat(w), rot)
    return new_pos, new_rot, gap


def action_to_velocity(spec: PrimitiveSpec, action, n_substeps, dtype):
    """Env-step action slice -> per-substep (v, w, gap_vel)
    (reference primive_base.py:184-192, Chopsticks primitives.py:101-109)."""
    zeros3 = jnp.zeros((3,), dtype=dtype)
    zero = jnp.zeros((), dtype=dtype)
    if spec.action_dim == 0:
        return zeros3, zeros3, zero
    scale = jnp.asarray(spec.action_scale, dtype=dtype)
    a = action.astype(dtype) * scale / n_substeps
    v = a[:3]
    w = a[3:6] if spec.action_dim > 3 else zeros3
    gap_vel = a[6] if spec.shape == "Chopsticks" else zero
    return v, w, gap_vel
