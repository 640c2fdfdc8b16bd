"""Component-major rigid-SDF math: tuples of (M,) arrays instead of (..., 3).

The (..., 3)-vector formulation of engine/primitives.py puts a 3-wide
dimension minor on the grid's cell arrays. This module re-expresses the
same math (identical constants and branch structure — behavioral reference
plb/engine/primitive/primitives.py and primive_base.py:82-115) on
per-component arrays, so each op runs over the long cell axis.
mpm.grid_op_cm uses it; which of the two grid-update formulations the GPU
runs faster is not measured yet (ROADMAP.md).

Vectors are (x, y, z) tuples of equal-shape arrays; quaternions are
(w, x, y, z) tuples of scalars (poses are per-scene scalars). Tested
against engine/primitives.py in tests/test_primitives_cm.py.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config.spec import PrimitiveSpec

__all__ = ["sdf_cm", "normal_cm", "collider_v_cm", "collide_cm"]


def _len3(x, y, z, eps=1e-14):
    return jnp.sqrt(x * x + y * y + z * z + eps)


def _len2(x, y, eps=1e-14):
    return jnp.sqrt(x * x + y * y + eps)


def _qconj(q):
    w, x, y, z = q
    return (w, -x, -y, -z)


def _qrot(q, v):
    """Rotate vector tuple v by quaternion q (scalar components)."""
    qw, qx, qy, qz = q
    vx, vy, vz = v
    # t = 2 * cross(q_vec, v)
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    # v + qw * t + cross(q_vec, t)
    ox = vx + qw * tx + (qy * tz - qz * ty)
    oy = vy + qw * ty + (qz * tx - qx * tz)
    oz = vz + qw * tz + (qx * ty - qy * tx)
    return (ox, oy, oz)


def _inv_trans(p, pos, rot):
    """World point(s) -> primitive local frame."""
    px, py, pz = p
    return _qrot(_qconj(rot), (px - pos[0], py - pos[1], pz - pos[2]))


# --------------------------------------------------------------------------
# local-frame sdf / normal per shape (constants per primitives.py)
# --------------------------------------------------------------------------

def _capsule_sdf(spec, p):
    px, py, pz = p
    y = py + spec.h / 2
    y = y - jnp.clip(y, 0.0, spec.h)
    return _len3(px, y, pz) - spec.r


def _capsule_normal(spec, p):
    px, py, pz = p
    y = py + spec.h / 2
    y = y - jnp.clip(y, 0.0, spec.h)
    l = _len3(px, y, pz)
    return (px / l, y / l, pz / l)


def _chopsticks_parts(spec, p, gap):
    px, py, pz = p
    half = gap / 2
    py2 = py + spec.h / 2  # mid = (0, -h/2, 0)
    return (px - half, py2, pz), (px + half, py2, pz)


def _cylinder_sdf(spec, p):
    px, py, pz = p
    d0 = jnp.abs(_len2(px, pz)) - spec.h  # reference swaps h/r roles
    d1 = jnp.abs(py) - spec.r
    d0c = jnp.maximum(d0, 0.0)
    d1c = jnp.maximum(d1, 0.0)
    return jnp.minimum(jnp.maximum(d0, d1), 0.0) + jnp.sqrt(
        d0c * d0c + d1c * d1c + 1e-14
    )


def _cylinder_normal(spec, p):
    px, py, pz = p
    l = _len2(px, pz)
    d0 = l - spec.h
    d1 = jnp.abs(py) - spec.r
    f = (d0 > d1).astype(px.dtype)
    inside = (jnp.maximum(d0, d1) <= 0.0).astype(px.dtype)
    n20 = jnp.maximum(d0, 0.0) + inside * f
    n21 = jnp.maximum(d1, 0.0) + inside * (1.0 - f)
    nl = _len2(n20, n21)
    n20, n21 = n20 / nl, n21 / nl
    ysign = (py >= 0).astype(px.dtype) * 2.0 - 1.0
    nx = (px / l) * n20
    ny = n21 * ysign
    nz = (pz / l) * n20
    nl3 = _len3(nx, ny, nz)
    return (nx / nl3, ny / nl3, nz / nl3)


def _torus_sdf(spec, p):
    px, py, pz = p
    q0 = _len2(px, pz) - spec.tx
    return _len2(q0, py) - spec.ty


def _torus_normal(spec, p):
    px, py, pz = p
    l = _len2(px, pz)
    q0 = l - spec.tx
    ql = _len2(q0, py)
    n20, n21 = q0 / ql, py / ql
    nx = (px / l) * n20
    ny = n21
    nz = (pz / l) * n20
    nl3 = _len3(nx, ny, nz)
    return (nx / nl3, ny / nl3, nz / nl3)


def _box_sdf(spec, p):
    px, py, pz = p
    sx, sy, sz = [float(s) for s in spec.size]
    qx, qy, qz = jnp.abs(px) - sx, jnp.abs(py) - sy, jnp.abs(pz) - sz
    out = _len3(jnp.maximum(qx, 0.0), jnp.maximum(qy, 0.0), jnp.maximum(qz, 0.0))
    return out + jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)


def _box_normal(spec, p):
    # central FD with d=1e-4 (reference primitives.py:240-251)
    d = 1e-4
    px, py, pz = p
    comps = []
    for i in range(3):
        hi = [px, py, pz]
        lo = [px, py, pz]
        hi[i] = hi[i] + d
        lo[i] = lo[i] - d
        comps.append((_box_sdf(spec, tuple(hi)) - _box_sdf(spec, tuple(lo)))
                     * (0.5 / d))
    nl = _len3(*comps)
    return (comps[0] / nl, comps[1] / nl, comps[2] / nl)


def _local_sdf(spec, p, gap):
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


def _local_normal(spec, p, gap):
    shape = spec.shape
    if shape in ("Capsule", "RollingPin"):
        return _capsule_normal(spec, p)
    if shape == "Chopsticks":
        a, b = _chopsticks_parts(spec, p, gap)
        m = (_capsule_sdf(spec, a) <= _capsule_sdf(spec, b)).astype(p[0].dtype)
        na, nb = _capsule_normal(spec, a), _capsule_normal(spec, b)
        return tuple(m * ca + (1.0 - m) * cb for ca, cb in zip(na, nb))
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

def sdf_cm(spec: PrimitiveSpec, pos, rot, gap, p):
    """pos: (3,) scalar tuple/array, rot: (4,), p: (px, py, pz) arrays."""
    if spec.shape == "Sphere":
        return _len3(p[0] - pos[0], p[1] - pos[1], p[2] - pos[2]) - spec.radius
    return _local_sdf(spec, _inv_trans(p, pos, rot), gap)


def normal_cm(spec: PrimitiveSpec, pos, rot, gap, p):
    if spec.shape == "Sphere":
        dx, dy, dz = p[0] - pos[0], p[1] - pos[1], p[2] - pos[2]
        l = _len3(dx, dy, dz)
        return (dx / l, dy / l, dz / l)
    local = _inv_trans(p, pos, rot)
    return _qrot(rot, _local_normal(spec, local, gap))


def collider_v_cm(pos_f, rot_f, pos_f1, rot_f1, p, dt):
    """Rigid-body surface velocity (reference primive_base.py:82-89)."""
    rel = _qrot(_qconj(rot_f), (p[0] - pos_f[0], p[1] - pos_f[1],
                                p[2] - pos_f[2]))
    npx, npy, npz = _qrot(rot_f1, rel)
    inv_dt = 1.0 / dt
    return ((npx + pos_f1[0] - p[0]) * inv_dt,
            (npy + pos_f1[1] - p[1]) * inv_dt,
            (npz + pos_f1[2] - p[2]) * inv_dt)


def collide_cm(spec: PrimitiveSpec, pos_f, rot_f, gap_f, pos_f1, rot_f1,
               friction, softness, grid_pos, v, dt):
    """Softness-weighted friction contact on grid velocities — branchless
    component form of primitives.collide (reference primive_base.py:91-115).
    grid_pos, v: (x, y, z) tuples of (M,) arrays. Returns updated v tuple."""
    dtype = v[0].dtype
    dist = sdf_cm(spec, pos_f, rot_f, gap_f, grid_pos)
    influence = jnp.minimum(jnp.exp(-dist * softness), 1.0)
    cond = jnp.logical_or(
        jnp.logical_and(softness > 0, influence > 0.1), dist <= 0
    )

    Dx, Dy, Dz = normal_cm(spec, pos_f, rot_f, gap_f, grid_pos)
    cvx, cvy, cvz = collider_v_cm(pos_f, rot_f, pos_f1, rot_f1, grid_pos, dt)

    ivx, ivy, ivz = v[0] - cvx, v[1] - cvy, v[2] - cvz
    nc = ivx * Dx + ivy * Dy + ivz * Dz
    ncm = jnp.minimum(nc, 0.0)
    tx, ty, tz = ivx - ncm * Dx, ivy - ncm * Dy, ivz - ncm * Dz
    tnorm = _len3(tx, ty, tz, 1e-8)  # utils.length eps
    scale = jnp.maximum(0.0, tnorm + nc * friction) / tnorm
    flag = jnp.logical_and(
        nc < 0, jnp.sqrt(tx * tx + ty * ty + tz * tz) > 1e-30
    ).astype(dtype)
    s_eff = flag * scale + (1.0 - flag)
    tx, ty, tz = tx * s_eff, ty * s_eff, tz * s_eff
    nvx = cvx + ivx * (1.0 - influence) + tx * influence
    nvy = cvy + ivy * (1.0 - influence) + ty * influence
    nvz = cvz + ivz * (1.0 - influence) + tz * influence
    return (jnp.where(cond, nvx, v[0]),
            jnp.where(cond, nvy, v[1]),
            jnp.where(cond, nvz, v[2]))
