"""Forward-only path-tracing renderer, pure jnp (f32), batched over rays.

Behavioral reference: plb/engine/renderer/renderer.py + renderer_utils.py —
particle voxelization with bit-packed distance|color min-scatter, 27-tap
smoothing, trilinear texture sampling, background/ground planes, primitive
sphere-tracing, plasticine SDF march with bisection refinement, goal-density
ghost (blinking at 50% via even samples), <=2 diffuse bounces with optional
directional light, vignette+exposure tone map.

Design: rays are traced in pixel tiles (lax.map over tile batches) so
each tile's march while_loops stop at the tile's own slowest lane — sky and
off-object tiles exit after a handful of iterations instead of riding the
whole image's worst ray. Shadow rays use an occlusion-only march (no
bisection / normal / color). The full spp accumulation runs on-device in one
jitted fori_loop; randomness is jax.random.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config.spec import SceneSpec
from .. import primitives as prim_mod

DIFFUSE, SPECULAR = 0, 1
FOV = 0.23
DIST_LIMIT = 100.0
INF = 1e10
EXPOSURE = 1.5
LIGHT_DIRECTION_NOISE = 0.03
LIGHT_COLOR = (1.0, 1.0, 1.0)


def obs_scene(scene: SceneSpec, res: int, spp: int) -> SceneSpec:
    """Scene spec scaled for small observation frames (visual RL).

    Half-resolution voxel grid with the same physical coverage
    (84 * 2dx = 168 * dx) and the same physical splat radius (bake
    3 * 2dx = 6 * dx); dist_scale is tied to dx so the packed saturation
    distance is physical too. Voxelize work drops ~8x — it dominates
    per-frame cost at 64^2 where the march is cheap."""
    import dataclasses

    rcfg = scene.renderer
    return dataclasses.replace(
        scene,
        renderer=dataclasses.replace(
            rcfg, image_res=(res, res), spp=spp,
            voxel_res=tuple(max(v // 2, 1) for v in rcfg.voxel_res),
            dx=rcfg.dx * 2.0,
            bake_size=max(rcfg.bake_size // 2, 1)))


# ---------------------------------------------------------------------------
# texture sampling (reference sample_tex :137-155 — deliberately replicates
# its uncentered trilinear indexing)
# ---------------------------------------------------------------------------

def _sample_tex(tex_flat, res, pos, channels: int):
    a, b, c = res
    p = pos * jnp.asarray([a, b, c], jnp.float32)
    base = jnp.minimum(p.astype(jnp.int32), jnp.asarray([a, b, c], jnp.int32) - 1)
    base = jnp.maximum(base, 0)
    fx = p - base.astype(jnp.float32)

    def at(x, y, z):
        idx = (x * b + y) * c + z
        return tex_flat[idx]

    x, y, z = base[..., 0], base[..., 1], base[..., 2]
    x1 = jnp.minimum(x + 1, a - 1)
    y1 = jnp.minimum(y + 1, b - 1)
    z1 = jnp.minimum(z + 1, c - 1)
    f0 = fx[..., 0:1] if channels > 1 else fx[..., 0]
    f1 = fx[..., 1:2] if channels > 1 else fx[..., 1]
    f2 = fx[..., 2:3] if channels > 1 else fx[..., 2]
    c00 = at(x, y, z) * (1 - f0) + at(x1, y, z) * f0
    c01 = at(x, y, z1) * (1 - f0) + at(x1, y, z1) * f0
    c10 = at(x, y1, z) * (1 - f0) + at(x1, y1, z) * f0
    c11 = at(x, y1, z1) * (1 - f0) + at(x1, y1, z1) * f0
    c0 = c00 * (1 - f1) + c10 * f1
    c1 = c01 * (1 - f1) + c11 * f1
    return c0 * (1 - f2) + c1 * f2


# ---------------------------------------------------------------------------
# corner-packed sampling + in-row distance field
#
# The march minimizes SAMPLES PER LANE (its wallclock is sequential samples
# of the worst lane times lanes in the op): the 8 trilinear corners AND a
# per-voxel Chebyshev distance-to-surface are packed into ONE row, so a
# single gather per step yields both the sample and a certified skip —
# sphere tracing on an exact cell-distance field, sampling at the reference
# minimum step h only inside near-surface cells (where crossings can live).
# ---------------------------------------------------------------------------


def _pack_corners(t3):
    """(X, Y, Z) -> (X*Y*Z, 8) bf16 rows of the 8 edge-clamped trilinear
    corner values (i-major order), so one gather serves a full sample."""
    outs = []
    for i in (0, 1):
        tx = t3 if i == 0 else jnp.concatenate([t3[1:], t3[-1:]], 0)
        for j in (0, 1):
            ty = tx if j == 0 else jnp.concatenate(
                [tx[:, 1:], tx[:, -1:]], 1)
            for k in (0, 1):
                tz = ty if k == 0 else jnp.concatenate(
                    [ty[:, :, 1:], ty[:, :, -1:]], 2)
                outs.append(tz.reshape(-1))
    return jnp.stack(outs, axis=-1).astype(jnp.bfloat16)


def _corner_rows(pack, res, pos):
    """Gather the packed corner rows for pos (texture coords in [0,1]^3).
    Returns (v (..., 8) f32, fx (..., 3)) — same uncentered indexing as
    _sample_tex (reference sample_tex :137-155)."""
    a, b, c = res
    p = pos * jnp.asarray([a, b, c], jnp.float32)
    base = jnp.minimum(p.astype(jnp.int32),
                       jnp.asarray([a, b, c], jnp.int32) - 1)
    base = jnp.maximum(base, 0)
    fx = p - base.astype(jnp.float32)
    idx = (base[..., 0] * b + base[..., 1]) * c + base[..., 2]
    return pack[idx].astype(jnp.float32), fx


def _trilerp(v, fx):
    """Interpolate packed corner rows v (..., 8) at fractions fx (..., 3)."""
    f0, f1, f2 = fx[..., 0], fx[..., 1], fx[..., 2]
    w0 = jnp.stack([(1 - f0), (1 - f0), (1 - f0), (1 - f0), f0, f0, f0, f0],
                   axis=-1)
    w1 = jnp.stack([(1 - f1), (1 - f1), f1, f1, (1 - f1), (1 - f1), f1, f1],
                   axis=-1)
    w2 = jnp.stack([(1 - f2), f2, (1 - f2), f2, (1 - f2), f2, (1 - f2), f2],
                   axis=-1)
    return jnp.sum(v * w0 * w1 * w2, axis=-1)


def _trilerp_grad(v, fx):
    """d(trilinear)/d(fractional coords): (..., 3) from the corner rows —
    replaces the reference's 6 extra central-difference samples."""
    f0, f1, f2 = fx[..., 0], fx[..., 1], fx[..., 2]
    one = jnp.ones_like(f0)
    s0 = jnp.stack([-one, -one, -one, -one, one, one, one, one], axis=-1)
    w0 = jnp.stack([(1 - f0)] * 4 + [f0] * 4, axis=-1)
    s1 = jnp.stack([-one, -one, one, one, -one, -one, one, one], axis=-1)
    w1 = jnp.stack([(1 - f1), (1 - f1), f1, f1, (1 - f1), (1 - f1), f1, f1],
                   axis=-1)
    s2 = jnp.stack([-one, one, -one, one, -one, one, -one, one], axis=-1)
    w2 = jnp.stack([(1 - f2), f2, (1 - f2), f2, (1 - f2), f2, (1 - f2), f2],
                   axis=-1)
    gx = jnp.sum(v * s0 * w1 * w2, axis=-1)
    gy = jnp.sum(v * w0 * s1 * w2, axis=-1)
    gz = jnp.sum(v * w0 * w1 * s2, axis=-1)
    return jnp.stack([gx, gy, gz], axis=-1)


def _near_bounds(near):
    """Tight bounds (in voxel units, rel = vox/res) of the near-cell set:
    every threshold crossing lives inside [lo, hi]. Rays are clipped to this
    box instead of the full texture AABB — at 512^2 the material covers a
    small screen fraction, so most lanes never march at all. Empty near set
    => lo > hi (ray_aabb then rejects every ray)."""
    any_near = jnp.any(near)
    los, his = [], []
    for ax in range(3):
        proj = jnp.any(near, axis=tuple(a for a in range(3) if a != ax))
        n = proj.shape[0]
        lo = jnp.argmax(proj)
        hi = n - 1 - jnp.argmax(proj[::-1])
        los.append(jnp.where(any_near, lo, 1).astype(jnp.float32))
        his.append(jnp.where(any_near, hi + 1, 0).astype(jnp.float32))
    return jnp.stack(los), jnp.stack(his)


def _cell_distance_field(sdf3, threshold, iters=24):
    """Exact (clamped) Chebyshev distance, in cells, from each voxel cell to
    the nearest NEAR cell — a cell is near when the min of its 8 corners
    dips below threshold (a trilinear sample inside a far cell can never
    cross it, min(corners) <= trilerp). From a point inside a cell with
    d = D, every point strictly within (D-1) voxels (any norm; L2 >= Linf)
    lies in a far cell — a certified sphere-trace skip."""
    pads = [(0, 1)] * 3
    cmin = -jax.lax.reduce_window(
        -jnp.pad(sdf3, pads, constant_values=jnp.inf),
        -jnp.inf, jax.lax.max, (2, 2, 2), (1, 1, 1), "VALID")
    near = cmin < threshold
    d = jnp.where(near, 0.0, jnp.float32(iters + 1))
    for _ in range(iters):
        nmin = -jax.lax.reduce_window(
            -d, -jnp.inf, jax.lax.max, (3, 3, 3), (1, 1, 1), "SAME")
        d = jnp.minimum(d, nmin + 1.0)
    return d, near  # (X, Y, Z) f32 in [0, iters+1], near-cell mask


def _march_packed(pack9, res, bbox, thr, h, vox, o, d, t0, tfar, active0,
                  cap=512):
    """First threshold crossing of the trilinear field along o + t*d.

    One gather per sequential step: the (..., 9) row holds the 8 trilinear
    corners plus the cell's Chebyshev distance-to-surface (see
    _cell_distance_field). Far from the surface the lane skips (D-1) voxels
    (certified crossing-free); inside near cells it samples at h — the
    reference marcher's MINIMUM step (renderer.py:288 max(s*0.05, 0.01)),
    i.e. at least as finely as the reference wherever a crossing can exist
    (and exactly, not heuristically, in empty space: far cells cannot
    contain a crossing at all).

    Returns (hit, t_hit): s(t_hit) < 0 and the previous sample (>= 0) is at
    most h behind — skip endpoints are continuity points of s >= 0, so a
    crossing is always bracketed by the last fine step (see _refine_packed).
    """
    f32 = jnp.float32
    R = o.shape[0]
    span = bbox[1] - bbox[0]

    def cond(c):
        j, t, hit, thit, active = c
        return (j < cap) & jnp.any(active)

    def body(c):
        j, t, hit, thit, active = c
        rel = (o + d * t[:, None] - bbox[0]) / span
        ok = (jnp.min(rel, -1) >= 0) & (jnp.max(rel, -1) <= 1)
        v, fx = _corner_rows(pack9, res, rel)
        s = jnp.where(ok, _trilerp(v[..., :8], fx) - thr, 0.0)
        dist = v[..., 8]
        found = active & (s < 0)
        thit = jnp.where(found, t, thit)
        hit = hit | found
        step = jnp.maximum((dist - 1.0) * vox, h)
        t = jnp.where(active & ~found, t + step, t)
        active = active & ~found & (t < tfar)
        return j + 1, t, hit, thit, active

    hit0 = jnp.zeros((R,), bool)
    thit0 = jnp.full((R,), jnp.inf, f32)
    _, _, hit, thit, _ = jax.lax.while_loop(
        cond, body, (0, t0, hit0, thit0, active0))
    return hit, thit


def _march_compacted(pack9, res, bbox, thr, h, vox, o, d, t0, tfar, active0,
                     chunk=None, refine=False):
    """_march_packed over only the ACTIVE lanes, compacted into fixed-size
    chunks. Every lane in a full-width march op costs its gather index
    whether or not it is active, and at 512^2 most lanes never intersect
    the texture bbox; compacting makes march cost proportional to active
    rays. Lanes are permuted actives-first
    (argsort of ~active is stable), processed in ceil(count/chunk) dynamic
    chunks by a while_loop, and scattered back — results are identical to
    the full-width march. The default chunk was chosen before the H100
    port and is not yet tuned on it."""
    if chunk is None:
        chunk = int(os.environ.get("PLB_RENDER_MARCH_CHUNK", 65536))
    R = o.shape[0]
    if R <= chunk:
        hit, thit = _march_packed(pack9, res, bbox, thr, h, vox, o, d, t0,
                                  tfar, active0)
        if refine:
            thit = _refine_packed(pack9, res, bbox, thr, h, o, d, hit, thit)
        return hit, thit
    f32 = jnp.float32
    order = jnp.argsort(~active0)  # stable: active lanes first
    count = jnp.sum(active0.astype(jnp.int32))
    rays = jnp.concatenate(
        [o, d, t0[:, None], tfar[:, None]], axis=-1)[order]  # one gather

    def chunk_cond(c):
        k, _, _ = c
        return k * chunk < count

    def chunk_body(c):
        k, hit_s, thit_s = c
        rc = jax.lax.dynamic_slice_in_dim(rays, k * chunk, chunk, 0)
        act = (jnp.arange(chunk) + k * chunk) < count
        hit_c, thit_c = _march_packed(
            pack9, res, bbox, thr, h, vox, rc[:, 0:3], rc[:, 3:6],
            rc[:, 6], rc[:, 7], act)
        if refine:
            thit_c = _refine_packed(pack9, res, bbox, thr, h,
                                    rc[:, 0:3], rc[:, 3:6], hit_c, thit_c)
        hit_s = jax.lax.dynamic_update_slice_in_dim(hit_s, hit_c, k * chunk, 0)
        thit_s = jax.lax.dynamic_update_slice_in_dim(
            thit_s, thit_c, k * chunk, 0)
        return k + 1, hit_s, thit_s

    pad = (-R) % chunk
    hit0 = jnp.zeros((R + pad,), bool)
    thit0 = jnp.full((R + pad,), jnp.inf, f32)
    if pad:
        rays = jnp.concatenate(
            [rays, jnp.zeros((pad, rays.shape[1]), rays.dtype)], 0)
    _, hit_s, thit_s = jax.lax.while_loop(
        chunk_cond, chunk_body, (0, hit0, thit0))
    inv = jnp.zeros((R,), jnp.int32).at[order].set(
        jnp.arange(R, dtype=jnp.int32))
    return hit_s[inv], thit_s[inv]


def _refine_packed(pack, res, bbox, thr, h, o, d, hit, thit, K2=8):
    """Localize the crossing inside (thit - h, thit] with one K2-row gather,
    then linearly interpolate the bracketing samples. Replaces the
    reference's 20-step bisection (renderer.py:274-279) at equivalent
    sub-voxel accuracy (h/K2 bracket + secant)."""
    f32 = jnp.float32
    span = bbox[1] - bbox[0]

    def sample_s(p):
        rel = (p - bbox[0]) / span
        ok = (jnp.min(rel, -1) >= 0) & (jnp.max(rel, -1) <= 1)
        v, fx = _corner_rows(pack, res, rel)
        return jnp.where(ok, _trilerp(v[..., :8], fx) - thr, 0.0)

    dh = h / K2
    base = jnp.maximum(thit - h, 0.0)
    ts = base[:, None] + dh * jnp.arange(1, K2 + 1, dtype=f32)[None, :]
    pk = o[:, None, :] + d[:, None, :] * ts[..., None]
    s = sample_s(pk)                                           # (R, K2)
    neg = s < 0
    kf = jnp.argmax(neg, axis=1)
    any_neg = jnp.any(neg, axis=1)
    iot = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    s_hi = jnp.sum(jnp.where(iot == kf[:, None], s, 0.0), 1)
    kp = jnp.maximum(kf - 1, 0)
    s_lo = jnp.where(kf > 0,
                     jnp.sum(jnp.where(iot == kp[:, None], s, 0.0), 1), 1.0)
    t_hi = base + dh * (kf + 1).astype(f32)
    denom = jnp.where(jnp.abs(s_lo - s_hi) < 1e-12, 1.0, s_lo - s_hi)
    frac = jnp.clip(s_lo / denom, 0.0, 1.0)
    t_star = jnp.where(any_neg, t_hi - dh + dh * frac, thit)
    return jnp.where(hit, t_star, thit)


def _ray_aabb(box_min, box_max, o, d):
    """renderer_utils.ray_aabb_intersection — slab method; d==0 handled via
    +/-inf division semantics."""
    safe_d = jnp.where(d == 0, 1e-30, d)
    i1 = (box_min - o) / safe_d
    i2 = (box_max - o) / safe_d
    near = jnp.max(jnp.minimum(i1, i2), axis=-1)
    far = jnp.min(jnp.maximum(i1, i2), axis=-1)
    inside0 = jnp.all((d != 0) | ((o >= box_min) & (o <= box_max)), axis=-1)
    return (near <= far) & inside0, near, far


def _smooth27(vol):
    """27-tap box filter; border cells forced to 1 (reference smooth :88-98)."""
    summed = jax.lax.reduce_window(
        vol, 0.0, jax.lax.add, (3, 3, 3), (1, 1, 1), "SAME"
    )
    out = summed / 27.0
    border = jnp.zeros_like(vol, dtype=bool)
    border = border.at[0, :, :].set(True).at[-1, :, :].set(True)
    border = border.at[:, 0, :].set(True).at[:, -1, :].set(True)
    border = border.at[:, :, 0].set(True).at[:, :, -1].set(True)
    return jnp.where(border, jnp.ones_like(out), out)


class Renderer:
    def __init__(self, scene: SceneSpec, **kwargs):
        cfg = scene.renderer
        self.scene = scene
        self.cfg = cfg
        self.dx = cfg.dx
        self.inv_dx = 1.0 / cfg.dx
        self.spp = cfg.spp
        self.voxel_res = tuple(int(v) for v in cfg.voxel_res)
        self.target_res = tuple(int(v) for v in cfg.target_res)
        self.bake_size = int(cfg.bake_size)
        self.max_ray_depth = int(cfg.max_ray_depth)
        self.sdf_threshold = float(cfg.sdf_threshold)
        self.use_directional_light = bool(cfg.use_directional_light)
        self.light_direction = tuple(cfg.light_direction)
        self.image_res = tuple(int(v) for v in cfg.image_res)
        self.aspect_ratio = self.image_res[0] / self.image_res[1]
        self.camera_pos = np.asarray(cfg.camera_pos, np.float32)
        self.camera_rot = tuple(cfg.camera_rot)
        self.vignette_strength = 0.9
        self.vignette_radius = 0.0
        self.vignette_center = (0.5, 0.5)
        self.target_density_color = (0.1, 0.3, 0.9)

        # Packed-distance scale per voxel. The reference bakes
        # 255*0.2*dist_in_voxels at dx=1/150 (renderer.py:100-131); scaling
        # with dx keeps the PHYSICAL saturation distance (5/150 of the box)
        # invariant when a caller coarsens the voxel grid (render_obs).
        self.dist_scale = 0.2 * self.dx * 150.0

        self.target_density = jnp.zeros(self.target_res, jnp.float32)
        self._voxelize = jax.jit(self._voxelize_impl)
        self._pack_main = jax.jit(self._pack_main_impl)
        self._pack_target = jax.jit(self._pack_target_impl)
        self._tgt_packed = None  # filled by set_target_density / first frame
        self._render_many = {}  # keyed by (shape, primitive, target) flags
        self._key = jax.random.PRNGKey(0)

    # ------------------------------------------------------------------
    # voxelization (reference build_sdf_from_particles :100-131)
    # ------------------------------------------------------------------
    def _voxelize_impl(self, x, color, bbox0):
        res = self.voxel_res
        p = (x - bbox0) * self.inv_dx  # voxel coords
        volume = self._packed_volume(p, color)
        sdf = ((volume >> 24) & 255).astype(jnp.float32) / 255.0
        col = jnp.stack(
            [((volume >> 16) & 255), ((volume >> 8) & 255), (volume & 255)],
            axis=-1,
        ).astype(jnp.float32) / 255.0
        sdf = sdf.reshape(res)
        sdf = _smooth27(_smooth27(sdf))
        return sdf.reshape(-1), col.reshape(-1, 3)

    def _packed_volume(self, p, color):
        """(res^3,) uint32 min-packed (dist << 24 | color) volume by
        scatter-min, the reference's bit-packed atomic_min
        (renderer.py:100-131)."""
        n = p.shape[0]
        res = self.voxel_res
        size = self.bake_size
        total = res[0] * res[1] * res[2]
        volume = jnp.full((total,), jnp.uint32(0xFFFFFFFF))
        coord = p.astype(jnp.int32)
        offs = np.array(
            [(i, j, k)
             for i in range(-size - 1, size + 1)
             for j in range(-size - 1, size + 1)
             for k in range(-size - 1, size + 1)], np.int32,
        )  # (M, 3) — matches the reference's ndrange(-size-1, size+1)
        # Exact-saturation cull: a particle lies at coord + r, r in [0,1)^3,
        # so the packed distance written at voxel coord+o is >= the distance
        # from o to the unit cube — once that exceeds the saturation radius
        # 1/dist_scale the write is always 255<<24 and cannot change the sdf
        # (it could only tint cells the march never shades). Dropping those
        # offsets cuts the scatter volume ~3.5x at the reference bake_size=6.
        sat = 1.0 / self.dist_scale
        cube_d = np.linalg.norm(
            offs - np.clip(offs, 0.0, 1.0), axis=1)
        offs = offs[cube_d <= sat]
        CH = 128  # offsets per scan step
        M = offs.shape[0]
        pad = (-M) % CH
        offs = np.pad(offs, ((0, pad), (0, 0)))
        offs_chunks = jnp.asarray(offs.reshape(-1, CH, 3))
        valid_chunks = jnp.asarray(
            np.pad(np.ones(M, bool), (0, pad)).reshape(-1, CH)
        )
        rbound = jnp.asarray(res, jnp.int32)

        def body(vol, inp):
            off, valid = inp  # (CH,3), (CH,)
            idx = coord[:, None, :] + off[None, :, :]  # (n,CH,3)
            ok = valid[None, :] & jnp.all(
                (idx >= 0) & (idx < rbound[None, None, :]), axis=-1
            )
            dist = jnp.linalg.norm(
                idx.astype(jnp.float32) - p[:, None, :], axis=-1
            )
            dist = jnp.clip(255.0 * self.dist_scale * dist, 0.0, 255.0)
            packed = (
                (dist.astype(jnp.uint32) << 24) + color[:, None].astype(jnp.uint32)
            )
            packed = jnp.where(ok, packed, jnp.uint32(0xFFFFFFFF))
            flat = (idx[..., 0] * res[1] + idx[..., 1]) * res[2] + idx[..., 2]
            flat = jnp.clip(flat, 0, total - 1)
            return vol.at[flat.reshape(-1)].min(packed.reshape(-1)), None

        volume, _ = jax.lax.scan(body, volume, (offs_chunks, valid_chunks))
        return volume

    # ------------------------------------------------------------------
    def set_target_density(self, target_density: Optional[np.ndarray]):
        """reference set_target_density :519-524: texture = boxfilter(3 - raw)."""
        if target_density is None:
            self.target_density = jnp.zeros(self.target_res, jnp.float32)
        else:
            raw = jnp.asarray(target_density, jnp.float32)
            G = round(raw.size ** (1.0 / 3.0))
            raw = raw.reshape((G, G, G))
            if (G, G, G) != tuple(self.target_res):
                # scene grids smaller than the render volume (e.g. 32^3
                # probe scenes) upsample nearest-neighbour — the goal ghost
                # is a visual texture only, never part of the loss
                reps = self.target_res[0] // G
                assert reps * G == self.target_res[0], (G, self.target_res)
                for ax in range(3):
                    raw = jnp.repeat(raw, reps, axis=ax)
            raw = raw.reshape(self.target_res)
            self.target_density = _smooth27(3.0 - raw)
        # The goal texture is static per scene — pack it once here, not per
        # frame (it cost ~30 ms/frame regardless of image resolution).
        self._tgt_packed = self._pack_target(self.target_density)

    # ------------------------------------------------------------------
    # per-sample render
    # ------------------------------------------------------------------
    def _build_tracer(self, shape_flag, prim_flag, target_flag):
        """next_hit + occluded for one (shape, primitive, target) variant.
        Split from _build_render_many so tests can probe hit distances and
        normals directly (probe_rays)."""
        scene = self.scene
        res = self.voxel_res
        tres = self.target_res
        unit_bbox = jnp.asarray([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]],
                                jnp.float32)
        h_fine = 0.01                      # reference minimum step (:288)
        h_ghost = 1.0 / tres[0]            # reference ghost step (:320)

        def packed_normal(pack, pres, bbox, pos):
            """Surface normal from the analytic trilinear gradient of the
            corner rows at pos — replaces the reference's 6 extra
            central-difference samples (renderer.py sample_normal)."""
            rel = (pos - bbox[0]) / (bbox[1] - bbox[0])
            v, fx = _corner_rows(pack, pres, rel)
            g = _trilerp_grad(v[..., :8], fx)
            return g / (jnp.linalg.norm(g, axis=-1, keepdims=True) + 1e-12)

        def packed_color(col_pack, bbox, pos):
            rel = (pos - bbox[0]) / (bbox[1] - bbox[0])
            v, fx = _corner_rows(col_pack, res, rel)   # (..., 8, 3)
            f0, f1, f2 = fx[..., 0:1], fx[..., 1:2], fx[..., 2:3]
            w = jnp.stack([
                (1 - f0) * (1 - f1) * (1 - f2), (1 - f0) * (1 - f1) * f2,
                (1 - f0) * f1 * (1 - f2), (1 - f0) * f1 * f2,
                f0 * (1 - f1) * (1 - f2), f0 * (1 - f1) * f2,
                f0 * f1 * (1 - f2), f0 * f1 * f2,
            ], axis=-2)                                 # (..., 8, 1)
            return jnp.sum(v * w, axis=-2)

        def ground_color(p):
            base = jnp.asarray([0.3, 0.5, 0.7], jnp.float32)
            inbox = (p[..., 0] <= 1) & (p[..., 0] >= 0) & (p[..., 2] <= 1) & (p[..., 2] >= 0)
            checker = (
                ((p[..., 0] / 0.25).astype(jnp.int32)
                 + (p[..., 2] / 0.25).astype(jnp.int32)) % 2
            ).astype(jnp.float32) * 0.2 + 0.35
            k = jnp.where(inbox, checker, 0.4)
            return base * k[..., None]

        def prim_sdf_all(poses, pp):
            """min over primitives + argmin id (pose index 0 = current)."""
            pos, rot, gap = poses
            vals = []
            for i, p in enumerate(scene.primitives):
                vals.append(prim_mod.sdf(p, pos[i], rot[i], gap[i], pp))
            v = jnp.stack(vals, axis=-1)  # (R, k)
            return jnp.min(v, -1).astype(jnp.float32), jnp.argmin(v, -1).astype(jnp.int32)

        def prim_bound_entry(poses, o, d):
            """First intersection of the ray with any primitive's bounding
            sphere (INF on miss) — the sphere trace starts there instead of
            at the camera (identical hits: sdf > 0 strictly outside every
            bounding sphere), so off-object lanes go inactive immediately
            and on-object lanes skip the empty approach."""
            pos, rot, gap = poses
            t_enter = jnp.full(o.shape[:-1], INF, jnp.float32)
            for i, p in enumerate(scene.primitives):
                rad = prim_mod.bounding_radius(p, gap[i]) + 1e-3
                oc = o - pos[i]
                b = jnp.sum(oc * d, -1)
                c = jnp.sum(oc * oc, -1) - rad * rad
                disc = b * b - c
                t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
                hit_front = (disc > 0) & (t >= 0)
                inside = c <= 0
                t = jnp.where(inside, 0.0, t)
                t_enter = jnp.where(hit_front | inside,
                                    jnp.minimum(t_enter, t), t_enter)
            return t_enter

        def prim_normal_color(poses, sdf_id, pp):
            pos, rot, gap = poses
            normal = jnp.zeros(pp.shape, jnp.float32)
            color = jnp.zeros(pp.shape, jnp.float32)
            for i, p in enumerate(scene.primitives):
                sel = (sdf_id == i)[..., None]
                normal = jnp.where(
                    sel, prim_mod.normal(p, pos[i], rot[i], gap[i], pp), normal
                )
                color = jnp.where(
                    sel, jnp.asarray(p.color, jnp.float32), color
                )
            return normal, color

        res_f = jnp.asarray(res, jnp.float32)
        tres_f = jnp.asarray(tres, jnp.float32)

        def tight_world(bbox, tight):
            span = bbox[1] - bbox[0]
            return (bbox[0] + tight[0] / res_f * span,
                    bbox[0] + tight[1] / res_f * span)

        def next_hit(textures, o, d, alive):
            sdf_pack, sdf_tight, col_pack, bbox, tgt_pack, tgt_tight, \
                poses = textures
            R = o.shape[0]
            closest = jnp.full((R,), INF, jnp.float32)
            normal = jnp.zeros((R, 3), jnp.float32)
            color = jnp.zeros((R, 3), jnp.float32)
            roughness = jnp.full((R,), 0.05, jnp.float32)

            # background plane z = -5.5 (reference :211-218)
            rc = -(o[:, 2] + 5.5) / jnp.where(d[:, 2] == 0, 1e-30, d[:, 2])
            hit = (d[:, 2] != 0) & (rc > 0) & (rc < closest)
            closest = jnp.where(hit, rc, closest)
            normal = jnp.where(hit[:, None], jnp.asarray([0.0, 0.0, 1.0], jnp.float32), normal)
            color = jnp.where(hit[:, None], jnp.asarray([0.6, 0.7, 0.7], jnp.float32), color)
            roughness = jnp.where(hit, 0.0, roughness)

            # ground plane y = -0.002 (reference :220-228)
            gd = (o[:, 1] + 0.002) / jnp.where(d[:, 1] == 0, 1e-30, -d[:, 1])
            hit = (d[:, 1] < 0) & (gd < DIST_LIMIT) & (gd < closest)
            gc = ground_color(o + d * gd[:, None])
            closest = jnp.where(hit, gd, closest)
            normal = jnp.where(hit[:, None], jnp.asarray([0.0, 1.0, 0.0], jnp.float32), normal)
            color = jnp.where(hit[:, None], gc, color)
            roughness = jnp.where(hit, 0.0, roughness)

            # primitives: sphere trace <=200 steps (reference :231-259),
            # started at the bounding-sphere entry (identical hits)
            if prim_flag and len(scene.primitives) > 0:
                def cond(c):
                    j, dist, sdf_val, sdf_id, active = c
                    return (j < 200) & jnp.any(active)

                def body(c):
                    j, dist, sdf_val, sdf_id, active = c
                    pp = o + dist[:, None] * d
                    sv, sid = prim_sdf_all(poses, pp)
                    sdf_val = jnp.where(active, sv, sdf_val)
                    sdf_id = jnp.where(active, sid, sdf_id)
                    dist = jnp.where(active, dist + sv, dist)
                    active = active & (dist < DIST_LIMIT) & (sdf_val > 1e-8)
                    return j + 1, dist, sdf_val, sdf_id, active

                j0 = jnp.zeros((), jnp.int32)
                dist = prim_bound_entry(poses, o, d)
                sdf_val = jnp.full((R,), INF, jnp.float32)
                sdf_id = jnp.zeros((R,), jnp.int32)
                _, dist, sdf_val, sdf_id, _ = jax.lax.while_loop(
                    cond, body,
                    (j0, dist, sdf_val, sdf_id, alive & (dist < DIST_LIMIT))
                )
                hit = alive & (dist < closest) & (dist < DIST_LIMIT)
                pn, pc = prim_normal_color(poses, sdf_id, o + dist[:, None] * d)
                closest = jnp.where(hit, dist, closest)
                normal = jnp.where(hit[:, None], pn, normal)
                color = jnp.where(hit[:, None], pc, color)
                roughness = jnp.where(hit, 0.0, roughness)

            # plasticine SDF march (reference :263-289), gather-optimized
            if shape_flag:
                lo_w, hi_w = tight_world(bbox, sdf_tight)
                isect, tnear, tfar = _ray_aabb(lo_w, hi_w, o, d)
                isect = isect & alive
                tnear = jnp.maximum(tnear, 0.0)
                t0 = tnear + 1e-4
                hitm, tstar = _march_compacted(
                    sdf_pack, res, bbox, self.sdf_threshold, h_fine,
                    self.dx, o, d, t0, tfar, isect, refine=True)
                pos = o + d * tstar[:, None]
                hit = hitm & (tstar < closest)
                closest = jnp.where(hit, tstar, closest)
                normal = jnp.where(hit[:, None],
                                   packed_normal(sdf_pack, res, bbox, pos),
                                   normal)
                color = jnp.where(hit[:, None],
                                  packed_color(col_pack, bbox, pos), color)

            # goal-density ghost (reference :292-323), same machinery on the
            # 64^3 target texture (threshold 0, fixed 1-voxel steps)
            if target_flag:
                isect, tnear, tfar = _ray_aabb(
                    tgt_tight[0] / tres_f, tgt_tight[1] / tres_f, o, d)
                isect = isect & alive
                tnear = jnp.maximum(tnear, 0.0)
                t0 = tnear + 1e-4
                hitt, tstar = _march_compacted(
                    tgt_pack, tres, unit_bbox, 0.0, h_ghost, h_ghost,
                    o, d, t0, tfar, isect, refine=True)
                pos = o + d * tstar[:, None]
                hit = hitt & (tstar < closest)
                closest = jnp.where(hit, tstar, closest)
                normal = jnp.where(
                    hit[:, None],
                    packed_normal(tgt_pack, tres, unit_bbox, pos), normal)
                color = jnp.where(
                    hit[:, None],
                    jnp.asarray(self.target_density_color, jnp.float32),
                    color)

            return closest, normal, color, roughness

        def occluded(textures, o, d, alive):
            """Anything (same geometry as next_hit) within DIST_LIMIT along
            d? Occlusion-only march: no bisection, no normals, no colors —
            the shadow test (reference :398-400) needs just the boolean."""
            sdf_pack, sdf_tight, col_pack, bbox, tgt_pack, tgt_tight, \
                poses = textures
            R = o.shape[0]
            occ = jnp.zeros((R,), bool)

            rc = -(o[:, 2] + 5.5) / jnp.where(d[:, 2] == 0, 1e-30, d[:, 2])
            occ = occ | ((d[:, 2] != 0) & (rc > 0) & (rc < DIST_LIMIT))
            gd = (o[:, 1] + 0.002) / jnp.where(d[:, 1] == 0, 1e-30, -d[:, 1])
            occ = occ | ((d[:, 1] < 0) & (gd < DIST_LIMIT))

            if prim_flag and len(scene.primitives) > 0:
                def cond(c):
                    j, dist, active = c
                    return (j < 200) & jnp.any(active)

                def body(c):
                    j, dist, active = c
                    sv, _ = prim_sdf_all(poses, o + dist[:, None] * d)
                    dist = jnp.where(active, dist + sv, dist)
                    active = active & (dist < DIST_LIMIT) & (sv > 1e-8)
                    return j + 1, dist, active

                j0 = jnp.zeros((), jnp.int32)
                dist = prim_bound_entry(poses, o, d)
                _, dist, _ = jax.lax.while_loop(
                    cond, body,
                    (j0, dist, alive & ~occ & (dist < DIST_LIMIT)))
                occ = occ | (alive & (dist < DIST_LIMIT))

            if shape_flag:
                lo_w, hi_w = tight_world(bbox, sdf_tight)
                isect, tnear, tfar = _ray_aabb(lo_w, hi_w, o, d)
                tnear = jnp.maximum(tnear, 0.0)
                hitm, _ = _march_compacted(
                    sdf_pack, res, bbox, self.sdf_threshold, h_fine,
                    self.dx, o, d, tnear + 1e-4, tfar,
                    isect & alive & ~occ)
                occ = occ | hitm

            if target_flag:
                isect, tnear, tfar = _ray_aabb(
                    tgt_tight[0] / tres_f, tgt_tight[1] / tres_f, o, d)
                tnear = jnp.maximum(tnear, 0.0)
                hitt, _ = _march_compacted(
                    tgt_pack, tres, unit_bbox, 0.0, h_ghost, h_ghost,
                    o, d, tnear + 1e-4, tfar, isect & alive & ~occ)
                occ = occ | hitt

            return occ

        return next_hit, occluded

    def _build_render_many(self, shape_flag, prim_flag, target_flag,
                           jit=True):
        W, H = self.image_res
        next_hit, occluded = self._build_tracer(shape_flag, prim_flag,
                                                target_flag)

        def out_dir(n, key):
            """cosine-weighted hemisphere (renderer_utils.out_dir)."""
            u = jnp.where(
                (jnp.abs(n[:, 1]) < 1 - 1e-3)[:, None],
                jnp.cross(n, jnp.asarray([0.0, 1.0, 0.0], jnp.float32)),
                jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
            )
            u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
            v = jnp.cross(n, u)
            k1, k2 = jax.random.split(key)
            phi = 2 * np.pi * jax.random.uniform(k1, (n.shape[0],), jnp.float32)
            r = jax.random.uniform(k2, (n.shape[0],), jnp.float32)
            ay = jnp.sqrt(r)
            ax = jnp.sqrt(1 - r)
            return (
                ax[:, None] * (jnp.cos(phi)[:, None] * u + jnp.sin(phi)[:, None] * v)
                + ay[:, None] * n
            )

        def sample_sphere(key, R):
            k1, k2 = jax.random.split(key)
            u = jax.random.uniform(k1, (R,), jnp.float32)
            v = jax.random.uniform(k2, (R,), jnp.float32)
            x = u * 2 - 1
            phi = v * 2 * np.pi
            yz = jnp.sqrt(1 - x * x)
            return jnp.stack([x, yz * jnp.cos(phi), yz * jnp.sin(phi)], -1)

        def sky_color(d):
            coeff = jnp.clip(
                jnp.sum(d * jnp.asarray([0.8, 0.65, 0.15], jnp.float32), -1) * 0.5 + 0.5, 0, 1
            )[:, None]
            light = coeff * jnp.asarray([0.9, 0.9, 0.9], jnp.float32) + (1 - coeff) * jnp.asarray([0.7, 0.7, 0.8], jnp.float32)
            return light * 1.5

        def trace(textures, pos, d, key):
            R = pos.shape[0]
            contrib = jnp.zeros((R, 3), jnp.float32)
            throughput = jnp.ones((R, 3), jnp.float32)
            alive = jnp.ones((R,), bool)  # still bouncing (hasn't hit sky)

            for depth in range(self.max_ray_depth):
                key, k1, k2, k3 = jax.random.split(key, 4)
                closest, normal, c, roughness = next_hit(textures, pos, d, alive)
                hit_pos = pos + closest[:, None] * d
                hit_surface = jnp.linalg.norm(normal, axis=-1) != 0
                step_alive = alive & hit_surface

                out_direction = out_dir(normal, k1)
                glossy = sample_sphere(k2, R) * roughness[:, None]
                nd = out_direction + glossy
                nd = nd / jnp.linalg.norm(nd, axis=-1, keepdims=True)

                d = jnp.where(step_alive[:, None], nd, d)
                pos = jnp.where(step_alive[:, None], hit_pos + 1e-4 * nd, pos)
                throughput = jnp.where(step_alive[:, None], throughput * c, throughput)

                if self.use_directional_light:
                    noise = (jax.random.uniform(k3, (R, 3), jnp.float32) - 0.5) * LIGHT_DIRECTION_NOISE
                    direct = jnp.asarray(self.light_direction, jnp.float32) + noise
                    direct = direct / jnp.linalg.norm(direct, axis=-1, keepdims=True)
                    dot = jnp.sum(direct * normal, -1)
                    occ = occluded(textures, pos, direct, step_alive & (dot > 0))
                    lit = step_alive & (dot > 0) & ~occ
                    contrib = contrib + jnp.where(
                        lit[:, None],
                        throughput * jnp.asarray(LIGHT_COLOR, jnp.float32) * dot[:, None],
                        0.0,
                    )
                alive = step_alive

            out = contrib
            if not self.use_directional_light:
                out = throughput * sky_color(d)
            return out

        def render_pass(textures, key, S):
            """Trace S full-image samples in ONE flat (S*W*H)-lane pass.

            The march is launch-bound, not gather-bound (the sequential
            while_loop steps dominate; each step's arithmetic is far below
            saturation at W*H lanes), so batching samples into wider lanes
            divides the number of sequential steps per frame by ~S."""
            k1, k2, k3 = jax.random.split(key, 3)
            uu = jax.lax.broadcasted_iota(jnp.int32, (S, W, H), 1)
            vv = jax.lax.broadcasted_iota(jnp.int32, (S, W, H), 2)
            ux = uu.astype(jnp.float32) + jax.random.uniform(
                k1, (S, W, H), jnp.float32)
            vx = vv.astype(jnp.float32) + jax.random.uniform(
                k2, (S, W, H), jnp.float32)
            dx_ = 2 * FOV * ux / H - FOV * self.aspect_ratio - 1e-5
            dy_ = 2 * FOV * vx / H - FOV - 1e-5
            d = jnp.stack([dx_, dy_, -jnp.ones((S, W, H), jnp.float32)],
                          axis=-1)
            d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
            r0, r1 = self.camera_rot
            rot_y = np.array(
                [[np.cos(r1), 0, np.sin(r1)], [0, 1, 0], [-np.sin(r1), 0, np.cos(r1)]]
            )
            rot_x = np.array(
                [[1, 0, 0], [0, np.cos(r0), np.sin(r0)], [0, -np.sin(r0), np.cos(r0)]]
            )
            mat = jnp.asarray(rot_y @ rot_x, jnp.float32)
            d = d @ mat.T
            o = jnp.broadcast_to(jnp.asarray(self.camera_pos), (S * W * H, 3))
            out = trace(textures, o, d.reshape(-1, 3), k3)
            return jnp.sum(out.reshape(S, W, H, 3), axis=0)

        def render_many(textures, key, n, S):
            def body(i, acc):
                return acc + render_pass(textures, jax.random.fold_in(key, i),
                                         S)
            return jax.lax.fori_loop(
                0, n // S, body, jnp.zeros((W, H, 3), jnp.float32))

        if not jit:
            return render_many
        return jax.jit(render_many, static_argnums=(2, 3))

    # ------------------------------------------------------------------
    def _prepare_textures(self, x, colors, prim_pos, prim_rot, prim_gap):
        """Voxelize particles and assemble the per-frame texture tuple:
        corner-packed SDF/color/goal textures plus their coarse skip
        fields (see _march_packed)."""
        x = np.asarray(x, np.float32)
        # bbox (reference initialize_particles_kernel + set_particles)
        lower = (np.floor(x.min(0) * self.inv_dx) - 6.0) * self.dx
        desired = (np.floor(x.max(0) * self.inv_dx) - 6.0) * self.dx - lower
        for a, b in zip(desired / self.dx, self.voxel_res):
            assert a < b, f"the sdf should be smaller {a} < {b}"
        upper = lower + np.asarray(self.voxel_res) * self.dx
        bbox = jnp.asarray(np.stack([lower, upper]), jnp.float32)

        sdf_flat, col_flat = self._voxelize(
            jnp.asarray(x), jnp.asarray(colors, jnp.int32),
            jnp.asarray(lower, jnp.float32)
        )
        sdf_pack, sdf_tight, col_pack = self._pack_main(sdf_flat, col_flat)
        if getattr(self, "_tgt_packed", None) is None:
            self._tgt_packed = self._pack_target(self.target_density)
        tgt_pack, tgt_tight = self._tgt_packed
        poses = (
            jnp.asarray(prim_pos, jnp.float32),
            jnp.asarray(prim_rot, jnp.float32),
            jnp.asarray(prim_gap, jnp.float32),
        )
        return (sdf_pack, sdf_tight, col_pack, bbox, tgt_pack, tgt_tight,
                poses)

    def _prepare_textures_jnp(self, x, colors, prim_pos, prim_rot, prim_gap):
        """Traced twin of _prepare_textures for the in-graph observation
        path: the frame bbox is computed with jnp (no host round trip, no
        fits-the-volume assert — the obs voxel grid keeps the main grid's
        physical coverage, so the host path's assert holds by construction).
        Safe under jit and vmap; the target textures are closure constants
        (set_target_density / build_obs_fn precomputes them)."""
        x = jnp.asarray(x, jnp.float32)
        lower = (jnp.floor(jnp.min(x, axis=0) * self.inv_dx) - 6.0) * self.dx
        upper = lower + jnp.asarray(self.voxel_res, jnp.float32) * self.dx
        bbox = jnp.stack([lower, upper])
        sdf_flat, col_flat = self._voxelize_impl(
            x, jnp.asarray(colors, jnp.int32), lower)
        sdf_pack, sdf_tight, col_pack = self._pack_main_impl(
            sdf_flat, col_flat)
        tgt_pack, tgt_tight = self._tgt_packed
        poses = (
            jnp.asarray(prim_pos, jnp.float32),
            jnp.asarray(prim_rot, jnp.float32),
            jnp.asarray(prim_gap, jnp.float32),
        )
        return (sdf_pack, sdf_tight, col_pack, bbox, tgt_pack, tgt_tight,
                poses)

    def build_obs_fn(self, spp=None):
        """Fully-traceable low-res observation render for visual RL
        (BASELINE configs[3]): returns
        f(x, colors, prim_pos, prim_rot, prim_gap, key) -> (H, W, 3) f32
        in [0, ~1], jittable AND vmappable — batched envs render their
        64x64 observations inside the stepping program. Same semantics as
        render_frame with the goal ghost off and one S=spp lane-batched
        pass (small frames are launch-bound; see render_frame notes)."""
        if spp is None:
            spp = self.spp
        W, H = self.image_res
        if self._tgt_packed is None:
            self._tgt_packed = self._pack_target(self.target_density)
        render_many = self._build_render_many(True, True, False, jit=False)
        u = (np.arange(W, dtype=np.float32)[:, None] / W) \
            - self.vignette_center[0]
        v = (np.arange(H, dtype=np.float32)[None, :] / H) \
            - self.vignette_center[1]
        darken = 1.0 - self.vignette_strength * np.maximum(
            np.sqrt(u ** 2 + v ** 2) - self.vignette_radius, 0)
        darken = jnp.asarray(darken[..., None], jnp.float32)

        def obs_fn(x, colors, prim_pos, prim_rot, prim_gap, key):
            textures = self._prepare_textures_jnp(
                x, colors, prim_pos, prim_rot, prim_gap)
            buf = render_many(textures, key, spp, spp)
            img = jnp.sqrt(buf * darken * EXPOSURE / spp)
            return img[:, ::-1].transpose(1, 0, 2)

        return obs_fn

    def _pack9(self, t3, threshold):
        """((N, 9) bf16 rows: 8 edge-clamped trilinear corners + the cell's
        Chebyshev distance-to-surface; (2, 3) tight near-set bounds in voxel
        units — see _cell_distance_field / _near_bounds)."""
        pack = _pack_corners(t3)
        dist, near = _cell_distance_field(t3, threshold)
        lo, hi = _near_bounds(near)
        return jnp.concatenate(
            [pack, dist.reshape(-1, 1).astype(jnp.bfloat16)], axis=-1), \
            jnp.stack([lo, hi])

    def _pack_main_impl(self, sdf_flat, col_flat):
        res = self.voxel_res
        sdf3 = sdf_flat.reshape(res)
        sdf_pack, sdf_tight = self._pack9(sdf3, self.sdf_threshold)
        col_pack = jnp.stack(
            [_pack_corners(col_flat[:, c].reshape(res)) for c in range(3)],
            axis=-1)
        return sdf_pack, sdf_tight, col_pack

    def _pack_target_impl(self, tgt3):
        return self._pack9(tgt3, 0.0)

    def probe_rays(self, x, colors, prim_pos, prim_rot, prim_gap, o, d,
                   **kwargs):
        """March the given rays against the scene; returns (closest, normal,
        color) arrays. Test/debug hook for pinning hit structure."""
        shape_flag = bool(kwargs.get("shape", 1))
        prim_flag = bool(kwargs.get("primitive", 1))
        target_flag = bool(kwargs.get("target", 0))
        textures = self._prepare_textures(x, colors, prim_pos, prim_rot,
                                          prim_gap)
        next_hit, _ = self._build_tracer(shape_flag, prim_flag, target_flag)
        o = jnp.asarray(o, jnp.float32)
        d = jnp.asarray(d, jnp.float32)
        alive = jnp.ones((o.shape[0],), bool)
        closest, normal, color, _ = jax.jit(next_hit)(textures, o, d, alive)
        return np.asarray(closest), np.asarray(normal), np.asarray(color)

    # ------------------------------------------------------------------
    def render_frame(self, x, colors, prim_pos, prim_rot, prim_gap, spp=None,
                     **kwargs):
        """Full multi-sample frame (reference render_frame :482-505).
        Returns (H, W, 3) float image in [0, ~1] (pre-clip)."""
        if spp is None:
            spp = self.spp
        shape_flag = bool(kwargs.get("shape", 1))
        prim_flag = bool(kwargs.get("primitive", 1))
        visualize_target = int(kwargs.get("target", 0))

        textures = self._prepare_textures(x, colors, prim_pos, prim_rot,
                                          prim_gap)
        W, H = self.image_res
        # blink semantics (reference render_frame :482-505): even sample
        # indices show the goal ghost when target is on
        n_ghost = (spp // 2) if visualize_target else 0
        n_plain = spp - n_ghost
        buf = np.zeros((W, H, 3), np.float32)
        # samples per pass: the march is worst-lane-bound, so wider passes
        # run more while_loop rounds at big frames, while small frames (64^2
        # visual obs) are launch-bound — one sample per pass for big frames,
        # batched for small ones. The lane cap was chosen before the H100
        # port and is not yet tuned on it; it changes the blocking, not the
        # image.
        default_lanes = W * H if W * H >= 256 * 256 else 262_144
        max_lanes = int(os.environ.get("PLB_RENDER_MAX_LANES", default_lanes))
        for tflag, n in ((False, n_plain), (True, n_ghost)):
            if n == 0:
                continue
            # samples per pass: largest divisor of n whose flattened ray
            # count stays under the lane cap (one compile per (flags, S))
            S = max(s for s in range(1, n + 1)
                    if n % s == 0 and s * W * H <= max_lanes)
            fkey = (shape_flag, prim_flag, tflag)
            if fkey not in self._render_many:
                self._render_many[fkey] = self._build_render_many(*fkey)
            self._key, sub = jax.random.split(self._key)
            buf += np.asarray(self._render_many[fkey](textures, sub, n, S))

        # tone map (reference copy :414-426)
        u = (np.arange(W, dtype=np.float32)[:, None] / W) - self.vignette_center[0]
        v = (np.arange(H, dtype=np.float32)[None, :] / H) - self.vignette_center[1]
        darken = 1.0 - self.vignette_strength * np.maximum(
            np.sqrt(u**2 + v**2) - self.vignette_radius, 0
        )
        img = np.sqrt(buf * darken[..., None] * EXPOSURE / spp)
        return img[:, ::-1].transpose(1, 0, 2)  # opencv orientation
