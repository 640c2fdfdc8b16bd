"""Dense separable particle<->grid transfer (Khatri-Rao matmuls).

The reference scatters each particle's 27-tap APIC stencil with atomic adds
(plb/engine/mpm_simulator.py p2g :157-184). Here both transfers are dense
matmuls instead:

  The quadratic B-spline weight factorizes per axis, and the transferred
  momentum  p_mass*v + affine @ (cell - x)*dx  is affine-LINEAR in the cell
  coordinate. Hence the grid field is a sum of four Khatri-Rao (CP)
  contractions  G[a,b,c] = sum_p Wx[p,a] Wy[p,b] Wz[p,c] * S[p]  with one
  factor optionally index-weighted — each computable as (D*s x n) @ (n x D^2)
  dense matmuls. g2p and its moment sums (for APIC C) reuse the same factor
  matrices with the contraction transposed.

All of it runs on a D^3 crop of the grid that tracks the particle cloud
(`dynamic` integer offset, static crop size from the scene spec), since the
cloud occupies a small fraction of the 64^3 domain. D == n_grid disables
cropping. Everything is differentiable (matmul VJPs are matmuls — no scatter
appears in the backward pass either) and deterministic: no atomics, so two
runs sum in the same order.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp


# Matmul precision of every transfer contraction (this module and
# local_transfer). On the GPU, Precision.HIGH lets XLA run float32 matmuls
# in TF32 (10-bit mantissa), which rounds the very values the one-hot
# placement matmuls move; HIGHEST keeps full float32. Tolerance: after 1 and
# 19 substeps of Move-v1 at all ~10k particles, the max abs error of each of
# x, v, C and F against the float64 oracle (tests/oracle_mpm.py), divided
# by that field's largest magnitude, must stay <= TRANSFER_TOLERANCE — the
# state-fidelity target of BASELINE.json, taken relative to each field's
# scale because C reaches ~1e2 at contacts and float32 keeps ~7 digits of
# it. chip_smoke.py checks it on the card at both precisions
# (docs/PARITY.md, PERF.md).
TRANSFER_PRECISION = jax.lax.Precision.HIGHEST
TRANSFER_TOLERANCE = 1e-3


def _einsum(*args, **kwargs):
    return jnp.einsum(*args, precision=TRANSFER_PRECISION, **kwargs)


import numpy as np

from ..config.spec import SceneSpec

__all__ = ["crop_size", "AxisWeights", "axis_weights", "p2g_dense",
           "g2p_dense", "grid_m_dense"]


def crop_size(scene: SceneSpec) -> int:
    """Static crop edge length (cells, multiple of 8) covering the initial
    particle extent plus a motion margin; capped at the full grid."""
    G = scene.simulator.n_grid
    los, his = [], []
    for s in scene.shapes:
        c = np.asarray(s.init_pos, float)
        if s.shape == "box":
            w = s.width
            w = np.asarray([w] * 3 if np.isscalar(w) else w, float)
            half = np.linalg.norm(w) / 2  # conservative under rotation
        else:
            half = float(s.radius)
        los.append(c - half)
        his.append(c + half)
    if not los:
        return G
    # largest per-axis extent (the crop is cubic)
    extent = float(np.max(np.max(np.stack(his), axis=0) - np.min(np.stack(los), axis=0)))
    # The crop recenters on the cloud every substep, so the margin only has
    # to absorb growth of the cloud's EXTENT over an episode (stencil + 8
    # cells per side). Tasks that spread material wider fall back to D = G.
    cells = math.ceil(extent * G) + 3 + 16
    D = min(G, ((cells + 7) // 8) * 8)
    return int(D)


class AxisWeights(NamedTuple):
    """Per-axis dense spline weight factors on the crop."""

    Wx: jnp.ndarray   # (n, D) weight of particle p at local x-index a
    Wy: jnp.ndarray
    Wz: jnp.ndarray
    WxA: jnp.ndarray  # (n, D) a * Wx[p, a] — index-weighted factors
    WyB: jnp.ndarray
    WzC: jnp.ndarray
    off: jnp.ndarray  # (3,) int32 crop offset in global cells
    px: jnp.ndarray   # (n, 3) particle position in grid units (x * inv_dx)


def crop_offset(scene: SceneSpec, x: jnp.ndarray, D: int) -> jnp.ndarray:
    """(3,) int32 crop offset: center the crop on the cloud, clipped."""
    sim = scene.simulator
    base = jnp.floor(x * sim.inv_dx - 0.5).astype(jnp.int32)
    center = (jnp.min(base, axis=0) + jnp.max(base, axis=0)) // 2
    return jnp.clip(center - D // 2, 0, sim.n_grid - D)


def axis_weights(scene: SceneSpec, x: jnp.ndarray, D: int,
                 off: jnp.ndarray = None) -> AxisWeights:
    sim = scene.simulator
    G = sim.n_grid
    dtype = x.dtype
    px = x * sim.inv_dx
    base = jnp.floor(px - 0.5).astype(jnp.int32)  # (n,3) global base cell

    if off is None:
        off = crop_offset(scene, x, D)
    base_rel = jnp.clip(base - off[None, :], 0, D - 3)

    fx = px - base.astype(dtype)
    w = jnp.stack(
        [0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2],
        axis=1,
    )  # (n, 3tap, 3axis)

    cells = jax.lax.broadcasted_iota(jnp.int32, (1, D), 1)
    arange = cells.astype(dtype)

    def dense(axis):
        rel = cells - base_rel[:, axis : axis + 1]  # (n, D)
        W = (
            jnp.where(rel == 0, w[:, 0, axis : axis + 1], 0.0)
            + jnp.where(rel == 1, w[:, 1, axis : axis + 1], 0.0)
            + jnp.where(rel == 2, w[:, 2, axis : axis + 1], 0.0)
        )
        return W

    Wx, Wy, Wz = dense(0), dense(1), dense(2)
    return AxisWeights(
        Wx=Wx, Wy=Wy, Wz=Wz,
        WxA=Wx * arange, WyB=Wy * arange, WzC=Wz * arange,
        off=off, px=px,
    )


def _mm(u, kr, D):
    """(n, D, s) x (n, D^2) -> (D, s, D^2) -> (D, D, D, s)."""
    n, _, s = u.shape
    out = _einsum("pas,pq->asq", u, kr, preferred_element_type=u.dtype)
    return out.reshape(D, s, D, D).transpose(0, 2, 3, 1)


def kr_factors(aw: AxisWeights, D: int):
    """The three (n, D^2) Khatri-Rao (y,z) factor matrices — shared between
    p2g and g2p within a substep (compute once)."""
    n = aw.Wy.shape[0]
    KRyz = _einsum("pb,pc->pbc", aw.Wy, aw.Wz).reshape(n, D * D)
    KRyzB = _einsum("pb,pc->pbc", aw.WyB, aw.Wz).reshape(n, D * D)
    KRyzC = _einsum("pb,pc->pbc", aw.Wy, aw.WzC).reshape(n, D * D)
    return KRyz, KRyzB, KRyzC


# Above this many particles the dense transfers chunk internally: the
# (n, D^2) Khatri-Rao factors are the peak-memory term (25k x 64^2 f32 =
# 410 MB each), so big scenes stream particle blocks through the same
# matmuls with a bounded working set. Small scenes (every golden-tested
# config) take the one-shot path unchanged. Under vmap the chunk buffer
# gains the batch axis — batched sweeps can shrink it via the env var.
# The default was chosen before the H100 port and is not yet tuned on it;
# it changes how the work is blocked, not the result.
_DENSE_CHUNK = int(os.environ.get("PLB_DENSE_CHUNK", "12288"))


def _chunk_pad(a, n_pad):
    return jnp.concatenate(
        [a, jnp.zeros((n_pad - a.shape[0],) + a.shape[1:], a.dtype)], axis=0)


def _aw_block(aw: AxisWeights, sl):
    return AxisWeights(
        Wx=aw.Wx[sl], Wy=aw.Wy[sl], Wz=aw.Wz[sl],
        WxA=aw.WxA[sl], WyB=aw.WyB[sl], WzC=aw.WzC[sl],
        off=aw.off, px=aw.px[sl],
    )


def p2g_dense(scene: SceneSpec, aw: AxisWeights, v, affine, D: int, kr=None):
    """APIC momentum + mass transfer. Returns (grid_v (D^3,3), grid_m (D^3,))."""
    sim = scene.simulator
    dtype = v.dtype
    n = v.shape[0]

    if kr is None and n > _DENSE_CHUNK:
        # stream particle blocks; zero-padded weight rows contribute nothing
        P = _DENSE_CHUNK
        nc = (n + P - 1) // P
        n_pad = nc * P
        parts = [_chunk_pad(a, n_pad).reshape((nc, P) + a.shape[1:])
                 for a in (aw.Wx, aw.Wy, aw.Wz, aw.WxA, aw.WyB, aw.WzC,
                           aw.px, v, affine)]

        @jax.checkpoint  # recompute the chunk's KR factors in the backward
        def body(acc, blk):
            wx, wy, wz, wxa, wyb, wzc, px, vb, ab = blk
            awb = AxisWeights(Wx=wx, Wy=wy, Wz=wz, WxA=wxa, WyB=wyb,
                              WzC=wzc, off=aw.off, px=px)
            gv, gm = p2g_dense(scene, awb, vb, ab, D)
            return (acc[0] + gv, acc[1] + gm), None

        init = (jnp.zeros((D ** 3, 3), dtype), jnp.zeros((D ** 3,), dtype))
        (grid_v, grid_m), _ = jax.lax.scan(body, init, tuple(parts))
        return grid_v, grid_m

    # mom(cell) = A + a*Ba + b*Bb + c*Bc  (local cell indices a,b,c)
    # where  affine @ dpos = dx * affine @ (off + local - px)
    rel0 = aw.off.astype(dtype)[None, :] - aw.px  # (n, 3)
    A = sim.p_mass * v + sim.dx * _einsum("nij,nj->ni", affine, rel0)
    Ba = sim.dx * affine[:, :, 0]  # (n, 3)
    Bb = sim.dx * affine[:, :, 1]
    Bc = sim.dx * affine[:, :, 2]

    ones = jnp.full((n, 1), sim.p_mass, dtype)
    A4 = jnp.concatenate([A, ones], axis=-1)  # momentum + mass channels

    KRyz, KRyzB, KRyzC = kr if kr is not None else kr_factors(aw, D)

    U0 = _einsum("pa,ps->pas", aw.Wx, A4)
    G0 = _mm(U0, KRyz, D)  # (D,D,D,4)

    U1 = _einsum("pa,ps->pas", aw.WxA, Ba)
    U2 = _einsum("pa,ps->pas", aw.Wx, Bb)
    U3 = _einsum("pa,ps->pas", aw.Wx, Bc)
    G1 = _mm(U1, KRyz, D)
    G2 = _mm(U2, KRyzB, D)
    G3 = _mm(U3, KRyzC, D)

    grid_v = (G0[..., :3] + G1 + G2 + G3).reshape(D**3, 3)
    grid_m = G0[..., 3].reshape(D**3)
    return grid_v, grid_m


def g2p_dense(scene: SceneSpec, aw: AxisWeights, grid_v, D: int, kr=None):
    """Velocity gather + APIC C reconstruction.
    Returns (new_v (n,3), new_C (n,3,3))."""
    sim = scene.simulator
    dtype = grid_v.dtype
    n = aw.Wx.shape[0]

    if kr is None and n > _DENSE_CHUNK:
        P = _DENSE_CHUNK
        nc = (n + P - 1) // P
        n_pad = nc * P
        parts = tuple(
            _chunk_pad(a, n_pad).reshape((nc, P) + a.shape[1:])
            for a in (aw.Wx, aw.Wy, aw.Wz, aw.WxA, aw.WyB, aw.WzC, aw.px))

        @jax.checkpoint  # recompute the chunk's KR factors in the backward
        def body(_, blk):
            wx, wy, wz, wxa, wyb, wzc, px = blk
            awb = AxisWeights(Wx=wx, Wy=wy, Wz=wz, WxA=wxa, WyB=wyb,
                              WzC=wzc, off=aw.off, px=px)
            return None, g2p_dense(scene, awb, grid_v, D)

        _, (vs, Cs) = jax.lax.scan(body, None, parts)
        return (vs.reshape(n_pad, 3)[:n],
                Cs.reshape(n_pad, 3, 3)[:n])

    g = grid_v.reshape(D, D * D, 3)

    KRyz, KRyzB, KRyzC = kr if kr is not None else kr_factors(aw, D)

    # J[p, a, s] = sum_q KR[p, q] g[a, q, s]
    J = _einsum("pq,aqs->pas", KRyz, g, preferred_element_type=dtype)
    Jb = _einsum("pq,aqs->pas", KRyzB, g, preferred_element_type=dtype)
    Jc = _einsum("pq,aqs->pas", KRyzC, g, preferred_element_type=dtype)

    new_v = _einsum("pa,pas->ps", aw.Wx, J)
    # moments sum_w g * local_index along each axis
    Ma = _einsum("pa,pas->ps", aw.WxA, J)
    Mb = _einsum("pa,pas->ps", aw.Wx, Jb)
    Mc = _einsum("pa,pas->ps", aw.Wx, Jc)

    # dpos (grid units) = off + local - px  ->  C = 4*inv_dx*(M_axis outer)
    rel0 = aw.off.astype(dtype)[None, :] - aw.px  # (n, 3)
    moments = jnp.stack([Ma, Mb, Mc], axis=-1)  # (n, 3s, 3axis)
    new_C = 4.0 * sim.inv_dx * (
        moments + new_v[:, :, None] * rel0[:, None, :]
    )
    return new_v, new_C


def grid_m_dense(scene: SceneSpec, x, D: int = None):
    """Global (G^3,) grid mass via the dense transfer + a dynamic-slice
    paste (differentiable replacement for the scatter-based compute_grid_m)."""
    sim = scene.simulator
    G = sim.n_grid
    if D is None:
        D = G
    aw = axis_weights(scene, x, D)
    n = x.shape[0]

    def mass_block(awb):
        nb = awb.Wx.shape[0]
        KRyz = _einsum("pb,pc->pbc", awb.Wy, awb.Wz).reshape(nb, D * D)
        ones = jnp.full((nb, 1), sim.p_mass, x.dtype)
        U = _einsum("pa,ps->pas", awb.Wx, ones)
        return _mm(U, KRyz, D)[..., 0]  # (D,D,D)

    if n > _DENSE_CHUNK:
        P = _DENSE_CHUNK
        nc = (n + P - 1) // P
        n_pad = nc * P
        parts = tuple(
            _chunk_pad(a, n_pad).reshape((nc, P) + a.shape[1:])
            for a in (aw.Wx, aw.Wy, aw.Wz))

        @jax.checkpoint  # recompute the chunk's KR factor in the backward
        def body(acc, blk):
            wx, wy, wz = blk
            awb = AxisWeights(Wx=wx, Wy=wy, Wz=wz, WxA=wx, WyB=wy, WzC=wz,
                              off=aw.off, px=None)
            return acc + mass_block(awb), None

        Gm, _ = jax.lax.scan(body, jnp.zeros((D, D, D), x.dtype), parts)
    else:
        Gm = mass_block(aw)
    if D == G:
        return Gm.reshape(-1)
    full = jnp.zeros((G, G, G), x.dtype)
    full = jax.lax.dynamic_update_slice(full, Gm, tuple(aw.off))
    return full.reshape(-1)
