"""Locality-chunked particle<->grid transfer — the windowed MPM path.

The dense Khatri-Rao transfer (engine/transfer.py) contracts every particle
against the full D^3 crop: ~2*n*D^3 FLOPs per channel, ~28 GFLOP per
substep at Move-v1's D=40 crop. But each particle's quadratic B-spline
support is only 3^3 cells; this module recovers that sparsity with static
shapes:

  1. Once per env step, particles are sorted by their x-major raster cell
     index (a multi-operand `lax.sort`; gradients route through inverse
     sorts, see `sort_rows`/`unsort_rows`).
  2. Each chunk of P consecutive sorted particles is contracted against a
     per-chunk window of the crop of static shape (Lx, Ly, D): the x-sort
     bounds a chunk's x-extent to a couple of cells, Ly is sized from the
     scene's initial extent plus a margin, and z stays dense. The windowed
     Khatri-Rao matmuls cost (Lx/D * Ly/D) of the dense ones.
  3. Window tiles are combined into the D^3 crop with a scan of
     dynamic-slice adds (p2g) / sliced out of it (g2p) — both differentiable,
     transposes of each other.
  4. A per-substep `ok` flag (every chunk fits its window) guards the whole
     scheme: `mpm.substep` falls back to the dense transfer via `lax.cond`
     when material spreads beyond the windows, so the windows are a
     performance hint, never a correctness assumption.

Behavioral reference: plb/engine/mpm_simulator.py p2g :157-184 / g2p :223-243
(the same APIC/MLS-MPM transfer the dense path implements; golden-tested
against tests/oracle_mpm.py through mpm.substep).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config.spec import SceneSpec
from .transfer import _einsum  # the transfers' one matmul precision

__all__ = [
    "LocalPlan", "plan_for", "enabled", "sort_keys", "sort_rows",
    "unsort_rows", "chunk_offsets", "p2g_local", "g2p_local",
]


# ---------------------------------------------------------------------------
# static plan
# ---------------------------------------------------------------------------

class LocalPlan(NamedTuple):
    """Static chunking geometry, derived once per scene."""

    P: int    # particles per chunk (multiple of 128)
    Lx: int   # window cells along the sorted axis
    Ly: int   # window cells along y
    # z stays dense: Lz == D


def plan_for(scene: SceneSpec, D: int) -> LocalPlan:
    """Default plan: window only along x (the sorted axis), y and z dense.
    The x-sort bounds chunk x-extents to a couple of cells, so Lx = 8 holds
    a wide margin; full-depth y/z keep the fallback check x-only.

    P in [128, 512] in multiples of 128 and Lx = 8 were chosen before the
    H100 port and are not yet tuned on it; they change how the work is
    blocked, not the results."""
    n = scene.simulator.n_particles
    P = max(128, min(512, ((n + 127) // 128) * 128))
    return LocalPlan(P=P, Lx=8, Ly=D)


def enabled(scene: SceneSpec, D: int) -> bool:
    """Static gate: windows only pay off when the crop is big enough for the
    Lx/D saving to beat the chunking overhead. SimulatorSpec.transfer ==
    "dense" turns them off (batched callers: under vmap the dense fallback's
    `lax.cond` becomes a select that runs both transfers)."""
    return (scene.simulator.transfer != "dense" and D >= 32
            and scene.simulator.n_particles >= 64)


# ---------------------------------------------------------------------------
# sorting (differentiable permutation via paired sorts)
# ---------------------------------------------------------------------------

def sort_keys(scene: SceneSpec, x) -> jnp.ndarray:
    """x-major raster cell key of each particle's base cell, (n,) int32."""
    sim = scene.simulator
    G = sim.n_grid
    base = jnp.clip(
        jnp.floor(x * sim.inv_dx - 0.5).astype(jnp.int32), 0, G - 1
    )
    return (base[:, 0] * G + base[:, 1]) * G + base[:, 2]


def _sort_tree_by_key(key, tree):
    """Sort the rows of every (n, ...) leaf by integer `key` (stable), as
    one multi-operand lax.sort."""
    leaves, treedef = jax.tree.flatten(tree)
    cols, counts = [], []
    for leaf in leaves:
        flat = leaf.reshape(leaf.shape[0], -1)
        counts.append(flat.shape[1])
        cols.extend(flat[:, i] for i in range(flat.shape[1]))
    out = jax.lax.sort((key, *cols), dimension=0, is_stable=True, num_keys=1)
    sorted_cols = list(out[1:])
    rebuilt, k = [], 0
    for leaf, c in zip(leaves, counts):
        rebuilt.append(jnp.stack(sorted_cols[k : k + c], axis=1).reshape(leaf.shape))
        k += c
    return jax.tree.unflatten(treedef, rebuilt)


@jax.custom_vjp
def _permute(fwd_key, bwd_key, tree):
    return _sort_tree_by_key(fwd_key, tree)


def _permute_fwd(fwd_key, bwd_key, tree):
    return _sort_tree_by_key(fwd_key, tree), (fwd_key, bwd_key)


def _permute_bwd(res, ct):
    fwd_key, bwd_key = res
    zf = np.zeros(fwd_key.shape, jax.dtypes.float0)
    zb = np.zeros(bwd_key.shape, jax.dtypes.float0)
    return zf, zb, _sort_tree_by_key(bwd_key, ct)


_permute.defvjp(_permute_fwd, _permute_bwd)


def sort_rows(key, tree):
    """Sort the rows of `tree` by `key`. Returns (sorted_tree, order, rank):
    order[i] = original index of sorted row i; rank = inverse of order.
    Gradients flow through the permutation exactly (inverse sort)."""
    n = key.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    _, order = jax.lax.sort((key, iota), dimension=0, is_stable=True, num_keys=1)
    _, rank = jax.lax.sort((order, iota), dimension=0, is_stable=True, num_keys=1)
    return _permute(key, order, tree), order, rank


def unsort_rows(order, rank, tree):
    """Invert sort_rows: rows back to their original positions."""
    return _permute(order, rank, tree)


# ---------------------------------------------------------------------------
# chunk windows
# ---------------------------------------------------------------------------

class ChunkCtx(NamedTuple):
    offs: jnp.ndarray  # (NC, 3) int32 window origin per chunk (global cells)
    ok: jnp.ndarray    # () bool — every chunk fits its (Lx, Ly, D) window


def _pad_rows(a, n_pad):
    """Pad (n, ...) to (n_pad, ...) replicating the last row (keeps padded
    particles inside the cloud's cells so they never widen a window)."""
    n = a.shape[0]
    if n_pad == n:
        return a
    pad = jnp.broadcast_to(a[n - 1 : n], (n_pad - n,) + a.shape[1:])
    return jnp.concatenate([a, pad], axis=0)


def chunk_offsets(scene: SceneSpec, plan: LocalPlan, x, off, D: int) -> ChunkCtx:
    """Window origins: per chunk, the min base cell, clipped so the window
    stays inside the crop. ok iff every chunk's support fits its window."""
    sim = scene.simulator
    P = plan.P
    n = x.shape[0]
    n_pad = ((n + P - 1) // P) * P
    base = jnp.floor(_pad_rows(x, n_pad) * sim.inv_dx - 0.5).astype(jnp.int32)
    bases = base.reshape(-1, P, 3)
    mn = jnp.min(bases, axis=1)  # (NC, 3)
    mx = jnp.max(bases, axis=1)
    ext = mx - mn
    ok = jnp.all(ext[:, 0] <= plan.Lx - 3)
    if plan.Ly < D:  # y windowed too (non-default plans)
        ok = jnp.logical_and(ok, jnp.all(ext[:, 1] <= plan.Ly - 3))
    lims = jnp.asarray([D - plan.Lx, D - plan.Ly, 0], jnp.int32)
    offs = off[None, :] + jnp.clip(mn - off[None, :], 0, lims[None, :])
    return ChunkCtx(offs=offs, ok=ok)


# ---------------------------------------------------------------------------
# windowed weights
# ---------------------------------------------------------------------------

def _window_weights(px_axis, off_axis, L, dtype):
    """Dense spline weights on an L-cell window: (NC, P, L) from grid-unit
    positions px_axis (NC, P) and window origins off_axis (NC,) int32.
    Same 3-tap quadratic B-spline + clamp as transfer.axis_weights."""
    base = jnp.floor(px_axis - 0.5).astype(jnp.int32)
    rel = jnp.clip(base - off_axis[:, None], 0, L - 3)
    fx = px_axis - base.astype(dtype)
    w0 = 0.5 * (1.5 - fx) ** 2
    w1 = 0.75 - (fx - 1.0) ** 2
    w2 = 0.5 * (fx - 0.5) ** 2
    cells = jax.lax.broadcasted_iota(jnp.int32, (1, 1, L), 2)
    r = cells - rel[:, :, None]  # (NC, P, L)
    W = (
        jnp.where(r == 0, w0[:, :, None], 0.0)
        + jnp.where(r == 1, w1[:, :, None], 0.0)
        + jnp.where(r == 2, w2[:, :, None], 0.0)
    )
    return W.astype(dtype)


class _Factors(NamedTuple):
    Wx: jnp.ndarray   # (NC, P, Lx)
    WxA: jnp.ndarray
    KR: jnp.ndarray   # (NC, P, Ly*D)
    KRb: jnp.ndarray  # y-index-weighted
    KRc: jnp.ndarray  # z-index-weighted
    rel0: jnp.ndarray  # (NC, P, 3) offs - px (window-local position origin)
    mask: jnp.ndarray  # (NC, P) 1.0 for real particles


def _factors(scene: SceneSpec, plan: LocalPlan, x, offs, D: int, n: int):
    sim = scene.simulator
    dtype = x.dtype
    P = plan.P
    n_pad = ((n + P - 1) // P) * P
    xp = _pad_rows(x, n_pad).reshape(-1, P, 3)
    px = xp * sim.inv_dx  # (NC, P, 3)

    Wx = _window_weights(px[..., 0], offs[:, 0], plan.Lx, dtype)
    Wy = _window_weights(px[..., 1], offs[:, 1], plan.Ly, dtype)
    Wz = _window_weights(px[..., 2], offs[:, 2], D, dtype)

    ax = jax.lax.broadcasted_iota(jnp.int32, (1, 1, plan.Lx), 2).astype(dtype)
    ay = jax.lax.broadcasted_iota(jnp.int32, (1, 1, plan.Ly), 2).astype(dtype)
    az = jax.lax.broadcasted_iota(jnp.int32, (1, 1, D), 2).astype(dtype)

    NC = xp.shape[0]
    KR = _einsum("kpb,kpc->kpbc", Wy, Wz).reshape(NC, P, plan.Ly * D)
    KRb = _einsum("kpb,kpc->kpbc", Wy * ay, Wz).reshape(NC, P, plan.Ly * D)
    KRc = _einsum("kpb,kpc->kpbc", Wy, Wz * az).reshape(NC, P, plan.Ly * D)

    rel0 = offs.astype(dtype)[:, None, :] - px
    mask = (
        jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0).reshape(-1, P) < n
    ).astype(dtype)
    return _Factors(Wx=Wx, WxA=Wx * ax, KR=KR, KRb=KRb, KRc=KRc,
                    rel0=rel0, mask=mask)


# ---------------------------------------------------------------------------
# tile combine / extract
# ---------------------------------------------------------------------------

def _scatter_tiles(tiles, rel_offs, D: int):
    """Sum (NC, Lx, Ly*D->reshaped) window tiles into a (D, D, D, s) crop via
    a scan of dynamic-slice adds (differentiable; its VJP is _gather_tiles)."""
    NC, Lx, Ly, Lz, s = tiles.shape
    crop0 = jnp.zeros((D, D, D, s), tiles.dtype)

    def body(crop, inp):
        tile, o = inp
        idx = (o[0], o[1], o[2], jnp.int32(0))
        cur = jax.lax.dynamic_slice(crop, idx, (Lx, Ly, Lz, s))
        return jax.lax.dynamic_update_slice(crop, cur + tile, idx), None

    crop, _ = jax.lax.scan(body, crop0, (tiles, rel_offs))
    return crop


def _gather_tiles(grid, rel_offs, Lx: int, Ly: int, Lz: int):
    """Extract (NC, Lx, Ly, Lz, s) windows from a (D, D, D, s) crop."""
    s = grid.shape[-1]

    def one(o):
        return jax.lax.dynamic_slice(
            grid, (o[0], o[1], o[2], jnp.int32(0)), (Lx, Ly, Lz, s)
        )

    return jax.vmap(one)(rel_offs)


# ---------------------------------------------------------------------------
# the transfers
# ---------------------------------------------------------------------------

def p2g_local(scene: SceneSpec, plan: LocalPlan, x, v, affine,
              ctx: ChunkCtx, off, D: int):
    """APIC momentum + mass transfer on per-chunk windows.
    Returns (grid_v (D^3, 3), grid_m (D^3,)) on the crop — identical math to
    transfer.p2g_dense (reference p2g, mpm_simulator.py:157-184)."""
    sim = scene.simulator
    dtype = x.dtype
    n = x.shape[0]
    P = plan.P
    n_pad = ((n + P - 1) // P) * P
    f = _factors(scene, plan, x, ctx.offs, D, n)

    vp = _pad_rows(v, n_pad).reshape(-1, P, 3)
    affp = _pad_rows(affine, n_pad).reshape(-1, P, 3, 3)

    # mom(cell) = A + a*Ba + b*Bb + c*Bc in window-local indices (a, b, c)
    A = sim.p_mass * vp + sim.dx * _einsum("kpij,kpj->kpi", affp, f.rel0)
    m1 = jnp.broadcast_to(
        jnp.asarray(sim.p_mass, dtype), f.mask.shape + (1,)
    )
    A4 = jnp.concatenate([A, m1], axis=-1) * f.mask[..., None]  # (NC, P, 4)
    Ba = sim.dx * affp[..., 0] * f.mask[..., None]
    Bb = sim.dx * affp[..., 1] * f.mask[..., None]
    Bc = sim.dx * affp[..., 2] * f.mask[..., None]

    def mm(Wrow, ch, KRm):
        U = _einsum("kpa,kps->kpas", Wrow, ch)
        return _einsum("kpas,kpq->kasq", U, KRm)  # (NC, Lx, s, Ly*D)

    G0 = mm(f.Wx, A4, f.KR)
    G1 = mm(f.WxA, Ba, f.KR)
    G2 = mm(f.Wx, Bb, f.KRb)
    G3 = mm(f.Wx, Bc, f.KRc)

    mom = G0[:, :, :3] + G1 + G2 + G3                      # (NC, Lx, 3, LyD)
    tiles = jnp.concatenate([mom, G0[:, :, 3:4]], axis=2)  # (NC, Lx, 4, LyD)
    NC = tiles.shape[0]
    tiles = tiles.transpose(0, 1, 3, 2).reshape(NC, plan.Lx, plan.Ly, D, 4)

    crop = _scatter_tiles(tiles, ctx.offs - off[None, :], D)
    return crop[..., :3].reshape(D**3, 3), crop[..., 3].reshape(D**3)


def g2p_local(scene: SceneSpec, plan: LocalPlan, x, grid_v,
              ctx: ChunkCtx, off, D: int):
    """Velocity gather + APIC C reconstruction on per-chunk windows.
    Returns (new_v (n, 3), new_C (n, 3, 3)) — identical math to
    transfer.g2p_dense (reference g2p, mpm_simulator.py:223-243)."""
    sim = scene.simulator
    n = x.shape[0]
    f = _factors(scene, plan, x, ctx.offs, D, n)
    NC = f.KR.shape[0]

    g_tiles = _gather_tiles(
        grid_v.reshape(D, D, D, 3), ctx.offs - off[None, :],
        plan.Lx, plan.Ly, D,
    )  # (NC, Lx, Ly, D, 3)
    g = g_tiles.reshape(NC, plan.Lx, plan.Ly * D, 3)

    J = _einsum("kpq,kaqs->kpas", f.KR, g)
    Jb = _einsum("kpq,kaqs->kpas", f.KRb, g)
    Jc = _einsum("kpq,kaqs->kpas", f.KRc, g)

    new_v = _einsum("kpa,kpas->kps", f.Wx, J)
    Ma = _einsum("kpa,kpas->kps", f.WxA, J)
    Mb = _einsum("kpa,kpas->kps", f.Wx, Jb)
    Mc = _einsum("kpa,kpas->kps", f.Wx, Jc)

    moments = jnp.stack([Ma, Mb, Mc], axis=-1)  # (NC, P, 3s, 3axis)
    new_C = 4.0 * sim.inv_dx * (
        moments + new_v[..., None] * f.rel0[:, :, None, :]
    )
    P = plan.P
    return (
        new_v.reshape(-1, 3)[:n],
        new_C.reshape(-1, 3, 3)[:n],
    )
