"""Batched 3x3 SVD with the reference's autodiff safeguards.

Forward: cyclic-Jacobi eigendecomposition of F^T F — pure elementwise /
tiny-matmul ops that vectorize over the particle batch (no
lax.while_loop, no LAPACK callback), sign convention det(U)=det(V)=+1 with a
possibly-negative smallest singular value (Taichi's ti.svd / McAdams
convention, so R = U V^T is always a proper rotation).

Backward: custom VJP implementing the eigenvalue-gap-clamped formula the
reference uses (plb/engine/mpm_simulator.py:97-115 `backward_svd`, clamp at
143-151) instead of jnp.linalg.svd's default VJP, which NaNs on repeated
singular values.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


# Physics needs full f32 multiply-accumulate: HIGHEST keeps XLA from
# running these 3x3 products in TF32 on the GPU.
from functools import partial as _partial
_einsum = _partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


__all__ = ["svd3"]

_N_SWEEPS = 6  # cyclic Jacobi sweeps; 3x3 converges quadratically


def _jacobi_rotation(a, v, p, q):
    """One batched Jacobi rotation zeroing a[(p,q)].

    `a` is a dict of the 6 unique components of the symmetric matrix keyed by
    (i<=j); `v` is a dict of the 9 eigenvector-matrix components. Explicit
    scalar-component updates keep the HLO purely elementwise (fast compile,
    one fusion) instead of batched 3x3 einsums.
    """
    r = 3 - p - q  # the untouched third index
    app, aqq, apq = a[(p, p)], a[(q, q)], a[(p, q)]
    # Rotation zeroing a_pq: tan(2t) = 2*apq/(aqq-app). Computed via the
    # algebraic half-angle identities (sqrt only — f32 atan2/sin/cos
    # approximations can be too coarse for the Jacobi sweeps to converge):
    #   cos(2t) = (aqq-app)/r, sin(2t) = 2*apq/r, r = hypot(...)
    #   c = sqrt((1+cos2t)/2) >= 0, s = sign(sin2t)*sqrt((1-cos2t)/2)
    y = 2.0 * apq
    z = aqq - app
    # Scale-invariant normalization: divide by max(|y|,|z|) BEFORE the hypot
    # so y^2+z^2 can never underflow to a denormal (which would misnormalize
    # cos2t/sin2t and yield a non-orthogonal rotation).
    m = jnp.maximum(jnp.abs(y), jnp.abs(z))
    ok = jnp.abs(y) > 0  # apq == 0 -> nothing to zero: identity rotation
    m_safe = jnp.where(m > 0, m, jnp.ones_like(m))
    ym = y / m_safe
    zm = z / m_safe
    rinv = jax.lax.rsqrt(jnp.maximum(ym * ym + zm * zm, 1e-30))
    cos2t = zm * rinv
    sin2t = ym * rinv
    # Stable half-angles: compute the larger of (c, s) from its sqrt form and
    # derive the other from sin2t = 2 c s — avoids the catastrophic
    # cancellation in sqrt((1 +/- cos2t)/2) when |cos2t| ~ 1.
    c_raw = jnp.sqrt(jnp.maximum((1.0 + cos2t) * 0.5, 1e-30))
    s_raw = jnp.sqrt(jnp.maximum((1.0 - cos2t) * 0.5, 1e-30))
    pos_branch = cos2t >= 0
    c = jnp.where(pos_branch, c_raw, jnp.abs(sin2t) * 0.5 / s_raw)
    s = jnp.where(pos_branch, sin2t * 0.5 / c_raw,
                  jnp.sign(sin2t) * s_raw)
    c = jnp.where(ok, c, jnp.ones_like(c))
    s = jnp.where(ok, s, jnp.zeros_like(s))
    cc, ss, cs = c * c, s * s, c * s

    apr = a[(min(p, r), max(p, r))]
    aqr = a[(min(q, r), max(q, r))]

    a = dict(a)
    a[(p, p)] = cc * app - 2.0 * cs * apq + ss * aqq
    a[(q, q)] = ss * app + 2.0 * cs * apq + cc * aqq
    a[(p, q)] = cs * (app - aqq) + (cc - ss) * apq
    a[(min(p, r), max(p, r))] = c * apr - s * aqr
    a[(min(q, r), max(q, r))] = s * apr + c * aqr

    v = dict(v)
    for i in range(3):
        vip, viq = v[(i, p)], v[(i, q)]
        v[(i, p)] = c * vip - s * viq
        v[(i, q)] = s * vip + c * viq
    return a, v


def _symm_eig3(A):
    """Eigendecomposition of symmetric (...,3,3) A -> (eigvals, eigvecs)."""
    a = {(i, j): A[..., i, j] for i in range(3) for j in range(3) if i <= j}
    one = jnp.ones(A.shape[:-2], A.dtype)
    zero = jnp.zeros(A.shape[:-2], A.dtype)
    v = {(i, j): (one if i == j else zero) for i in range(3) for j in range(3)}
    for _ in range(_N_SWEEPS):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            a, v = _jacobi_rotation(a, v, p, q)
    w = jnp.stack([a[(0, 0)], a[(1, 1)], a[(2, 2)]], axis=-1)
    V = jnp.stack(
        [jnp.stack([v[(i, j)] for j in range(3)], axis=-1) for i in range(3)],
        axis=-2,
    )
    return w, V


def _sort_desc(w, V):
    """Sort eigenpairs descending with a fixed 3-element sort network."""
    def cswap(w, V, i, j):
        swap = w[..., i] < w[..., j]
        wi = jnp.where(swap, w[..., j], w[..., i])
        wj = jnp.where(swap, w[..., i], w[..., j])
        vi = jnp.where(swap[..., None], V[..., :, j], V[..., :, i])
        vj = jnp.where(swap[..., None], V[..., :, i], V[..., :, j])
        w = w.at[..., i].set(wi).at[..., j].set(wj)
        V = V.at[..., :, i].set(vi).at[..., :, j].set(vj)
        return w, V

    w, V = cswap(w, V, 0, 1)
    w, V = cswap(w, V, 0, 2)
    w, V = cswap(w, V, 1, 2)
    return w, V


def _safe_normalize(v, fallback):
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    ok = n2 > 1e-16
    inv = jax.lax.rsqrt(jnp.where(ok, n2, jnp.ones_like(n2)))
    return jnp.where(ok, v * inv, fallback)


def _svd3_fwd_impl(F):
    A = _einsum("...ji,...jk->...ik", F, F)  # F^T F, symmetric PSD
    w, V = _symm_eig3(A)
    w, V = _sort_desc(w, V)

    # det(V) = +1: flip the last column if necessary. (Explicit triple
    # product — jnp.linalg.det lowers to LU, which is slow to compile.)
    detV = jnp.sum(
        jnp.cross(V[..., :, 0], V[..., :, 1]) * V[..., :, 2], axis=-1
    )
    V = V.at[..., :, 2].multiply(jnp.where(detV < 0, -1.0, 1.0)[..., None])

    FV = _einsum("...ij,...jk->...ik", F, V)  # columns ~ sigma_i * u_i
    batch = F.shape[:-2]
    e0 = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], F.dtype), batch + (3,))
    e1 = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], F.dtype), batch + (3,))
    e2 = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], F.dtype), batch + (3,))

    u0 = _safe_normalize(FV[..., :, 0], e0)
    # u1: Gram-Schmidt against u0, with an orthogonal fallback for rank<2 F.
    raw1 = FV[..., :, 1]
    raw1 = raw1 - jnp.sum(raw1 * u0, axis=-1, keepdims=True) * u0
    alt = jnp.where(jnp.abs(u0[..., 1:2]) < 0.9, e1, e2)
    alt = alt - jnp.sum(alt * u0, axis=-1, keepdims=True) * u0
    alt = _safe_normalize(alt, e1)
    u1 = _safe_normalize(raw1, alt)
    u2 = jnp.cross(u0, u1)  # det(U) = +1 by construction

    U = jnp.stack([u0, u1, u2], axis=-1)
    # Recover signed singular values: sigma_i = u_i . (F v_i). With
    # det(U)=det(V)=+1 the sign lands on the smallest one (McAdams).
    sig = _einsum("...ik,...ik->...k", FV, U)
    return U, sig, V


def _clamp_gap(a):
    """Reference `clamp` (mpm_simulator.py:143-151): keep |a| >= 1e-6."""
    return jnp.where(a >= 0, jnp.maximum(a, 1e-6), jnp.minimum(a, -1e-6))


# Backward eigengap handling. The reference hard-clamps the inverse gap at
# 1e-6 — adequate in its float64 sim, but in float32 the resulting ~1e6
# amplification of rounding noise at (near-)repeated singular values compounds
# exponentially through multi-step rollouts. 'damped' replaces 1/clamp(gap)
# with the Lorentzian gap/(gap^2 + eps^2): identical for well-separated
# singular values, bounded by 1/(2*eps) at degeneracy.
_GAP_MODE = "damped"     # "reference" | "damped" | "zero"
_GAP_EPS = 1e-3          # float32 damping
_GAP_EPS_F64 = 1e-6      # float64: matches the reference clamp scale


def set_vjp_gap_mode(mode: str, eps: float = 1e-2):
    """Configure the SVD backward's eigengap regularization (global; takes
    effect for traces compiled afterwards)."""
    global _GAP_MODE, _GAP_EPS
    assert mode in ("reference", "damped", "zero")
    _GAP_MODE = mode
    _GAP_EPS = eps


@jax.custom_vjp
def svd3(F):
    """Batched SVD of (...,3,3): returns (U, sigma(...,3), V)."""
    return _svd3_fwd_impl(F)


def _svd3_vjp_fwd(F):
    U, sig, V = _svd3_fwd_impl(F)
    return (U, sig, V), (U, sig, V)


def _svd3_vjp_bwd(res, cotangents):
    U, sig, V = res
    gU, gsig, gV = cotangents
    dtype = U.dtype

    s = sig * sig
    gap = s[..., None, :] - s[..., :, None]        # gap[i,j] = s_j - s_i
    if _GAP_MODE == "reference":
        Fm = 1.0 / _clamp_gap(gap)
    elif _GAP_MODE == "damped":
        eps = _GAP_EPS if dtype == jnp.float32 else _GAP_EPS_F64
        Fm = gap / (gap * gap + eps * eps)
    else:  # "zero": ablation — drop the U/V rotation terms entirely
        Fm = jnp.zeros_like(gap)
    eye = jnp.eye(3, dtype=dtype)
    Fm = Fm * (1.0 - eye)                           # zero the diagonal

    Ut = jnp.swapaxes(U, -1, -2)
    Vt = jnp.swapaxes(V, -1, -2)

    sigma_term = _einsum("...ij,...j,...jk->...ik", U, gsig, Vt)

    UtgU = _einsum("...ij,...jk->...ik", Ut, gU)
    inner_u = Fm * (UtgU - jnp.swapaxes(UtgU, -1, -2))
    u_term = _einsum("...ij,...jk,...k,...kl->...il", U, inner_u, sig, Vt)

    VtgV = _einsum("...ij,...jk->...ik", Vt, gV)
    inner_v = Fm * (VtgV - jnp.swapaxes(VtgV, -1, -2))
    v_term = _einsum("...ij,...j,...jk,...kl->...il", U, sig, inner_v, Vt)

    return (u_term + v_term + sigma_term,)


svd3.defvjp(_svd3_vjp_fwd, _svd3_vjp_bwd)
