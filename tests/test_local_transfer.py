"""Locality-chunked transfer vs the dense transfer (the same math on
windows), the differentiable sort machinery, and the dense fallback."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plasticinelab_tpu.config.spec import SceneSpec, ShapeSpec, SimulatorSpec
from plasticinelab_tpu.engine import local_transfer as lt
from plasticinelab_tpu.engine.transfer import (
    axis_weights, crop_offset, g2p_dense, p2g_dense,
)


def _scene(n=300, quality=1.0):
    sim = SimulatorSpec(quality=quality, n_particles=n, dtype="float64")
    shapes = (ShapeSpec(shape="box", init_pos=(0.5, 0.3, 0.5), width=0.12),)
    return SceneSpec(simulator=sim, shapes=shapes)


def _cloud(scene, seed=0, width=0.06, center=(0.5, 0.3, 0.5)):
    # width 0.06 ~ 4 cells at G=64: small particle counts put the whole
    # cloud in one chunk, so its x-extent must fit the Lx=8 window
    rng = np.random.default_rng(seed)
    n = scene.simulator.n_particles
    x = rng.random((n, 3)) * width + (np.asarray(center) - width / 2)
    v = rng.standard_normal((n, 3)) * 0.2
    affine = rng.standard_normal((n, 3, 3)) * 0.3
    return jnp.asarray(x), jnp.asarray(v), jnp.asarray(affine)


def _sorted(scene, x, v, affine):
    key = lt.sort_keys(scene, x)
    (x, v, affine), order, rank = lt.sort_rows(key, (x, v, affine))
    return x, v, affine


def test_p2g_g2p_match_dense():
    scene = _scene()
    D = 40
    x, v, affine = _sorted(scene, *_cloud(scene))
    off = crop_offset(scene, x, D)
    plan = lt.plan_for(scene, D)
    ctx = lt.chunk_offsets(scene, plan, x, off, D)
    assert bool(ctx.ok), "tight cloud must fit the windows"

    gv_l, gm_l = lt.p2g_local(scene, plan, x, v, affine, ctx, off, D)
    aw = axis_weights(scene, x, D, off=off)
    gv_d, gm_d = p2g_dense(scene, aw, v, affine, D)
    np.testing.assert_allclose(np.asarray(gv_l), np.asarray(gv_d), atol=1e-12)
    np.testing.assert_allclose(np.asarray(gm_l), np.asarray(gm_d), atol=1e-12)

    grid_v = jnp.asarray(
        np.random.default_rng(1).standard_normal(gv_d.shape) * 0.1
    )
    nv_l, nC_l = lt.g2p_local(scene, plan, x, grid_v, ctx, off, D)
    nv_d, nC_d = g2p_dense(scene, aw, grid_v, D)
    np.testing.assert_allclose(np.asarray(nv_l), np.asarray(nv_d), atol=1e-12)
    np.testing.assert_allclose(np.asarray(nC_l), np.asarray(nC_d), atol=1e-11)


@pytest.mark.slow
def test_p2g_gradients_match_dense():
    scene = _scene(n=150)
    D = 40
    x, v, affine = _sorted(scene, *_cloud(scene, seed=2))
    off = crop_offset(scene, x, D)
    plan = lt.plan_for(scene, D)
    ctx = lt.chunk_offsets(scene, plan, x, off, D)
    w = jnp.asarray(
        np.random.default_rng(3).standard_normal((D**3, 3)) * 1e-3
    )

    def loss_local(x, v, a):
        gv, gm = lt.p2g_local(scene, plan, x, v, a, ctx, off, D)
        return jnp.sum(gv * w) + jnp.sum(gm**2)

    def loss_dense(x, v, a):
        aw = axis_weights(scene, x, D, off=off)
        gv, gm = p2g_dense(scene, aw, v, a, D)
        return jnp.sum(gv * w) + jnp.sum(gm**2)

    gl = jax.grad(loss_local, argnums=(0, 1, 2))(x, v, affine)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2))(x, v, affine)
    for a, b in zip(gl, gd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)


def test_sort_roundtrip_and_gradient():
    scene = _scene(n=200)
    x, v, _ = _cloud(scene, seed=4)
    key = lt.sort_keys(scene, x)
    (xs, vs), order, rank = lt.sort_rows(key, (x, v))
    # sorted keys are ascending
    ks = lt.sort_keys(scene, xs)
    assert bool(jnp.all(ks[1:] >= ks[:-1]))
    xb, vb = lt.unsort_rows(order, rank, (xs, vs))
    np.testing.assert_array_equal(np.asarray(xb), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(vb), np.asarray(v))

    # gradient through sort+unsort is the identity map on cotangents
    w = jnp.asarray(np.random.default_rng(5).standard_normal(x.shape))

    def f(x):
        key = jax.lax.stop_gradient(lt.sort_keys(scene, x))
        (xs,), order, rank = lt.sort_rows(key, (x,))
        (xb,) = lt.unsort_rows(order, rank, (xs,))
        return jnp.sum(xb * w)

    g = jax.grad(f)(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-15)

    def f_sorted_only(x):
        key = jax.lax.stop_gradient(lt.sort_keys(scene, x))
        (xs,), order, rank = lt.sort_rows(key, (x,))
        return jnp.sum(xs * jnp.take(w, order, axis=0))

    g2 = jax.grad(f_sorted_only)(x)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(w), atol=1e-15)


def test_fallback_flag_trips_on_wide_clouds():
    scene = _scene(n=256)
    D = 64  # full grid
    rng = np.random.default_rng(6)
    # particles scattered over most of the domain, unsorted -> chunks span
    # far more than any window
    x = jnp.asarray(rng.random((256, 3)) * 0.8 + 0.1)
    off = crop_offset(scene, x, D)
    plan = lt.plan_for(scene, D)
    ctx = lt.chunk_offsets(scene, plan, x, off, D)
    assert not bool(ctx.ok)


def test_substep_local_matches_dense_fallback():
    """mpm.substep through the cond: force ok True/False by particle layout
    and check both arms agree with a direct dense computation."""
    from plasticinelab_tpu.engine import mpm
    from plasticinelab_tpu.engine.state import Controls, Materials, SimState

    scene = _scene(n=200)
    x, v, affine = _cloud(scene, seed=7)
    C = jnp.asarray(
        np.random.default_rng(8).standard_normal((200, 3, 3)) * 0.1
    )
    F = jnp.eye(3)[None] + jnp.asarray(
        np.random.default_rng(9).standard_normal((200, 3, 3)) * 0.02
    )
    mats = Materials(
        mu=jnp.asarray(scene.simulator.mu_0),
        lam=jnp.asarray(scene.simulator.lam_0),
        yield_stress=jnp.asarray(scene.simulator.yield_stress),
    )
    z3 = jnp.zeros((0, 3))
    state = SimState(x=x, v=v, C=C, F=F, prim_pos=z3,
                     prim_rot=jnp.zeros((0, 4)), prim_gap=jnp.zeros((0,)))
    ctrl = Controls(v=z3, w=z3, gap_vel=jnp.zeros((0,)))

    # local path (sorted, tight cloud -> ok=True)
    key = lt.sort_keys(scene, state.x)
    (xs, vs, Cs, Fs), order, rank = lt.sort_rows(
        key, (state.x, state.v, state.C, state.F)
    )
    s_sorted = state._replace(x=xs, v=vs, C=Cs, F=Fs)
    out_local = mpm.substep(scene, mats, s_sorted, ctrl, 666.0)

    # dense reference on the same sorted state via a scene with local
    # chunking disabled (full-grid crop, tiny particle count gate)
    D = mpm.crop_size(scene)
    plan = lt.plan_for(scene, D)
    off = crop_offset(scene, s_sorted.x, D)
    ctx = lt.chunk_offsets(scene, plan, s_sorted.x, off, D)
    assert bool(ctx.ok)

    new_F, aff = mpm.stress_affine(scene, mats, s_sorted.C, s_sorted.F)
    aw = axis_weights(scene, s_sorted.x, D, off=off)
    gv, gm = p2g_dense(scene, aw, s_sorted.v, aff, D)
    gv_out = mpm.grid_op(
        scene, gv, gm, (s_sorted.prim_pos, s_sorted.prim_rot, s_sorted.prim_gap),
        (s_sorted.prim_pos, s_sorted.prim_rot, s_sorted.prim_gap),
        jnp.asarray(666.0), D, off,
    )
    nv, nC = g2p_dense(scene, aw, gv_out, D)
    nx = jnp.clip(s_sorted.x + scene.simulator.dt * nv,
                  0.0, 1.0 - 3 * scene.simulator.dx)

    np.testing.assert_allclose(np.asarray(out_local.x), np.asarray(nx), atol=1e-12)
    np.testing.assert_allclose(np.asarray(out_local.v), np.asarray(nv), atol=1e-12)
    np.testing.assert_allclose(np.asarray(out_local.C), np.asarray(nC), atol=1e-11)
    np.testing.assert_allclose(np.asarray(out_local.F), np.asarray(new_F), atol=1e-12)


def _transfer_fns(scene, D, x):
    """(windowed, dense) pairs of p2g / g2p / mass on the same crop."""
    plan = lt.plan_for(scene, D)
    off = crop_offset(scene, x, D)
    ctx = lt.chunk_offsets(scene, plan, x, off, D)
    assert bool(ctx.ok)

    def dense_aw(x):
        return axis_weights(scene, x, D, off=off)

    return {
        "p2g": (lambda x, v, a: lt.p2g_local(scene, plan, x, v, a, ctx, off, D),
                lambda x, v, a: p2g_dense(scene, dense_aw(x), v, a, D)),
        "g2p": (lambda x, g: lt.g2p_local(scene, plan, x, g, ctx, off, D),
                lambda x, g: g2p_dense(scene, dense_aw(x), g, D)),
        "mass": (lambda x: lt.p2g_local(scene, plan, x, jnp.zeros_like(x),
                                        jnp.zeros(x.shape + (3,), x.dtype),
                                        ctx, off, D)[1],
                 lambda x: p2g_dense(scene, dense_aw(x), jnp.zeros_like(x),
                                     jnp.zeros(x.shape + (3,), x.dtype),
                                     D)[1]),
    }


@pytest.mark.parametrize("mode", ["fwd", "vjp"])
@pytest.mark.parametrize("op", ["p2g", "g2p", "mass"])
def test_windowed_matches_dense(op, mode):
    """Windowed p2g / g2p / mass equal the dense transfer, forward and VJP
    (cotangents w.r.t. every input, positions included)."""
    scene = _scene(n=150)
    D = 24
    x, v, affine = _sorted(scene, *_cloud(scene, seed=10))
    rng = np.random.default_rng(11)
    grid_v = jnp.asarray(rng.standard_normal((D ** 3, 3)) * 0.1)
    args = {"p2g": (x, v, affine), "g2p": (x, grid_v), "mass": (x,)}[op]
    win, den = _transfer_fns(scene, D, x)[op]

    out_w, vjp_w = jax.vjp(win, *args)
    out_d, vjp_d = jax.vjp(den, *args)
    if mode == "fwd":
        for a, b in zip(jax.tree.leaves(out_w), jax.tree.leaves(out_d)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-11)
        return
    ct = jax.tree.map(
        lambda o: jnp.asarray(rng.standard_normal(o.shape)), out_d)
    for a, b in zip(vjp_w(ct), vjp_d(ct)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)
