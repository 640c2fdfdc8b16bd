"""Component-major primitive math vs the (..., 3) reference implementation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plasticinelab_tpu.config.spec import PrimitiveSpec
from plasticinelab_tpu.engine import primitives as pr
from plasticinelab_tpu.engine import primitives_cm as pcm

SPECS = [
    PrimitiveSpec(shape="Sphere", radius=0.08, init_pos=(0.4, 0.4, 0.5)),
    PrimitiveSpec(shape="Capsule", h=0.12, r=0.03, init_pos=(0.5, 0.4, 0.5)),
    PrimitiveSpec(shape="RollingPin", h=0.3, r=0.04, init_pos=(0.5, 0.5, 0.5)),
    PrimitiveSpec(shape="Chopsticks", h=0.2, r=0.02, init_gap=0.06,
                  init_pos=(0.5, 0.45, 0.5)),
    PrimitiveSpec(shape="Cylinder", h=0.05, r=0.1, init_pos=(0.5, 0.3, 0.5)),
    PrimitiveSpec(shape="Torus", tx=0.1, ty=0.03, init_pos=(0.5, 0.35, 0.5)),
    PrimitiveSpec(shape="Box", size=(0.05, 0.08, 0.06), init_pos=(0.5, 0.3, 0.5)),
]


def _pose(seed):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.random(3) * 0.4 + 0.3)
    q = rng.standard_normal(4)
    rot = jnp.asarray(q / np.linalg.norm(q))
    gap = jnp.asarray(0.06)
    return pos, rot, gap


def _points(seed, n=500):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.random((n, 3)))


@pytest.mark.parametrize("spec", SPECS, ids=[s.shape for s in SPECS])
def test_sdf_normal_match(spec):
    pos, rot, gap = _pose(1)
    p = _points(2)
    pt = (p[:, 0], p[:, 1], p[:, 2])

    d_ref = pr.sdf(spec, pos, rot, gap, p)
    d_cm = pcm.sdf_cm(spec, pos, rot, gap, pt)
    np.testing.assert_allclose(np.asarray(d_cm), np.asarray(d_ref), atol=1e-13)

    n_ref = pr.normal(spec, pos, rot, gap, p)
    n_cm = jnp.stack(pcm.normal_cm(spec, pos, rot, gap, pt), axis=-1)
    np.testing.assert_allclose(np.asarray(n_cm), np.asarray(n_ref), atol=1e-12)


@pytest.mark.parametrize("spec", SPECS, ids=[s.shape for s in SPECS])
def test_collide_match(spec):
    pos, rot, gap = _pose(3)
    pos1 = pos + jnp.asarray([1e-3, -5e-4, 2e-4])
    q = np.random.default_rng(4).standard_normal(4) * 0.01 + np.asarray(rot)
    rot1 = jnp.asarray(q / np.linalg.norm(q))
    p = _points(5)
    v = _points(6) - 0.5
    dt = 1e-4
    fric = jnp.asarray(0.9)
    soft = jnp.asarray(666.0)

    v_ref = pr.collide(spec, pos, rot, gap, pos1, rot1, fric, soft, p, v, dt)
    vt = pcm.collide_cm(spec, pos, rot, gap, pos1, rot1, fric, soft,
                        (p[:, 0], p[:, 1], p[:, 2]),
                        (v[:, 0], v[:, 1], v[:, 2]), dt)
    v_cm = jnp.stack(vt, axis=-1)
    np.testing.assert_allclose(np.asarray(v_cm), np.asarray(v_ref), atol=1e-10)


@pytest.mark.parametrize("ground_friction", [0.0, 1.5, 20.0])
def test_grid_op_cm_matches_grid_op(ground_friction):
    from plasticinelab_tpu.config.spec import SceneSpec, SimulatorSpec
    from plasticinelab_tpu.engine import mpm

    sim = SimulatorSpec(quality=0.5, n_particles=64,
                        ground_friction=ground_friction, dtype="float64")
    prims = (
        PrimitiveSpec(shape="Sphere", radius=0.08, init_pos=(0.38, 0.42, 0.5),
                      friction=0.9),
        PrimitiveSpec(shape="Capsule", h=0.1, r=0.03, init_pos=(0.55, 0.4, 0.5),
                      friction=0.5),
    )
    scene = SceneSpec(simulator=sim, primitives=prims)
    D = 24
    rng = np.random.default_rng(7)
    gv = jnp.asarray(rng.standard_normal((D**3, 3)) * 1e-4)
    gm = jnp.asarray(np.abs(rng.standard_normal(D**3)) * 1e-4)
    gm = jnp.where(jnp.asarray(rng.random(D**3) < 0.3), 0.0, gm)
    off = jnp.asarray([2, 1, 3], jnp.int32)
    k = len(prims)
    pos = jnp.asarray([p.init_pos for p in prims])
    rot = jnp.asarray([p.init_rot for p in prims])
    gapv = jnp.zeros((k,))
    pose = (pos, rot, gapv)
    pos1 = pos + 1e-3
    pose1 = (pos1, rot, gapv)
    soft = jnp.asarray(666.0)

    v_ref = mpm.grid_op(scene, gv, gm, pose, pose1, soft, D, off)
    grid4 = jnp.concatenate([gv.T, gm[None]], axis=0)
    v_cm = mpm.grid_op_cm(scene, grid4, pose, pose1, soft, D, off)
    np.testing.assert_allclose(np.asarray(v_cm.T), np.asarray(v_ref), atol=1e-12)


@pytest.mark.parametrize("mode", ["fwd", "vjp"])
def test_grid_op_cm_matches_grid_op_move_v1(mode):
    """Move-v1's two sphere manipulators in contact with a random crop:
    the channel-major grid update equals grid_op, forward and VJP (grid and
    pose cotangents)."""
    import dataclasses

    import os

    from plasticinelab_tpu.config.loader import load_scene
    from plasticinelab_tpu.engine import mpm
    from plasticinelab_tpu.envs import SPEC_DIR

    scene = load_scene(os.path.join(SPEC_DIR, "move-v1.json"))
    scene = scene.replace(simulator=dataclasses.replace(
        scene.simulator, dtype="float64"))
    prims = scene.primitives
    D = 24
    rng = np.random.default_rng(8)
    gv = jnp.asarray(rng.standard_normal((D**3, 3)) * 1e-4)
    gm = jnp.asarray(np.abs(rng.standard_normal(D**3)) * 1e-4)
    gm = jnp.where(jnp.asarray(rng.random(D**3) < 0.3), 0.0, gm)
    # crop around the spheres (~cells 36-50 in x, 36 in y, 48 in z)
    off = jnp.asarray([32, 26, 38], jnp.int32)
    pos = jnp.asarray([p.init_pos for p in prims])
    rot = jnp.asarray([p.init_rot for p in prims])
    gap = jnp.zeros((len(prims),))
    soft = jnp.asarray(666.0)

    def ref(gv, gm, pos, pos1):
        return mpm.grid_op(scene, gv, gm, (pos, rot, gap), (pos1, rot, gap),
                           soft, D, off)

    def cm(gv, gm, pos, pos1):
        grid4 = jnp.concatenate([gv.T, gm[None]], axis=0)
        return mpm.grid_op_cm(scene, grid4, (pos, rot, gap),
                              (pos1, rot, gap), soft, D, off).T

    args = (gv, gm, pos, pos + 2e-4)
    out_r, vjp_r = jax.vjp(ref, *args)
    out_c, vjp_c = jax.vjp(cm, *args)
    if mode == "fwd":
        np.testing.assert_allclose(np.asarray(out_c), np.asarray(out_r),
                                   atol=1e-12)
        assert np.abs(np.asarray(out_r)).max() > 0
        return
    ct = jnp.asarray(rng.standard_normal(out_r.shape))
    for a, b in zip(vjp_c(ct), vjp_r(ct)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9,
                                   rtol=1e-9)
