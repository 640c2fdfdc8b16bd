"""Extended oracle coverage: golden substep tests
for all 7 primitive shapes, RollingPin/Chopsticks kinematics, a multi-shape
scene, and the soft-contact loss — all vs the float64 NumPy oracle.

(The BASELINE "vs Taichi" check is not directly runnable here: the image
forbids installing packages and has no network egress, so taichi cannot be
installed; the oracle is the independent float64 ground truth instead.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plasticinelab_tpu.config.spec import (
    EnvSpec, LossSpec, PrimitiveSpec, SceneSpec, SimulatorSpec,
)
from plasticinelab_tpu.engine import losses as losses_mod
from plasticinelab_tpu.engine import mpm
from plasticinelab_tpu.engine import primitives as prim
from plasticinelab_tpu.engine.state import Controls, Materials, SimState

from oracle_mpm import OraclePrim, oracle_fk, oracle_substep


SHAPE_SPECS = {
    "Sphere": (PrimitiveSpec(shape="Sphere", radius=0.08,
                             init_pos=(0.44, 0.46, 0.5)),
               {"radius": 0.08}),
    "Capsule": (PrimitiveSpec(shape="Capsule", h=0.12, r=0.03,
                              init_pos=(0.46, 0.5, 0.5)),
                {"h": 0.12, "r": 0.03}),
    "RollingPin": (PrimitiveSpec(shape="RollingPin", h=0.3, r=0.04,
                                 init_pos=(0.5, 0.52, 0.5)),
                   {"h": 0.3, "r": 0.04}),
    "Chopsticks": (PrimitiveSpec(shape="Chopsticks", h=0.2, r=0.02,
                                 init_gap=0.1, minimal_gap=0.04,
                                 init_pos=(0.5, 0.55, 0.5)),
                   {"h": 0.2, "r": 0.02, "init_gap": 0.1,
                    "minimal_gap": 0.04}),
    "Cylinder": (PrimitiveSpec(shape="Cylinder", h=0.06, r=0.1,
                               init_pos=(0.5, 0.42, 0.5)),
                 {"h": 0.06, "r": 0.1}),
    "Torus": (PrimitiveSpec(shape="Torus", tx=0.1, ty=0.04,
                            init_pos=(0.5, 0.45, 0.5)),
              {"tx": 0.1, "ty": 0.04}),
    "Box": (PrimitiveSpec(shape="Box", size=(0.05, 0.08, 0.05),
                          init_pos=(0.46, 0.42, 0.5)),
            {"size": (0.05, 0.08, 0.05)}),
}


def _scene(prims, n=80):
    sim = SimulatorSpec(quality=0.5, n_particles=n, yield_stress=50.0,
                        E=5e3, nu=0.2, ground_friction=1.5, dtype="float64")
    return SceneSpec(simulator=sim, primitives=tuple(prims))


def _init(scene, seed=0):
    rng = np.random.default_rng(seed)
    n = scene.simulator.n_particles
    x = rng.random((n, 3)) * 0.2 + 0.4
    v = rng.standard_normal((n, 3)) * 0.3
    C = rng.standard_normal((n, 3, 3)) * 0.5
    F = np.eye(3) + rng.standard_normal((n, 3, 3)) * 0.05
    return x, v, C, F


def _mats(scene):
    sim = scene.simulator
    return Materials(mu=jnp.asarray(sim.mu_0), lam=jnp.asarray(sim.lam_0),
                     yield_stress=jnp.asarray(sim.yield_stress))


def _oracle_cfg(scene, prims):
    sim = scene.simulator
    return {
        "n_grid": sim.n_grid, "dt": sim.dt, "p_vol": sim.p_vol,
        "p_mass": sim.p_mass, "mu": sim.mu_0, "lam": sim.lam_0,
        "yield_stress": sim.yield_stress, "gravity": sim.gravity,
        "ground_friction": sim.ground_friction,
        "grid_v_clamp": sim.grid_v_clamp, "prims": prims,
    }


def _jax_state(scene, x, v, C, F):
    k = len(scene.primitives)
    pos = np.array([p.init_pos for p in scene.primitives], float).reshape(k, 3)
    rot = np.array([p.init_rot for p in scene.primitives], float).reshape(k, 4)
    gap = np.array(
        [p.init_gap if p.shape == "Chopsticks" else 0.0
         for p in scene.primitives], float)
    return SimState(
        x=jnp.asarray(x), v=jnp.asarray(v), C=jnp.asarray(C), F=jnp.asarray(F),
        prim_pos=jnp.asarray(pos), prim_rot=jnp.asarray(rot),
        prim_gap=jnp.asarray(gap),
    )


def _run_and_compare(scene, oprims, vels, steps=3, seed=0, atol=1e-7):
    x, v, C, F = _init(scene, seed)
    mats = _mats(scene)
    state = _jax_state(scene, x, v, C, F)
    cfg = _oracle_cfg(scene, oprims)
    k = len(scene.primitives)
    ctrl = Controls(
        v=jnp.asarray(np.array([ve[0] for ve in vels])).reshape(k, 3),
        w=jnp.asarray(np.array([ve[1] for ve in vels])).reshape(k, 3),
        gap_vel=jnp.asarray(np.array([ve[2] for ve in vels])).reshape(k),
    )
    step = jax.jit(lambda s: mpm.substep(scene, mats, s, ctrl, 666.0))
    ostate = {"x": x, "v": v, "C": C, "F": F}
    for it in range(steps):
        state = step(state)
        ostate = oracle_substep(cfg, ostate, vels, 666.0)
        for key in ("x", "v", "C", "F"):
            np.testing.assert_allclose(
                np.asarray(getattr(state, key)), ostate[key], atol=atol,
                err_msg=f"{key} mismatch at substep {it}")
    for i, pr in enumerate(oprims):
        np.testing.assert_allclose(np.asarray(state.prim_pos[i]), pr.pos,
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(state.prim_rot[i]), pr.rot,
                                   atol=1e-12)
        np.testing.assert_allclose(float(state.prim_gap[i]), pr.gap,
                                   atol=1e-12)


@pytest.mark.parametrize("shape", list(SHAPE_SPECS))
def test_substep_matches_oracle_per_shape(shape):
    spec, params = SHAPE_SPECS[shape]
    scene = _scene([spec])
    opr = OraclePrim(shape, spec.init_pos, spec.init_rot, spec.friction,
                     params)
    pv = np.array([0.002, -0.001, 0.0005])
    pw = np.array([0.001, 0.0015, -0.002])
    gv = 0.003 if shape == "Chopsticks" else 0.0
    _run_and_compare(scene, [opr], [(pv, pw, gv)])


def test_substep_matches_oracle_multishape():
    specs = [SHAPE_SPECS["Sphere"], SHAPE_SPECS["Capsule"], SHAPE_SPECS["Box"]]
    scene = _scene([s for s, _ in specs], n=100)
    oprims = [
        OraclePrim(s.shape, s.init_pos, s.init_rot, s.friction, p)
        for s, p in specs
    ]
    rng = np.random.default_rng(3)
    vels = [(rng.uniform(-2e-3, 2e-3, 3), rng.uniform(-2e-3, 2e-3, 3), 0.0)
            for _ in specs]
    _run_and_compare(scene, oprims, vels)


@pytest.mark.parametrize("shape", ["RollingPin", "Chopsticks"])
def test_fk_trajectories_match_oracle(shape):
    spec, params = SHAPE_SPECS[shape]
    opr = OraclePrim(shape, spec.init_pos, spec.init_rot, spec.friction,
                     params)
    pos = jnp.asarray(spec.init_pos, jnp.float64)
    rot = jnp.asarray(spec.init_rot, jnp.float64)
    gap = jnp.asarray(params.get("init_gap", 0.0), jnp.float64)
    rng = np.random.default_rng(4)
    for _ in range(20):
        pv = rng.uniform(-5e-3, 5e-3, 3)
        pw = rng.uniform(-5e-3, 5e-3, 3)
        gv = rng.uniform(-5e-3, 5e-3)
        pos, rot, gap = prim.forward_kinematics(
            spec, pos, rot, gap, jnp.asarray(pv), jnp.asarray(pw),
            jnp.asarray(gv))
        oracle_fk(opr, pv, pw, gv)
        np.testing.assert_allclose(np.asarray(pos), opr.pos, atol=1e-12)
        np.testing.assert_allclose(np.asarray(rot), opr.rot, atol=1e-12)
        if shape == "Chopsticks":
            np.testing.assert_allclose(float(gap), opr.gap, atol=1e-12)


@pytest.mark.parametrize("soft", [False, True])
def test_contact_loss_matches_numpy(soft):
    spec, params = SHAPE_SPECS["Capsule"]
    spec = spec.replace(action_dim=6, action_scale=(0.01,) * 6) \
        if hasattr(spec, "replace") else spec
    import dataclasses
    spec = dataclasses.replace(spec, action_dim=6, action_scale=(0.01,) * 6)
    sim = SimulatorSpec(quality=0.5, n_particles=60, dtype="float64")
    scene = SceneSpec(
        simulator=sim, primitives=(spec,),
        env=EnvSpec(loss=LossSpec(soft_contact=soft)),
    )
    x, v, C, F = _init(scene, seed=5)
    state = _jax_state(scene, x, v, C, F)
    dists = losses_mod.contact_distances(scene, state)
    assert len(dists) == 1

    opr = OraclePrim("Capsule", spec.init_pos, spec.init_rot, spec.friction,
                     params)
    d = np.maximum(opr.sdf(x), 0.0)
    if soft:
        w = 1.0 / (1.0 + d * d * 10000.0)
        expect = np.sum(d * w) / np.sum(w)
    else:
        expect = np.min(d)
    np.testing.assert_allclose(float(dists[0]), expect, atol=1e-12)
