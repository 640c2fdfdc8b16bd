"""Vectorized on-device RL rollouts (parallel/rollout.py) on the virtual
8-device CPU mesh: batched env semantics match the host-driven PhysicsEnv,
and an RL learner consumes a B>1 batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plasticinelab_tpu.config.spec import (
    EnvSpec, LossSpec, PrimitiveSpec, SceneSpec, SimulatorSpec,
)
from plasticinelab_tpu.parallel.rollout import VecPlasticineEnv


def _tiny():
    sim = SimulatorSpec(quality=0.25, n_particles=32, dtype="float32")
    prim = PrimitiveSpec(shape="Sphere", radius=0.08,
                         init_pos=(0.45, 0.5, 0.5), friction=0.9,
                         action_dim=3, action_scale=(0.01,) * 3)
    scene = SceneSpec(simulator=sim, primitives=(prim,),
                      env=EnvSpec(loss=LossSpec(), n_observed_particles=16))
    rng = np.random.default_rng(0)
    particles = rng.random((32, 3)) * 0.2 + 0.4
    G = sim.n_grid
    target = np.zeros((G, G, G))
    target[6:10, 3:7, 6:10] = sim.p_mass * 4
    return scene, particles, target


@pytest.fixture(scope="module")
def vec_env():
    scene, particles, target = _tiny()
    return VecPlasticineEnv(None, batch=4, scene=scene, jitter=1e-3,
                            target_density=target, particles=particles,
                            horizon=5)


def test_vec_reset_and_step_shapes(vec_env):
    obs = vec_env.reset()
    assert obs.shape == (4, vec_env.obs_dim)
    assert vec_env.obs_dim == 16 * 6 + 7
    actions = np.zeros((4, vec_env.action_dim), np.float32)
    obs, reward, done, info = vec_env.step(actions)
    assert obs.shape == (4, vec_env.obs_dim)
    assert reward.shape == (4,)
    assert np.all(np.isfinite(np.asarray(obs)))
    assert np.all(np.isfinite(np.asarray(reward)))
    assert not bool(done[0])


def test_vec_envs_decorrelate(vec_env):
    vec_env.reset()
    rng = np.random.default_rng(1)
    for _ in range(2):
        a = rng.uniform(-0.5, 0.5, (4, vec_env.action_dim)).astype(np.float32)
        obs, reward, done, _ = vec_env.step(a)
    o = np.asarray(obs)
    assert not np.allclose(o[0], o[1])  # jittered starts diverge


def test_vec_matches_single_env_semantics():
    """Batch entry 0 with zero jitter reproduces the host-driven PhysicsEnv
    reward (is_copy mode: r = start_loss - loss_t)."""
    from plasticinelab_tpu.engine import losses as L
    from plasticinelab_tpu.engine import mpm
    from plasticinelab_tpu.engine.state import default_materials, initial_state

    scene, particles, target = _tiny()
    ve = VecPlasticineEnv(None, batch=2, scene=scene, jitter=0.0,
                          target_density=target, particles=particles,
                          horizon=5)
    ve.reset()
    a = np.full((2, 3), 0.1, np.float32)
    _, reward, _, info = ve.step(a)

    scene2 = scene.with_n_particles(len(particles))
    mats = default_materials(scene2)
    st = initial_state(scene2, particles)
    ls = L.make_loss_state(scene2, target)
    start = L.loss_and_components(scene2, ls, st)["loss"]
    st1 = mpm.env_step(scene2, mats, st, jnp.asarray(a[0]),
                       jnp.float32(666.0))
    l1 = L.loss_and_components(scene2, ls, st1)["loss"]
    np.testing.assert_allclose(float(reward[0]), float(start - l1),
                               rtol=2e-4, atol=1e-5)


def test_vec_incremental_iou_matches_host_env(tmp_path):
    """VecPlasticineEnv info["incremental_iou"] equals the host PhysicsEnv's
    compute_loss incremental_iou (the benchmark headline metric, reference
    loss.py:293-294) for the same scene / target / actions — vec-path RL
    logs are directly comparable to the benchmark (round-3 verdict item 4)."""
    from plasticinelab_tpu.config.spec import ShapeSpec
    from plasticinelab_tpu.engine.sim import PhysicsEnv

    sim = SimulatorSpec(quality=0.25, n_particles=64, dtype="float32")
    prim = PrimitiveSpec(shape="Sphere", radius=0.08,
                         init_pos=(0.45, 0.5, 0.5), friction=0.9,
                         action_dim=3, action_scale=(0.01,) * 3)
    shape = ShapeSpec(shape="sphere", init_pos=(0.55, 0.5, 0.5), radius=0.06,
                      n_particles=64)
    G = sim.n_grid
    target = np.zeros((G, G, G))
    target[6:12, 5:11, 6:12] = sim.p_mass * 4
    tpath = tmp_path / "goal.npy"
    np.save(tpath, target)
    scene = SceneSpec(
        simulator=sim, primitives=(prim,), shapes=(shape,),
        env=EnvSpec(loss=LossSpec(target_path=str(tpath)),
                    n_observed_particles=16))

    host = PhysicsEnv(scene)
    host.initialize()
    ve = VecPlasticineEnv(None, batch=2, scene=scene, jitter=0.0,
                          target_density=target,
                          particles=np.asarray(host.init_particles),
                          horizon=4)
    ve.reset()
    assert abs(ve._target_iou - host._target_iou) < 1e-5

    rng = np.random.default_rng(3)
    for _ in range(3):
        a = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        host.step(a)
        hinfo = host.compute_loss()
        _, _, _, vinfo = ve.step(np.tile(a, (2, 1)))
    vinc = np.asarray(vinfo["incremental_iou"])
    assert vinc.shape == (2,)
    np.testing.assert_allclose(vinc[0], hinfo["incremental_iou"],
                               rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(vinc[0], vinc[1], atol=1e-6)  # jitter=0


def test_sac_consumes_vec_rollout(vec_env):
    """A SAC learner updates from transitions collected by the vectorized
    env — the batched on-device data path."""
    from plasticinelab_tpu.algorithms.common import ReplayBuffer
    from plasticinelab_tpu.algorithms.sac.sac import SAC

    obs = np.asarray(vec_env.reset())
    algo = SAC(state_dim=vec_env.obs_dim, action_dim=vec_env.action_dim)
    replay = ReplayBuffer(state_dim=vec_env.obs_dim,
                          action_dim=vec_env.action_dim, max_size=1000)
    rng = np.random.default_rng(2)
    for t in range(3):
        actions = rng.uniform(-1, 1, (4, vec_env.action_dim)).astype(
            np.float32)
        nobs, reward, done, _ = vec_env.step(actions)
        nobs, reward = np.asarray(nobs), np.asarray(reward)
        for b in range(4):
            replay.add(obs[b], actions[b], nobs[b], reward[b], False)
        obs = nobs
    assert replay.size == 12
    loss = algo.update(replay, batch_size=8, rng=rng)
    assert np.isfinite(loss)
