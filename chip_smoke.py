"""Smoke test of the differentiable-MPM main path on the GPU, in one process.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded batched gradient
                                    # against one card, and nothing else
    python chip_smoke.py --only device,oracle,gradient   # a subset (bring-up)

Phases, each printing one JSON line (`{"phase": ..., "ok": ...}`):

- device:   refuse anything but a GPU; print the card, JAX and the cache dir.
- oracle:   Move-v1 at all particles vs the float64 NumPy oracle
            (tests/oracle_mpm.py) after 1 and 19 substeps, at the transfer
            precision in use and at the other one.
- gradient: the 950-substep Move-v1 rollout gradient (PhysicsEnv.rollout_vg):
            compile seconds, memory_analysis(), remat policy, steady seconds,
            peak bytes, run-to-run reproducibility; and a 2-step gradient on
            the GPU against the same jitted function on the CPU backend.
- solve:    Solver.solve_device, 5 Adam iterations at horizon 50.
- layers:   forward+VJP device time of each layer of a substep at Move-v1
            widths, beside the whole substep's share of the gradient.
- render:   a 64x64 observation frame and a 512x512 frame at 1 spp.
- batch:    VecPlasticineEnv reset + 2 steps at B=4, and the batched rollout
            gradient on a 1-device mesh at B=4, T=2.

The last stdout line is `{"ok": true, "device": {...}}`, printed only when
every phase passed. Without a GPU, or if any phase fails, the script exits
non-zero without it.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# The CPU backend is the reference of the gradient phase: keep it available
# when JAX_PLATFORMS restricts the platforms.
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import numpy as np  # noqa: E402

ENV = "Move-v1"
HORIZON = 50  # env steps of the reference episode: 950 substeps
SOFTNESS = 666.0
# Fixed non-zero action (2 spheres x 3 velocity components).
ACTION = np.array([0.6, -0.4, 0.3, -0.5, 0.2, 0.4])
GRAD_REL_TOL = 1e-3   # GPU vs CPU gradient, 2 env steps (38 substeps), f32
MULTI_REL_TOL = 1e-4  # 4 cards vs 1 card, identical per-env programs
REPS = 3


def emit(obj):
    print(json.dumps(obj, default=float), flush=True)


def timed(fn, *args, reps=REPS):
    """Steady wall-clock seconds of fn(*args), each ended by
    block_until_ready; the first call is a warm-up."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return ts


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def physics_env():
    from plasticinelab_tpu.envs import make_physics

    return make_physics(ENV)


# ---------------------------------------------------------------------------
def phase_device(ctx):
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {d.platform}")
    smi = nvidia_smi()
    for line in smi:
        print(f"nvidia-smi: {line}", flush=True)
    ctx["device"] = {"platform": d.platform, "kind": d.device_kind,
                     "count": len(devs)}
    return {
        "device_kind": d.device_kind, "device_count": len(devs),
        "nvidia_smi": smi, "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache_dir": jax.config.jax_compilation_cache_dir,
        "bytes_limit": (d.memory_stats() or {}).get("bytes_limit"),
        "optional_packages": {
            m: importlib.util.find_spec(m) is not None
            for m in ("gymnasium", "flax", "yaml")},
    }


def _oracle_setup(te):
    """Sorted Move-v1 initial state (sorted once so the windowed transfer's
    chunks hold from the first substep) and the matching oracle config."""
    import jax.numpy as jnp

    from plasticinelab_tpu.engine import local_transfer as lt
    from oracle_mpm import OraclePrim

    scene = te.scene
    sim = scene.simulator
    st = te.state
    key = lt.sort_keys(scene, st.x)
    (x, v, C, F), _, _ = lt.sort_rows(key, (st.x, st.v, st.C, st.F))
    state = st._replace(x=x, v=v, C=C, F=F)
    assert all(p.shape == "Sphere" for p in scene.primitives)
    prims = [OraclePrim(p.shape, p.init_pos, p.init_rot, p.friction,
                        {"radius": p.radius}) for p in scene.primitives]
    cfg = {
        "n_grid": sim.n_grid, "dt": sim.dt, "p_vol": sim.p_vol,
        "p_mass": sim.p_mass, "mu": float(te.mats.mu),
        "lam": float(te.mats.lam), "yield_stress": float(te.mats.yield_stress),
        "gravity": sim.gravity, "ground_friction": sim.ground_friction,
        "grid_v_clamp": sim.grid_v_clamp, "prims": prims,
    }
    a = np.clip(ACTION, -1.0, 1.0)
    vels = []
    for i, p in enumerate(scene.primitives):
        s = slice(scene.action_dims[i], scene.action_dims[i + 1])
        vels.append((a[s] * np.asarray(p.action_scale) / sim.substeps,
                     np.zeros(3)))
    host = {k: np.asarray(getattr(state, k), np.float64)
            for k in ("x", "v", "C", "F")}
    return state, cfg, vels, host, jnp.asarray(ACTION, te.dtype)


def phase_oracle(ctx):
    import jax
    from jax.lax import Precision

    from plasticinelab_tpu.engine import local_transfer as lt
    from plasticinelab_tpu.engine import mpm, transfer
    from oracle_mpm import oracle_substep

    te = physics_env()
    scene, mats = te.scene, te.mats
    state, cfg, vels, host, action = _oracle_setup(te)
    D = transfer.crop_size(scene)
    plan = lt.plan_for(scene, D)
    off = transfer.crop_offset(scene, state.x, D)
    windows_ok = bool(lt.chunk_offsets(scene, plan, state.x, off, D).ok)

    t0 = time.perf_counter()
    ref = []
    o = dict(host)
    for k in range(scene.simulator.substeps):
        o = oracle_substep(cfg, o, vels, SOFTNESS)
        if k in (0, scene.simulator.substeps - 1):
            ref.append(o)
    oracle_s = time.perf_counter() - t0

    ctrl = mpm.make_controls(scene, action, te.dtype)
    chosen = transfer.TRANSFER_PRECISION
    other = Precision.HIGH if chosen == Precision.HIGHEST else Precision.HIGHEST
    errs = {}
    try:
        for prec in (chosen, other):
            transfer.TRANSFER_PRECISION = prec  # read at trace time
            one = jax.jit(lambda s: mpm.substep(scene, mats, s, ctrl,
                                                SOFTNESS))(state)
            full = jax.jit(lambda s: mpm.env_step(scene, mats, s, action,
                                                  SOFTNESS))(state)
            errs[prec.name] = {
                n: {k: float(np.max(np.abs(
                    np.asarray(getattr(out, k), np.float64) - r[k]))
                    / np.max(np.abs(r[k])))
                    for k in ("x", "v", "C", "F")}
                for n, out, r in (("1", one, ref[0]), ("19", full, ref[1]))}
    finally:
        transfer.TRANSFER_PRECISION = chosen
    worst = max(max(e.values()) for e in errs[chosen.name].values())
    ok = worst <= transfer.TRANSFER_TOLERANCE
    return {"ok": ok, "precision": chosen.name,
            "tolerance": transfer.TRANSFER_TOLERANCE, "worst_rel_err": worst,
            "field_scale_19": {k: float(np.max(np.abs(ref[1][k])))
                               for k in ("x", "v", "C", "F")},
            "rel_err_by_precision_and_substeps": errs,
            "n_particles": scene.simulator.n_particles,
            "windowed_transfer": windows_ok, "oracle_host_s": oracle_s}


def phase_gradient(ctx):
    import jax
    import jax.numpy as jnp

    from plasticinelab_tpu.engine import mpm

    te = physics_env()
    dev = jax.devices()[0]
    horizon = HORIZON
    rng = np.random.default_rng(0)
    actions = jnp.asarray(rng.uniform(-0.3, 0.3, (horizon, te.scene.action_dim)),
                          te.dtype)
    soft = te.dtype(SOFTNESS)
    vg = te.rollout_vg(horizon)
    t0 = time.perf_counter()
    compiled = vg.lower(te.state, actions, soft).compile()
    compile_s = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes")} if ma is not None else None
    policy = mpm.resolve_remat(te.scene, horizon,
                               mpm.device_memory_bytes(dev)).simulator.remat

    (loss, _), g1 = compiled(te.state, actions, soft)
    (_, _), g2 = compiled(te.state, actions, soft)
    g1, g2 = np.asarray(g1), np.asarray(g2)
    times = timed(compiled, te.state, actions, soft)
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    finite = bool(np.isfinite(float(loss)) and np.all(np.isfinite(g1)))
    nonzero = bool(np.any(g1 != 0))
    ctx["substep_s"] = min(times) / (horizon * te.scene.simulator.substeps)

    # 2 env steps through the public entry point on the GPU, and the same
    # jitted function with its arguments committed to the CPU backend
    T = 2
    loss_g, grad_g, _ = te.rollout_value_and_grad(te.state, actions[:T],
                                                  SOFTNESS)
    cpu = jax.devices("cpu")[0]
    args_cpu = jax.device_put((te.state, actions[:T], soft), cpu)
    (loss_c, _), grad_c = te.rollout_vg(T)(*args_cpu)
    grad_g, grad_c = np.asarray(grad_g, np.float64), np.asarray(grad_c,
                                                                 np.float64)
    rel = float(np.linalg.norm(grad_g - grad_c) / np.linalg.norm(grad_c))
    return {
        "ok": finite and nonzero and rel <= GRAD_REL_TOL,
        "horizon": horizon, "substeps": horizon * te.scene.simulator.substeps,
        "compile_s": compile_s, "memory_analysis": mem,
        "remat_policy": policy, "steady_s": times, "peak_bytes_in_use": peak,
        "loss": float(loss), "grad_norm": float(np.linalg.norm(g1)),
        "finite": finite, "nonzero": nonzero,
        "bitwise_reproducible": bool(np.array_equal(g1, g2)),
        "run_to_run_rel_diff": float(np.linalg.norm(g1 - g2)
                                     / np.linalg.norm(g1)),
        "cpu_vs_gpu": {"horizon": T, "loss_gpu": float(loss_g),
                       "loss_cpu": float(loss_c), "grad_rel_err": rel,
                       "tolerance": GRAD_REL_TOL},
    }


def phase_solve(ctx):
    from plasticinelab_tpu.optimizer.solver import Solver

    te = physics_env()
    solver = Solver(te, None, None, n_iters=5, horizon=HORIZON,
                    **{"optim.lr": 0.1, "init_range": 1e-4})
    np.random.seed(0)
    t0 = time.perf_counter()
    solver.solve_device(chunk=5)
    wall = time.perf_counter() - t0
    losses = solver.iter_losses
    finite = bool(np.all(np.isfinite(losses)))
    return {"ok": finite and solver.best_loss < losses[0],
            "losses": losses, "best_loss": solver.best_loss,
            "wall_s_incl_compile": wall, "chunk_s": solver.chunk_seconds}


def phase_layers(ctx):
    import jax
    import jax.numpy as jnp
    from jax.lax import Precision

    from plasticinelab_tpu.engine import local_transfer as lt
    from plasticinelab_tpu.engine import mpm, transfer
    from plasticinelab_tpu.engine.renderer import Renderer
    from plasticinelab_tpu.engine.renderer.renderer import obs_scene

    te = physics_env()
    scene, mats = te.scene, te.mats
    state, _, _, _, action = _oracle_setup(te)
    rng = np.random.default_rng(1)
    n = scene.simulator.n_particles
    f32 = te.dtype
    C = jnp.asarray(rng.standard_normal((n, 3, 3)) * 0.1, f32)
    F = jnp.asarray(np.eye(3) + rng.standard_normal((n, 3, 3)) * 0.02, f32)
    v = jnp.asarray(rng.standard_normal((n, 3)) * 0.1, f32)
    D = transfer.crop_size(scene)
    plan = lt.plan_for(scene, D)
    x = state.x
    off = transfer.crop_offset(scene, x, D)
    cctx = lt.chunk_offsets(scene, plan, x, off, D)
    _, aff = mpm.stress_affine(scene, mats, C, F)
    gv = jnp.asarray(rng.standard_normal((D ** 3, 3)) * 0.1, f32)
    gm = jnp.asarray(np.abs(rng.standard_normal(D ** 3)) * 1e-4, f32)
    pose = (state.prim_pos, state.prim_rot, state.prim_gap)
    pose1 = mpm._fk_step(scene, pose, mpm.make_controls(scene, action, f32))

    def fwd_vjp(f):
        """jit(f forward + VJP with all-ones cotangents)."""
        def run(*args):
            out, pull = jax.vjp(f, *args)
            return pull(jax.tree.map(jnp.ones_like, out))
        return jax.jit(run)

    def ms(f, *args):
        return 1e3 * min(timed(f, *args, reps=10))

    def sort_roundtrip(x, v):
        key = jax.lax.stop_gradient(lt.sort_keys(scene, x))
        tree, order, rank = lt.sort_rows(key, (x, v))
        return lt.unsort_rows(order, rank, tree)

    layers = {
        "stress_affine": ms(fwd_vjp(
            lambda C, F: mpm.stress_affine(scene, mats, C, F)), C, F),
        "grid_op": ms(fwd_vjp(
            lambda g, m: mpm.grid_op(scene, g, m, pose, pose1, SOFTNESS, D,
                                     off)), gv, gm),
        "sort_unsort_per_env_step": ms(fwd_vjp(sort_roundtrip), x, v),
    }
    chosen = transfer.TRANSFER_PRECISION
    try:
        for prec in (Precision.HIGHEST, Precision.HIGH):
            transfer.TRANSFER_PRECISION = prec
            tag = "" if prec == chosen else f"@{prec.name}"
            layers["p2g_windowed" + tag] = ms(fwd_vjp(
                lambda v, a: lt.p2g_local(scene, plan, x, v, a, cctx, off, D)),
                v, aff)
            layers["g2p_windowed" + tag] = ms(fwd_vjp(
                lambda g: lt.g2p_local(scene, plan, x, g, cctx, off, D)), gv)
            aw = transfer.axis_weights(scene, x, D, off=off)
            layers["p2g_dense_fallback" + tag] = ms(fwd_vjp(
                lambda v, a: transfer.p2g_dense(scene, aw, v, a, D)), v, aff)
            layers["g2p_dense_fallback" + tag] = ms(fwd_vjp(
                lambda g: transfer.g2p_dense(scene, aw, g, D)), gv)
    finally:
        transfer.TRANSFER_PRECISION = chosen

    colors = jnp.asarray(te.particle_colors, jnp.int32)
    for name, rs in (("voxelize_64obs", obs_scene(scene, 64, 2)),
                     ("voxelize_512", scene)):
        r = Renderer(rs)
        lower = jnp.asarray((np.floor(np.asarray(x).min(0) * r.inv_dx) - 6.0)
                            * r.dx, jnp.float32)
        layers[name] = ms(r._voxelize, x.astype(jnp.float32), colors, lower)

    substep_ms = 1e3 * ctx["substep_s"] if "substep_s" in ctx else None
    shares = None
    if substep_ms:
        shares = {k: val / substep_ms for k, val in layers.items()
                  if not k.startswith("voxelize") and "@" not in k
                  and "dense" not in k and "per_env_step" not in k}
        shares["sort_unsort_per_env_step"] = (
            layers["sort_unsort_per_env_step"]
            / (substep_ms * scene.simulator.substeps))
    return {"ok": True, "precision": chosen.name, "fwd_vjp_ms": layers,
            "substep_fwd_bwd_ms_from_gradient": substep_ms,
            "share_of_substep": shares, "crop_D": D,
            "windows_ok": bool(cctx.ok)}


def phase_render(ctx):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from plasticinelab_tpu.engine.renderer import Renderer
    from plasticinelab_tpu.engine.renderer.renderer import obs_scene

    te = physics_env()
    st = te.state
    out = {}
    t0 = time.perf_counter()
    img8 = te.render_obs(res=64, spp=2)
    out["render_obs_64_s_incl_compile"] = time.perf_counter() - t0
    obs_fn = jax.jit(Renderer(obs_scene(te.scene, 64, 2)).build_obs_fn())
    colors = jnp.asarray(te.particle_colors, jnp.int32)
    args = (st.x, colors, st.prim_pos, st.prim_rot, st.prim_gap,
            jax.random.PRNGKey(0))
    img64 = np.asarray(obs_fn(*args))
    out["obs_64_steady_s"] = timed(obs_fn, *args)
    rs = dataclasses.replace(te.scene, renderer=dataclasses.replace(
        te.scene.renderer, spp=1))
    r512 = Renderer(rs)
    r512.set_target_density(te.target_density / te.scene.simulator.p_mass)
    host = [np.asarray(a) for a in (st.x, st.prim_pos, st.prim_rot,
                                    st.prim_gap)]
    t0 = time.perf_counter()
    img512 = r512.render_frame(host[0], te.particle_colors, *host[1:])
    out["frame_512_1spp_s_incl_compile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    img512 = r512.render_frame(host[0], te.particle_colors, *host[1:])
    out["frame_512_1spp_steady_s"] = time.perf_counter() - t0
    out["ok"] = bool(
        img8.shape == (64, 64, 3) and img8.dtype == np.uint8
        and img8.std() > 0 and img64.shape == (64, 64, 3)
        and np.all(np.isfinite(img64)) and img512.shape == (512, 512, 3)
        and np.all(np.isfinite(img512)) and img512.std() > 0)
    return out


def phase_batch(ctx):
    import jax
    import jax.numpy as jnp

    from plasticinelab_tpu.parallel.mesh import (
        batch_states, build_batched_rollout_grad, make_mesh)
    from plasticinelab_tpu.parallel.rollout import VecPlasticineEnv

    out = {}
    B = 4
    t0 = time.perf_counter()
    venv = VecPlasticineEnv(ENV, batch=B, seed=0)
    obs = venv.reset()
    acts = np.tile(ACTION, (B, 1)) * 0.5
    for _ in range(2):
        obs, rew, done, info = venv.step(acts)
    jax.block_until_ready(obs)
    out["vec_env_s_incl_compile"] = time.perf_counter() - t0
    vec_ok = bool(np.all(np.isfinite(np.asarray(obs)))
                  and np.all(np.isfinite(np.asarray(rew))))
    out["vec_env_step_steady_s"] = timed(venv.step, acts)

    te = physics_env()
    step = build_batched_rollout_grad(te.scene, te.mats, te.loss_state,
                                      make_mesh(1))
    states = batch_states(te.state, B, jitter=1e-3)
    actions = jnp.asarray(np.random.default_rng(2).uniform(
        -0.3, 0.3, (B, 2, te.scene.action_dim)), te.dtype)
    soft = te.dtype(SOFTNESS)
    t0 = time.perf_counter()
    loss, grad = step(states, actions, soft)
    jax.block_until_ready(grad)
    out["batched_grad_s_incl_compile"] = time.perf_counter() - t0
    out["batched_grad_steady_s"] = timed(step, states, actions, soft)
    grad_ok = bool(np.isfinite(float(loss))
                   and np.all(np.isfinite(np.asarray(grad))))
    out.update(ok=vec_ok and grad_ok, vec_env_finite=vec_ok,
               batched_grad_finite=grad_ok, batch=B)
    return out


def phase_multi(ctx):
    """build_batched_rollout_grad at Move-v1 full width, B=8, T=2, over 4
    cards vs the same batch on one card."""
    import jax
    import jax.numpy as jnp

    from plasticinelab_tpu.parallel.mesh import (
        batch_states, build_batched_rollout_grad, make_mesh)

    nd = 4
    if len(jax.devices()) < nd:
        raise RuntimeError(f"--multi needs {nd} GPUs, found "
                           f"{len(jax.devices())}")
    te = physics_env()
    B, T = 8, 2
    states = batch_states(te.state, B, jitter=1e-3)
    actions = jnp.asarray(np.random.default_rng(3).uniform(
        -0.3, 0.3, (B, T, te.scene.action_dim)), te.dtype)
    soft = te.dtype(SOFTNESS)
    res = {}
    for k in (1, nd):
        step = build_batched_rollout_grad(te.scene, te.mats, te.loss_state,
                                          make_mesh(k))
        t0 = time.perf_counter()
        loss, grad = step(states, actions, soft)
        jax.block_until_ready(grad)
        compile_s = time.perf_counter() - t0
        res[k] = (float(loss), grad, compile_s, timed(step, states, actions,
                                                      soft))
    (l1, g1, c1, t1), (l4, g4, c4, t4) = res[1], res[nd]
    shard_devs = {s.device for s in g4.addressable_shards}
    shard_shapes = sorted({tuple(s.data.shape) for s in g4.addressable_shards})
    g1n, g4n = np.asarray(g1, np.float64), np.asarray(g4, np.float64)
    grad_rel = float(np.linalg.norm(g4n - g1n) / np.linalg.norm(g1n))
    loss_rel = abs(l4 - l1) / abs(l1)
    ok = (len(shard_devs) == nd and shard_shapes == [(B // nd, T,
                                                      te.scene.action_dim)]
          and grad_rel <= MULTI_REL_TOL and loss_rel <= MULTI_REL_TOL
          and bool(np.all(np.isfinite(g4n))))
    return {"ok": ok, "batch": B, "horizon": T, "devices": nd,
            "loss_1": l1, "loss_4": l4, "loss_rel_err": loss_rel,
            "grad_rel_err": grad_rel, "tolerance": MULTI_REL_TOL,
            "grad_shard_devices": len(shard_devs),
            "grad_shard_shapes": shard_shapes,
            "compile_s": {"1": c1, str(nd): c4},
            "steady_s": {"1": t1, str(nd): t4}}


PHASES = {"device": phase_device, "oracle": phase_oracle,
          "gradient": phase_gradient, "solve": phase_solve,
          "layers": phase_layers, "render": phase_render,
          "batch": phase_batch}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: sharded batched gradient vs one card")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of phases (device always "
                         "runs): " + ",".join(PHASES))
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import plasticinelab_tpu  # noqa: F401  (fails outside the repo)

    if args.multi:
        names = ["device", "multi"]
    elif args.only:
        names = ["device"] + [p for p in args.only.split(",")
                              if p and p != "device"]
    else:
        names = list(PHASES)
    phases = dict(PHASES, multi=phase_multi)
    ctx = {}
    failed = []
    for name in names:
        t0 = time.perf_counter()
        try:
            out = phases[name](ctx)
        except SystemExit as e:  # device refused: nothing else can run
            print(e, file=sys.stderr)
            return 2
        except Exception:
            traceback.print_exc()
            out = {"ok": False, "error": traceback.format_exc(limit=3)}
        out.setdefault("ok", True)
        emit({"phase": name, "seconds": time.perf_counter() - t0, **out})
        if not out["ok"]:
            failed.append(name)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": ctx["device"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
