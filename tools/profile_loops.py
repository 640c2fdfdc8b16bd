"""Isolate while/fori loop per-iteration overhead vs march-body cost."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def bench(fn, *args, n=5):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    import jax
    import jax.numpy as jnp

    R = 512 * 512
    x = jnp.ones((R,), jnp.float32)

    # 1) trivial fori_loop body, 100 iters
    @jax.jit
    def trivial(x):
        def body(i, c):
            return c + 1.0
        return jax.lax.fori_loop(0, 100, body, x)
    t = bench(trivial, x)
    print(f"fori 100 trivial-body:      {t*1e3:8.2f} ms  ({t*10:.3f} ms/iter)")

    # 2) while_loop with any(active) cond, vector body, 100 iters
    @jax.jit
    def wl(x):
        def cond(c):
            i, v, act = c
            return (i < 100) & jnp.any(act)
        def body(c):
            i, v, act = c
            v = jnp.where(act, v * 1.0001 + 0.1, v)
            return i + 1, v, act & (v < 1e9)
        _, v, _ = jax.lax.while_loop(cond, body, (0, x, x > 0))
        return v
    t = bench(wl, x)
    print(f"while 100 cheap-body:       {t*1e3:8.2f} ms  ({t*10:.3f} ms/iter)")

    # 3) march-burst-like body in a fori_loop: K=8 gather + trilerp
    tab = jnp.asarray(
        np.random.default_rng(0).standard_normal((168 ** 3, 8)), jnp.bfloat16)
    o = jnp.zeros((R, 3), jnp.float32) + 0.3
    d = jnp.ones((R, 3), jnp.float32) / np.sqrt(3)
    ks = jnp.arange(8, dtype=jnp.float32)

    @jax.jit
    def burst(o, d):
        def body(i, c):
            t, acc = c
            ts = t[:, None] + 0.01 * ks[None, :]
            pk = o[:, None, :] + d[:, None, :] * ts[..., None]   # (R,8,3)
            p = jnp.clip(pk, 0, 1) * 167.0
            base = p.astype(jnp.int32)
            fx = p - base
            idx = (base[..., 0] * 168 + base[..., 1]) * 168 + base[..., 2]
            v = tab[idx].astype(jnp.float32)                      # (R,8,8)
            w = (fx[..., 0:1] * fx[..., 1:2] * fx[..., 2:3])
            s = jnp.sum(v * w, -1)                                # (R,8)
            acc = acc + jnp.sum(s, -1)
            return t + 0.08, acc
        return jax.lax.fori_loop(0, 16, body, (jnp.zeros((R,)), jnp.zeros((R,))))[1]
    t = bench(burst, o, d)
    print(f"fori 16 burst-body (K=8):   {t*1e3:8.2f} ms  ({t/16*1e3:.3f} ms/iter)")

    # 4) same body, 16x unrolled (no loop)
    @jax.jit
    def burst_unrolled(o, d):
        tt = jnp.zeros((R,))
        acc = jnp.zeros((R,))
        for i in range(16):
            ts = tt[:, None] + 0.01 * ks[None, :]
            pk = o[:, None, :] + d[:, None, :] * ts[..., None]
            p = jnp.clip(pk, 0, 1) * 167.0
            base = p.astype(jnp.int32)
            fx = p - base
            idx = (base[..., 0] * 168 + base[..., 1]) * 168 + base[..., 2]
            v = tab[idx].astype(jnp.float32)
            w = (fx[..., 0:1] * fx[..., 1:2] * fx[..., 2:3])
            s = jnp.sum(v * w, -1)
            acc = acc + jnp.sum(s, -1)
            tt = tt + 0.08
        return acc
    t = bench(burst_unrolled, o, d)
    print(f"unrolled 16 burst-body:     {t*1e3:8.2f} ms  ({t/16*1e3:.3f} ms/iter)")

    # 5) coarse-skip-like body: 1-wide gather + cheap ops, 100 iters
    cd = jnp.asarray(np.random.default_rng(1).random(42 ** 3), jnp.float32)
    @jax.jit
    def coarse(o, d):
        def body(i, c):
            t, acc = c
            pos = o + d * t[:, None]
            p = jnp.clip(pos, 0, 1) * 41.0
            b = p.astype(jnp.int32)
            idx = (b[..., 0] * 42 + b[..., 1]) * 42 + b[..., 2]
            sk = cd[idx]
            return t + sk * 0.01 + 0.001, acc + sk
        return jax.lax.fori_loop(0, 100, body, (jnp.zeros((R,)), jnp.zeros((R,))))[1]
    t = bench(coarse, o, d)
    print(f"fori 100 coarse-body:       {t*1e3:8.2f} ms  ({t*10:.3f} ms/iter)")




def main_barrier():
    import jax
    import jax.numpy as jnp

    R = 512 * 512
    tab = jnp.asarray(
        np.random.default_rng(0).standard_normal((168 ** 3, 8)), jnp.bfloat16)
    o = jnp.zeros((R, 3), jnp.float32) + 0.3
    d = jnp.ones((R, 3), jnp.float32) / np.sqrt(3)
    ks = jnp.arange(8, dtype=jnp.float32)

    @jax.jit
    def burst_bar(o, d):
        def body(i, c):
            t, acc = c
            ts = t[:, None] + 0.01 * ks[None, :]
            pk = o[:, None, :] + d[:, None, :] * ts[..., None]
            p = jnp.clip(pk, 0, 1) * 167.0
            base = p.astype(jnp.int32)
            fx = p - base
            idx = (base[..., 0] * 168 + base[..., 1]) * 168 + base[..., 2]
            idx = jax.lax.optimization_barrier(idx)
            v = tab[idx].astype(jnp.float32)
            w = (fx[..., 0:1] * fx[..., 1:2] * fx[..., 2:3])
            s = jnp.sum(v * w, -1)
            acc = acc + jnp.sum(s, -1)
            return t + 0.08, acc
        return jax.lax.fori_loop(0, 16, body, (jnp.zeros((R,)), jnp.zeros((R,))))[1]
    t = bench(burst_bar, o, d)
    print(f"fori 16 burst+barrier:      {t*1e3:8.2f} ms  ({t/16*1e3:.3f} ms/iter)")

    # flat indices variant: gather from flat (N*8,) with reshaped idx
    tabf = tab.reshape(-1)
    @jax.jit
    def burst_flat(o, d):
        def body(i, c):
            t, acc = c
            ts = t[:, None] + 0.01 * ks[None, :]
            pk = o[:, None, :] + d[:, None, :] * ts[..., None]
            p = jnp.clip(pk, 0, 1) * 167.0
            base = p.astype(jnp.int32)
            fx = p - base
            idx = (base[..., 0] * 168 + base[..., 1]) * 168 + base[..., 2]
            idx = jax.lax.optimization_barrier(idx.reshape(-1))
            v = jnp.take(tabf.reshape(-1, 8), idx, axis=0).reshape(R, 8, 8).astype(jnp.float32)
            w = (fx[..., 0:1] * fx[..., 1:2] * fx[..., 2:3])
            s = jnp.sum(v * w, -1)
            acc = acc + jnp.sum(s, -1)
            return t + 0.08, acc
        return jax.lax.fori_loop(0, 16, body, (jnp.zeros((R,)), jnp.zeros((R,))))[1]
    t = bench(burst_flat, o, d)
    print(f"fori 16 burst+bar flat:     {t*1e3:8.2f} ms  ({t/16*1e3:.3f} ms/iter)")

    cd = jnp.asarray(np.random.default_rng(1).random(42 ** 3), jnp.float32)
    @jax.jit
    def coarse_bar(o, d):
        def body(i, c):
            t, acc = c
            pos = o + d * t[:, None]
            p = jnp.clip(pos, 0, 1) * 41.0
            b = p.astype(jnp.int32)
            idx = (b[..., 0] * 42 + b[..., 1]) * 42 + b[..., 2]
            idx = jax.lax.optimization_barrier(idx)
            sk = cd[idx]
            return t + sk * 0.01 + 0.001, acc + sk
        return jax.lax.fori_loop(0, 100, body, (jnp.zeros((R,)), jnp.zeros((R,))))[1]
    t = bench(coarse_bar, o, d)
    print(f"fori 100 coarse+barrier:    {t*1e3:8.2f} ms  ({t*10:.3f} ms/iter)")



if __name__ == "__main__":
    main_barrier() if "bar" in __import__("sys").argv else main()
