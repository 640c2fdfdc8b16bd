"""Stability sweep: every task family, 50 random env steps at |a| <= AMP.

Criterion: all 10 families survive >= 50 random steps at
|a| <= 1.0 in float32 (the reference's own NaN dump-and-raise guard stays
in place, plb/envs/env.py:50-56 semantics). Run on the GPU:

    python tools/stability_sweep.py [amp] [steps] [out.json]

Prints one human line per family and, when an output path is given, writes
a JSON artifact with per-task status, wallclock, and steady-state forward
substeps/s (median step time after the compile step) so per-family perf
regressions are diffable across runs.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

FAMILIES = [
    "Move-v1", "Torus-v1", "Rope-v1", "Writer-v1", "Pinch-v1",
    "Rollingpin-v1", "Chopsticks-v1", "Table-v1", "TripleMove-v1",
    "Assembly-v1",
]


def main():
    amp = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    out_path = sys.argv[3] if len(sys.argv) > 3 else None
    from plasticinelab_tpu.envs import make

    rng = np.random.default_rng(0)
    failures = []
    rows = []
    for name in FAMILIES:
        t0 = time.time()
        env = make(name)
        env.reset()
        substeps = env.unwrapped.taichi_env.scene.simulator.substeps
        status = "OK"
        fail_step = None
        step_times = []
        for t in range(steps):
            a = rng.uniform(-amp, amp, env.action_space.shape)
            try:
                ts = time.perf_counter()
                obs, r, term, trunc, info = env.step(a)
                step_times.append(time.perf_counter() - ts)
            except Exception as e:
                status = f"FAIL: {type(e).__name__}"
                fail_step = t
                failures.append(name)
                break
        total = time.time() - t0
        steady = float(np.median(step_times[1:])) if len(step_times) > 2 \
            else None
        sps = round(substeps / steady, 1) if steady else None
        rows.append({
            "task": name, "status": status, "steps": len(step_times),
            "fail_step": fail_step, "wallclock_s": round(total, 1),
            "steady_step_s": round(steady, 4) if steady else None,
            "fwd_substeps_per_sec": sps,
        })
        print(f"{name:15s} {status} ({len(step_times)} steps)  "
              f"[{total:.0f}s, {sps or '-'} substeps/s]", flush=True)
    print("FAILURES:", failures if failures else "none", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"amp": amp, "steps": steps, "dtype": "float32",
                       "tasks": rows, "failures": failures}, f, indent=1)
        print(f"wrote {out_path}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
