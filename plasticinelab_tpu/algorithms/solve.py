"""CLI: python -m plasticinelab_tpu.algorithms.solve --algo action --env_name Move-v1

Behavioral reference: plb/algorithms/solve.py — same flags, same default
budgets (50x200 env steps for differentiable solvers, 500k for RL). The
differentiable solvers (action, nn) drive the task's PhysicsEnv directly and
need neither gymnasium nor flax; the RL algorithms build the gymnasium env.
"""
from __future__ import annotations

import argparse
import random

import numpy as np

RL_ALGOS = ["sac", "discor", "td3", "ppo", "acktr"]
DIFF_ALGOS = ["action", "nn"]


def set_random_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--algo", type=str, default="action",
                        choices=DIFF_ALGOS + RL_ALGOS)
    parser.add_argument("--env_name", type=str, default="Move-v1")
    parser.add_argument("--path", type=str, default="./tmp")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sdf_loss", type=float, default=10)
    parser.add_argument("--density_loss", type=float, default=10)
    parser.add_argument("--contact_loss", type=float, default=1)
    parser.add_argument("--soft_contact_loss", action="store_true")
    parser.add_argument("--num_steps", type=int, default=None)
    # differentiable physics parameters
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--policy", type=str, default="TD3",
                        choices=["TD3", "OurDDPG", "DDPG"],
                        help="TD3-family variant (reference TD3/main.py)")
    parser.add_argument("--vec_envs", type=int, default=0,
                        help="collect RL data with N batched on-device envs "
                             "(batched extension; 0 = reference loop)")
    parser.add_argument("--obs_mode", type=str, default="state",
                        choices=["state", "rgb"],
                        help="rgb = rendered 64x64 image observations "
                             "(visual-RL extension, BASELINE configs[3])")
    parser.add_argument("--image_obs_res", type=int, default=64,
                        help="rgb observation resolution")
    parser.add_argument("--image_obs_spp", type=int, default=2,
                        help="rgb observation samples per pixel")
    parser.add_argument("--softness", type=float, default=666.0)
    parser.add_argument("--optim", type=str, default="Adam",
                        choices=["Adam", "Momentum"])
    parser.add_argument("--host_loop", action="store_true",
                        help="run the action solve with the reference-style "
                             "host loop (numpy optimizer each iteration) "
                             "instead of the device-resident scan chunks")
    return parser.parse_args(argv)


HORIZON = 50  # env steps per episode (reference TimeLimit, envs/__init__.py)


def main(argv=None):
    from .logger import Logger

    args = get_args(argv)
    if args.num_steps is None:
        args.num_steps = HORIZON * 200 if args.algo in DIFF_ALGOS else 500000

    logger = Logger(args.path)
    set_random_seed(args.seed)
    loss_weights = dict(
        sdf_loss=args.sdf_loss, density_loss=args.density_loss,
        contact_loss=args.contact_loss,
        soft_contact_loss=args.soft_contact_loss)

    if args.algo in DIFF_ALGOS:
        from ..envs import make_physics

        te = make_physics(args.env_name, nn=(args.algo == "nn"),
                          **loss_weights)
        if args.algo == "action":
            from ..optimizer.solver import solve_action

            solve_action(te, args.path, logger, args, HORIZON)
        else:
            from ..optimizer.solver_nn import solve_nn

            solve_nn(te, args.path, logger, args, HORIZON)
        return

    from ..envs import make

    env = make(
        args.env_name, max_episode_steps=HORIZON,
        obs_mode=getattr(args, "obs_mode", "state"),
        image_obs_res=getattr(args, "image_obs_res", 64),
        image_obs_spp=getattr(args, "image_obs_spp", 2), **loss_weights,
    )
    env.unwrapped.seed(args.seed)

    if args.algo in ("sac", "discor"):
        # "discor" = SAC + the DisCor error model (sac/discor.py); the
        # reference vendors DisCor (plb/algorithms/discor/algorithm/discor.py)
        # but solve.py only ever builds plain SAC — here it is selectable.
        from .sac.run_sac import train as train_sac

        train_sac(env, args.path, logger, args)
    elif args.algo == "td3":
        from .td3.run_td3 import train_td3

        train_td3(env, args.path, logger, args)
    elif args.algo == "ppo":
        from .ppo.run_ppo import train_ppo

        train_ppo(env, args.path, logger, args)
    elif args.algo == "acktr":
        # Extension: the reference ships ACKTR (ppo/algo/a2c_acktr.py)
        # but never exposes it from solve.py; here it is a first-class algo.
        from .ppo.run_ppo import train_ppo

        train_ppo(env, args.path, logger, args, algo="acktr")
    else:
        raise NotImplementedError(args.algo)


if __name__ == "__main__":
    main()
