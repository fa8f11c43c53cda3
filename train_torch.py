"""Entry point of the PyTorch / CUDA port (counterpart of ``train.py``).

Usage:
    python train_torch.py --taskcfg grasp_cube --algocfg ppo --test_only
    python train_torch.py --taskcfg open_drawer --algocfg ppo --test_only \
        --algo.tricks.use_state_norm \
        --resume artifacts/open_drawer_ppo/expert_r3c_seed389/model_30000.ckpt
    python train_torch.py --taskcfg open_drawer --algocfg ppo \
        --task.asset.mesh_handle                      # PPO training
    python train_torch.py --taskcfg open_drawer --algocfg dagger --test_only \
        --algo.obs_mode depth_pc --algo.model.network.name PointNet \
        --algo.teacher artifacts/open_drawer_ppo/expert_r3c_seed389/model_30000.ckpt
    python train_torch.py --taskcfg open_drawer --algocfg dagger \
        --algo.obs_mode depth_pc --algo.model.network.name PointNet \
        --algo.teacher artifacts/open_drawer_ppo/expert_r3c_seed389/model_30000.ckpt
                                                      # DAgger training
    python collect_demos_torch.py --only_success --taskcfg open_drawer \
        --teacher artifacts/open_drawer_ppo/expert_r3c_seed389/model_30000.ckpt \
        --out logs/tsdf_demos                         # mesh_tsdf demos
    python train_torch.py --taskcfg open_drawer --algocfg bc \
        --algo.data_path logs/tsdf_demos              # BC of the Conv3DNet student
    python train_torch.py --taskcfg open_drawer --algocfg dagger \
        --pretrain logs/ckpts/open_drawer_bc/<exp>/model_1000.ckpt \
        --algo.offline_data_pth logs/tsdf_demos \
        --algo.teacher artifacts/open_drawer_ppo/expert_r3c_seed389/model_30000.ckpt
                                                      # the TSDF student (YAML defaults)
    python train_torch.py --taskcfg open_drawer --algocfg ppo \
        --task.asset.mesh_handle --parallel.num_devices 2
                                                      # PPO on 2 ranks (NCCL, cuda:0, cuda:1)
    python train_torch.py --parallel.num_devices 2 --device cpu
                                                      # 2 gloo ranks on the CPU
Every YAML key is exposed as a dotted CLI flag (see
partmanip_tpu_torch/config.py).  Runs on the GPU; ``--device cpu`` runs the
plain PyTorch path on the CPU instead.  ``--parallel.num_devices N``
(PPO only) starts N ranks, one process each, that shard the envs
(``partmanip_tpu_torch/parallel/mesh.py``): with ``--device cuda`` rank r
runs on ``cuda:r`` and the ranks reduce through NCCL; with ``--device
cuda:k`` or ``cpu`` every rank runs on that device and they reduce through
gloo (NCCL refuses several ranks on one device).
``main`` then returns rank 0's :class:`RankRun`.  ``--im_scale N`` divides the
288×512 depth cameras of the volumetric vision modes by N (the JAX package
sets ``cfg["task"]["im_scale"]`` in its tests; it is no YAML key).
"""

import os
import random
from argparse import ArgumentParser

import numpy as np
import torch

from partmanip_tpu_torch.config import process_cfgs
from partmanip_tpu_torch.parallel import mesh as mesh_lib
from partmanip_tpu_torch.utils.logger import Logger


def set_seed(seed, exp_name, resume):
    """Seed resolution incl. seed-from-exp-name and seed-from-resume-path."""
    if "seed" in exp_name:
        seed = int(exp_name.split("seed")[-1])
    elif resume:
        try:
            seed = int(resume.split("/")[-2].split("seed")[-1])
        except (ValueError, IndexError):
            seed = 1234
    elif seed == -1:
        seed = np.random.randint(0, 10000)
    if "seed" not in exp_name:
        exp_name = exp_name + f"_seed{seed}"
    print(f"Setting seed: {seed}")
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed, exp_name


def make_env(cfg, sim_params, device, mesh=None):
    name = cfg["task_name"]
    if name == "grasp_cube":
        from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv
        return GraspCubeEnv(cfg["task"], sim_params, device=device, mesh=mesh)
    if name == "open_drawer":
        from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv
        return OpenDrawerEnv(cfg["task"], sim_params, device=device, mesh=mesh)
    raise NotImplementedError(f"task {name!r} has no env in the port")


def make_runner(env, cfg, logger):
    name = cfg["algo_name"]
    if name == "ppo":
        from partmanip_tpu_torch.algos.ppo import PPO
        return PPO(env, cfg["algo"], logger)
    if name == "dagger":
        from partmanip_tpu_torch.algos.dagger import DAgger
        return DAgger(env, cfg["algo"], logger)
    if name == "bc":
        from partmanip_tpu_torch.algos.bc import BC
        return BC(env, cfg["algo"], logger)
    raise NotImplementedError(f"algo {name!r} has no runner in the port (it has "
                              f"ppo, dagger and bc)")


class RankRun:
    """What a rank of a multi-rank run hands back (its runner stays in its
    process): the runner's ``last_log``, iteration count, env steps, seconds
    per iteration and checkpoint folder, and the rank's kernel launches and
    sharded physics steps."""

    def __init__(self, runner):
        from partmanip_tpu_torch.utils import cuda_lib
        self.last_log = getattr(runner, "last_log", {})
        self.curr_iter = runner.curr_iter
        self.total_envsteps = runner.total_envsteps
        self.iteration_seconds = list(runner.iteration_seconds)
        self.save_ckpt_dir = runner.save_ckpt_dir
        self.launch_counts = cuda_lib.launch_counts()
        self.shard_dispatch_count = mesh_lib.SHARD_DISPATCH_COUNT


def _rank_main(argv):
    """One rank of ``main(argv)``: the run in this process's mesh."""
    return RankRun(main(argv))


def _parse(argv):
    """(device arguments, merged config, sim params) of a command line."""
    dev_parser = ArgumentParser(add_help=False)
    dev_parser.add_argument("--device", default="cuda")
    dev_parser.add_argument("--im_scale", type=int, default=1)
    dargs, rest = dev_parser.parse_known_args(argv)
    cfg, sim_params = process_cfgs(rest)
    return dargs, cfg, sim_params


def build(argv=None):
    """The configured job's runner and merged config, its env built on the
    device (in this process's mesh when one is active), not yet run."""
    dargs, cfg, sim_params = _parse(argv)
    # f32 convolutions, as the JAX package's (cuDNN's default is TF32)
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.active_mesh()
    cfg["task"]["im_scale"] = dargs.im_scale
    cfg["seed"], cfg["exp_name"] = set_seed(
        cfg["seed"], cfg["exp_name"], cfg.get("resume"))
    if mesh is not None and mesh.rank > 0:
        cfg["log"]["mode"] = []                     # rank 0 logs
    logger = Logger(cfg=cfg, exp_name=cfg["exp_name"],
                    task_name=cfg["task_name"], algo_name=cfg["algo_name"])
    if cfg.get("resume"):
        cfg["algo"]["resume"] = cfg["resume"] = logger.update_resume_path(
            cfg["resume"])
    if cfg.get("pretrain"):
        cfg["algo"]["pretrain"] = cfg["pretrain"] = logger.update_resume_path(
            cfg["pretrain"])

    env = make_env(cfg, sim_params, dargs.device if mesh is None else mesh.device, mesh)
    return make_runner(env, cfg, logger), cfg


def main(argv=None):
    """Run the configured job; returns the runner (its ``last_log`` holds
    the evaluation metrics), or with ``--parallel.num_devices`` N > 1 rank
    0's :class:`RankRun` once the N ranks have finished."""
    dargs, cfg, _ = _parse(argv)
    ranks = int(cfg["algo"]["parallel"].get("num_devices") or 1)
    if ranks > 1 and mesh_lib.active_mesh() is None:
        if cfg["algo_name"] != "ppo":
            raise ValueError(f"parallel.num_devices {ranks}: env-axis data parallelism "
                             f"is the PPO trainer's, not {cfg['algo_name']}'s")
        backend = "nccl" if dargs.device == "cuda" else "gloo"
        return mesh_lib.launch(_rank_main, ranks, backend, dargs.device, args=(argv,))[0]
    runner, cfg = build(argv)
    runner.run(seed=cfg["seed"], resume=cfg["algo"].get("resume"))
    return runner


if __name__ == "__main__":
    main()
