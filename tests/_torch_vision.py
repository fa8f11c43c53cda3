"""Shared set-up of the vision parity tests (``tests/test_torch_vision_env.py``,
``tests/test_torch_dagger.py``) and of the script that makes their JAX
reference values (``tests/golden_torch/make_vision_golden.py``): the same
small open_drawer ``depth_pc`` configuration for both packages, the cabinet
placements both are given, and PointNet actor-critic weights drawn with
numpy in the flax layout."""

import contextlib
import os

import numpy as np

E = 2                      # envs
IM_SCALE = 8               # 36 x 64 depth images
N_STEPS = 2                # env steps after the reset
EVAL_T = 3                 # episode length of the DAgger evaluation round
N_OBJECTS = 3
OBJ_SEED = 7               # random.seed before each env (the cabinet shuffle)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(ROOT, "artifacts", "open_drawer_ppo", "expert_r3c_seed389",
                       "model_30000.ckpt")
GOLDEN = os.path.join(ROOT, "tests", "golden_torch", "vision_depth_pc.npz")


def flags(asset_root):
    return ["--taskcfg", "open_drawer", "--algocfg", "dagger",
            "--algo.num_envs", str(E), "--algo.obs_mode", "depth_pc",
            "--algo.model.network.name", "PointNet",
            "--task.asset.num_objects", str(N_OBJECTS),
            "--task.maxEpisodeLength", str(EVAL_T),
            "--task.asset.assetRoot", str(asset_root)]


def small_cfg(cfg):
    """What the flags cannot say: the render at 1/8 size, and the exact
    march (the JAX package's CPU renderer has no coarse-to-fine)."""
    cfg["task"]["im_scale"] = IM_SCALE
    cfg["task"]["cam"]["coarse_to_fine"] = False
    return cfg


def draws():
    """Cabinet placements (xyz offsets, yaw) both packages are given."""
    rs = np.random.RandomState(21)
    return (rs.uniform(-0.05, 0.05, (E, 3)).astype(np.float32),
            rs.uniform(-np.pi / 12, np.pi / 12, E).astype(np.float32))


def actions(num_actions):
    return np.random.RandomState(5).uniform(
        -1, 1, (N_STEPS, E, num_actions)).astype(np.float32)


def pointnet_tree(seed, in_channels, out, proprio=0, max_mean=False):
    """``{"params": {"Dense_i": {"kernel" [in, out], "bias"}}}`` of a flax
    PointNet with the given head size, drawn from a numpy seed (larger
    gains than the orthogonal init, so that the policy moves the arm)."""
    rs = np.random.RandomState(seed)
    pooled = 512 * (2 if max_mean else 1) + proprio
    dims = [(in_channels, 128), (128, 256), (256, 512), (pooled, 128), (128, 32),
            (32, out)]
    return {"params": {f"Dense_{i}": {
        "kernel": (rs.randn(a, b) / np.sqrt(a)).astype(np.float32),
        "bias": (0.1 * rs.randn(b)).astype(np.float32)} for i, (a, b) in enumerate(dims)}}


def student_tree(num_actions, seed=31, max_mean=False):
    """Numpy leaves of a PointNet ``ACParams`` (actor, critic, log_std)."""
    return {"actor": pointnet_tree(seed, 3, num_actions, max_mean=max_mean),
            "critic": pointnet_tree(seed + 1, 3, 1, max_mean=max_mean),
            "log_std": np.full(num_actions, np.log(0.1), np.float32)}


@contextlib.contextmanager
def one_torch_thread():
    """Run PyTorch on one intra-op thread: the plain march and the plain FPS
    are loops of thousands of small ops, which spin-wait under the test
    run's several workers when each op is split over every core."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
