"""Shared pieces of the DAgger training parity tests
(``tests/test_torch_dagger_train.py``, ``tests/test_torch_dagger_loop.py``)
and of ``tests/golden_torch/make_dagger_golden.py``: the tiny grasp_cube
state env both packages build, the numpy-drawn weights both networks get,
and the JAX-format teacher checkpoint they label with."""

import os

import numpy as np

E = 2                     # envs
N_STEPS = 2               # collection steps
BUF_SIZE = 3              # ring buffer rows per env: capacity 6
START_WRITE, START_SIZE = 4, 4   # the buffer the collection appends to (it wraps)
HID = [16]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_torch", "dagger_collect.npz")
FLAGS = ["--taskcfg", "grasp_cube", "--algocfg", "dagger", "--algo.num_envs", str(E),
         "--sim.inner_substeps", "1", "--task.maxEpisodeLength", "6",
         "--algo.obs_mode", "normal_state", "--algo.model.network.name", "MLP",
         "--algo.add_proprio_obs",          # flips the YAML's True: no proprio concat
         "--algo.n_steps", str(N_STEPS), "--algo.buf_size", str(BUF_SIZE)]


def model_cfg(network="MLP", hid=HID):
    """An f32 actor-critic config (both packages' MLP computes in bf16 by
    default)."""
    return {"action_std": 0.1, "action_activate": "tanh", "clipAction": 1.0,
            "network": {"name": network, "hid_dim": list(hid), "activation": "tanh",
                        "dtype": "f32"}}


def mlp_tree(seed, dims):
    """``{"params": {"Dense_i": {"kernel" [in, out], "bias"}}}`` of a flax
    MLP with layer sizes ``dims``, drawn from a numpy seed."""
    rs = np.random.RandomState(seed)
    return {"params": {f"Dense_{i}": {
        "kernel": (rs.randn(a, b) / np.sqrt(a)).astype(np.float32),
        "bias": (0.1 * rs.randn(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}}


def ac_tree(seed, num_obs, num_actions, hid=HID):
    """Numpy leaves of an MLP ``ACParams`` (actor, critic, log_std)."""
    return {"actor": mlp_tree(seed, [num_obs, *hid, num_actions]),
            "critic": mlp_tree(seed + 1, [num_obs, *hid, 1]),
            "log_std": np.full(num_actions, np.log(0.1), np.float32)}


def write_teacher(path, num_obs, num_actions, seed=1, rms=None):
    """A PPO checkpoint of the JAX package on ``normal_state``: an MLP
    teacher drawn from ``seed``; with ``rms`` ({n, mean, S} numpy) a
    state-norm teacher."""
    from partmanip_tpu.algos.rms import RMSState
    from partmanip_tpu.models.actor_critic import ACParams
    from partmanip_tpu.utils import checkpoint as jckpt
    tree = ac_tree(seed, num_obs, num_actions, hid=[32])
    jckpt.save(path, {
        "iteration": 0, "params": ACParams(**tree), "opt_actor": None, "opt_critic": None,
        "rms": None if rms is None else RMSState(**rms), "update_rms": False,
        "total_steps": 0,
        "tricks": {"mini_adv_norm": False, "whole_adv_norm": False,
                   "use_state_norm": rms is not None, "use_clipped_value_loss": False,
                   "use_grad_clip": True},
        "obs_mode": "normal_state", "model_cfg": model_cfg(hid=[32])})
    return path


def cube_draws():
    """Cube placements (xy offsets, yaw) both packages are given."""
    rs = np.random.RandomState(21)
    return (rs.uniform(-0.15, 0.15, (E, 2)).astype(np.float32),
            rs.uniform(-np.pi, np.pi, E).astype(np.float32))


def start_buffer(num_obs):
    """The rows the collection appends to: [cap, O] student and teacher
    obs, of which the first START_SIZE count as written."""
    rs = np.random.RandomState(9)
    cap = BUF_SIZE * E
    return (rs.randn(cap, num_obs).astype(np.float32),
            rs.randn(cap, num_obs).astype(np.float32))
