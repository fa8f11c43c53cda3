"""Shared pieces of the image-student DAgger parity test
(``tests/test_torch_dagger_image.py``) and of the script that makes its
JAX reference values (``tests/golden_torch/make_image_dagger_golden.py``):
the tiny grasp_cube depth_img configuration both packages build, and flax
ResNet weights both students get (flax's init from a key, with batch
statistics drawn from a numpy seed)."""

import os

import numpy as np

E = 2                     # envs
N_STEPS = 2               # collection steps
BUF_SIZE = 3              # ring buffer rows per env: capacity 6
START_WRITE, START_SIZE = 4, 4   # the buffer the collection appends to (it wraps)
PROPRIO = 25
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_torch", "dagger_collect_depth_img.npz")
FLAGS = ["--taskcfg", "grasp_cube", "--algocfg", "dagger", "--algo.num_envs", str(E),
         "--sim.inner_substeps", "1", "--task.maxEpisodeLength", "6",
         "--algo.obs_mode", "depth_img", "--algo.model.network.name", "depthResNet",
         "--algo.n_steps", str(N_STEPS), "--algo.buf_size", str(BUF_SIZE)]


def model_cfg(name="depthResNet"):
    return {"action_std": 0.1, "action_activate": "tanh", "clipAction": 1.0,
            "network": {"name": name, "activation": "tanh", "hid_dim": [16]}}


def resnet_variables(name, seed, num_inputs, out, proprio):
    """A flax ResNet / depthResNet variables dict (numpy leaves) at 72×128:
    flax's init from ``PRNGKey(seed)``, then batch statistics drawn from a
    numpy seed (means ≈ N(0, 0.1²), variances in [0.5, 1.5])."""
    import jax
    import jax.numpy as jnp
    from partmanip_tpu.models import networks
    net = networks.make_network(name, out, model_cfg(name)["network"], proprio)
    v = jax.jit(net.init)(jax.random.PRNGKey(seed), jnp.zeros((1, num_inputs)))
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.array(x)
        if path[-1].key == "mean":
            return (0.1 * rs.randn(*x.shape)).astype(np.float32)
        if path[-1].key == "var":
            return (0.5 + rs.rand(*x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, v)


def student_tree(name, num_inputs, num_actions, proprio, seed=31):
    """Numpy leaves of a ResNet ``ACParams`` (actor, critic, log_std)."""
    return {"actor": resnet_variables(name, seed, num_inputs, num_actions, proprio),
            "critic": resnet_variables(name, seed + 1, num_inputs, 1, proprio),
            "log_std": np.full(num_actions, np.log(0.1), np.float32)}


def start_buffer(num_stu, num_tea):
    """The rows the collection appends to: [cap, O] student rows (depth-like
    values in bf16) and teacher rows, of which the first START_SIZE count as
    written."""
    import torch
    rs = np.random.RandomState(9)
    cap = BUF_SIZE * E
    stu = torch.as_tensor(rs.uniform(0, 2, (cap, num_stu)).astype(np.float32))
    return (stu.to(torch.bfloat16).float().numpy(),
            rs.randn(cap, num_tea).astype(np.float32))
