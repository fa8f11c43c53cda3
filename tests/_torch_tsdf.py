"""Shared pieces of the TSDF student's parity tests
(``tests/test_torch_conv3d.py``, ``test_torch_bc.py``,
``test_torch_dagger_tsdf.py``, ``test_torch_collect_demos.py``): flax
parameter trees of the 3-D conv nets drawn with numpy, and a small demo
tree on disk."""

import os

import numpy as np

CONV3D = ((16, 5, 3), (32, 3, 3), (32, 3, 2))        # Conv3DNet: features, kernel, stride
POOL_CONV3D = ((16, 5, 2), (32, 3, 2), (64, 3, 2))   # PoolConv3DNet
POOL = 4


def conv_side(res, layers, pool=0):
    """The volume's side after the convs (symmetric padding k // 2) and the
    optional max pool."""
    for _, k, s in layers:
        res = (res + 2 * (k // 2) - k) // s + 1
    return (res - pool) // pool + 1 if pool else res


def conv3d_tree(seed, res, out, proprio=0, network="Conv3DNet"):
    """``{"params": {"Conv_i": {"kernel" [k, k, k, in, out], "bias"},
    "Dense_i": {...}}}`` of a flax Conv3DNet / PoolConv3DNet, drawn from a
    numpy seed (unit-variance layers, small biases)."""
    rs = np.random.RandomState(seed)
    pool = network == "PoolConv3DNet"
    layers = POOL_CONV3D if pool else CONV3D
    tree, c = {}, 1
    for i, (f, k, _) in enumerate(layers):
        fan_in = k ** 3 * c
        tree[f"Conv_{i}"] = {
            "kernel": (rs.randn(k, k, k, c, f) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.1 * rs.randn(f)).astype(np.float32)}
        c = f
    flat = c * conv_side(res, layers, POOL if pool else 0) ** 3 + (0 if pool else proprio)
    hidden = 32 if pool else 256
    for i, (a, b) in enumerate(((flat, hidden), (hidden, out))):
        tree[f"Dense_{i}"] = {"kernel": (rs.randn(a, b) / np.sqrt(a)).astype(np.float32),
                              "bias": (0.1 * rs.randn(b)).astype(np.float32)}
    return {"params": tree}


def student_tree(res, num_actions, proprio=0, seed=41, log_std=0.1, network="Conv3DNet"):
    """Numpy leaves of a Conv3DNet ``ACParams`` (actor, critic, log_std)."""
    return {"actor": conv3d_tree(seed, res, num_actions, proprio, network),
            "critic": conv3d_tree(seed + 1, res, 1, proprio, network),
            "log_std": np.full(num_actions, np.log(log_std), np.float32)}


def model_cfg(network="Conv3DNet", action_std=0.1):
    return {"action_std": action_std, "action_activate": "tanh", "clipAction": 1.0,
            "network": {"name": network, "activation": "tanh"}}


def write_demo_tree(root, res, num_actions, tea_obs, proprio=0, scenes=2, steps=5, seed=0):
    """A ``scene_*/step_*.npy`` tree of random volumes, proprio, teacher obs
    and actions (bf16-representable volumes, as the collector writes)."""
    import torch
    rs = np.random.RandomState(seed)
    for s in range(scenes):
        d = os.path.join(root, f"scene_{s:05d}")
        os.makedirs(d, exist_ok=True)
        for t in range(steps):
            vol = torch.as_tensor(rs.uniform(-1, 1, (res,) * 3).astype(np.float32))
            np.save(os.path.join(d, f"step_{t:05d}.npy"), {
                "tsdf": vol.bfloat16().float().numpy(),
                "proprio_state": rs.randn(proprio).astype(np.float32),
                "action": np.tanh(rs.randn(num_actions)).astype(np.float32),
                "tea_obs": rs.randn(tea_obs).astype(np.float32)})
    return root
