"""What a rank runs in ``tests/test_torch_parallel.py`` (started by
``parallel/mesh.launch``, one spawned process each): importable without
JAX, so that a rank starts in a second or two."""

from types import SimpleNamespace

import numpy as np
import torch

from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.algos import ppo as tppo_mod
from partmanip_tpu_torch.algos import rms as trms
from partmanip_tpu_torch.algos import storage as tstorage
from partmanip_tpu_torch.parallel import mesh as mesh_lib


def ppo_cfg(num_envs, n_steps, module=tconfig, **algo):
    """The PPO config of the parity tests (open_drawer's ppo.yaml at small
    widths: MLP 16-16 in f32, 2 epochs of 4 minibatches, lr 1e-3), made by
    ``module``'s ``process_cfgs`` (the port's config module by default)."""
    cfg, _ = module.process_cfgs(["--taskcfg", "open_drawer", "--algocfg", "ppo"])
    a = cfg["algo"]
    a.update(num_envs=num_envs, n_steps=n_steps, n_updates=2, n_minibatches=4, lr=1e-3)
    a["model"]["network"].update(hid_dim=[16, 16], dtype="f32")
    for k, v in algo.items():
        if k in a["tricks"]:
            a["tricks"][k] = v
        else:
            a[k] = v
    return a


def train_iteration(state_dict, rollout, curr_obs, infos, rms, idx, algo):
    """One ``PPO._train_iteration`` of this rank on its env columns of a
    fixed rollout (time-major numpy ``[T, E, ...]``), with fixed minibatch
    indices; without an active mesh, of one process on all of it.  Returns
    (parameters, Adam states, metrics) as numpy / floats."""
    torch.set_num_threads(1)
    mesh = mesh_lib.active_mesh()
    T, E = rollout["rewards"].shape
    cols = slice(None) if mesh is None else slice(
        mesh.rank * E // mesh.size, (mesh.rank + 1) * E // mesh.size)
    El = len(range(E)[cols])
    O, A = rollout["observations"].shape[-1], rollout["actions"].shape[-1]
    cfg = ppo_cfg(E, T, **algo)
    cfg["parallel"] = {"num_devices": 1 if mesh is None else mesh.size}
    env = SimpleNamespace(num_obs={"normal_state": O}, num_actions=A, max_episode_length=5,
                          reset=lambda s: s, device=torch.device("cpu"), mesh=mesh,
                          num_envs=El)
    tp = tppo_mod.PPO(env, cfg, SimpleNamespace(save_ckpt_dir="/nonexistent"))
    tp.ac.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    opt_a, opt_c = tp._optimizers()
    ts = tppo_mod.PPOTrainState(
        rms=trms.RMSState(*[torch.as_tensor(x) for x in rms]),
        update_rms=torch.tensor(False), curr_obs=torch.as_tensor(curr_obs[cols]),
        rng=torch.Generator().manual_seed(0), opt_actor=opt_a, opt_critic=opt_c)
    ro = tstorage.Rollout(**{k: torch.as_tensor(v[:, cols]) for k, v in rollout.items()})
    inf = {k: torch.as_tensor(v if k in mesh_lib.REPLICATED_FIELDS else v[:, cols])
           for k, v in infos.items()}
    tp._rollout = lambda ts_, es: (ts_, es, ro, inf)
    keep = tstorage.minibatch_indices
    tstorage.minibatch_indices = lambda *a, **k: torch.as_tensor(idx, dtype=torch.int64)
    try:
        ts, _, metrics = tp._train_iteration(ts, None, 1e-3)
    finally:
        tstorage.minibatch_indices = keep
    params = {k: v.detach().numpy().copy() for k, v in tp.ac.state_dict().items()}
    adam = {part: {"count": o.count, "mu": {k: v.numpy().copy() for k, v in o.state_dict()["mu"].items()}}
            for part, o in (("actor", ts.opt_actor), ("critic", ts.opt_critic))}
    return params, adam, {k: float(v) for k, v in metrics.items()}


def assets_then_fail(root, n):
    """Every rank asks for the same procedural cabinets at once and parses
    them (link and box counts, each > 0); the ranks check that they parsed
    the same; then rank 1 raises, naming what it parsed, while rank 0
    waits in a collective that never completes, until it is stopped."""
    from partmanip_tpu_torch.envs import assets
    mesh = mesh_lib.active_mesh()
    dirs = assets.ensure_drawer_assets(root, "train", n)
    parsed = [assets.parse_urdf(f"{d}/mobility_new.urdf") for d in dirs]
    counts = torch.tensor([[len(p.links), len(p.boxes)] for p in parsed], dtype=torch.float64)
    assert len(parsed) == n and bool((counts > 0).all()), counts
    both = mesh_lib.all_sum(mesh, counts)
    assert torch.equal(both, 2 * counts), f"rank {mesh.rank}: {counts} vs {both - counts}"
    if mesh.rank == 1:
        raise ValueError(f"rank one fails on purpose after {n} cabinets")
    mesh_lib.all_sum(mesh, torch.ones(1))
    return mesh.rank


def np_rms(O):
    return (np.zeros((), np.int32), np.zeros((1, O), np.float32),
            np.full((1, O), 1e-4, np.float32))
