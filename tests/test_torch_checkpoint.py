"""The port reads the JAX package's checkpoints without JAX: the committed
open_drawer expert (``artifacts/open_drawer_ppo/expert_r3c_seed389/
model_30000.ckpt``) read by ``utils/checkpoint.load_jax`` and carried into
the port's ``ActorCritic`` gives the JAX ``ActorCritic``'s ``mu``, value and
log-prob on fixed observations, and its two Adam states (step count,
moments) are read leaf for leaf (f32: 1e-5 absolute, 1e-6 relative for the
O(100) values and log-probs); the reader imports nothing of
JAX, refuses foreign classes, and ``train_torch.main --resume`` evaluates the
checkpoint in the port's open_drawer env on the CPU."""

import os
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu.models.actor_critic import ActorCritic as JActorCritic
from partmanip_tpu.utils import checkpoint as jckpt
from partmanip_tpu_torch.models.actor_critic import ActorCritic as TActorCritic
from partmanip_tpu_torch.utils import checkpoint as tckpt
from partmanip_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "open_drawer_ppo", "expert_r3c_seed389",
                    "model_30000.ckpt")


@pytest.fixture(scope="module")
def both():
    """The checkpoint read by each package, and both policies in f32."""
    jd = jckpt.load(CKPT)
    td = tckpt.load_jax(CKPT)
    model_cfg = dict(jd["model_cfg"])
    model_cfg["network"] = dict(model_cfg["network"], dtype="f32")
    jac = JActorCritic(53, 10, model_cfg)
    tac = TActorCritic(53, 10, model_cfg)
    tac.load_state_dict(convert.actor_critic_from_jax(td["params"]._asdict()))
    return jd, td, jac, tac


def test_reader_keeps_every_leaf(both):
    jd, td, _, _ = both
    assert td["iteration"] == jd["iteration"] == 30000
    assert td["tricks"] == jd["tricks"] and td["obs_mode"] == "normal_state"
    for part in ("opt_actor", "opt_critic"):
        ja = [x for x in jax.tree.leaves(jd[part], is_leaf=lambda x: hasattr(x, "nu"))
              if hasattr(x, "nu")]
        ta = tckpt.jax_adam_state(td[part])
        assert len(ja) == 1 and int(ta.count) == int(ja[0].count) > 0
        for a, b in zip(jax.tree.leaves((ja[0].mu, ja[0].nu)),
                        jax.tree.leaves((ta.mu, ta.nu))):
            np.testing.assert_array_equal(np.asarray(a), b)
    jl = jax.tree.leaves((jd["params"], jd["rms"]))
    tl = jax.tree.leaves((tuple(td["params"]), tuple(td["rms"])))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_policy_matches_the_jax_actor_critic(both):
    """mu, value and log-prob of stored actions on fixed observations."""
    jd, _, jac, tac = both
    rs = np.random.RandomState(0)
    obs = rs.normal(size=(16, 53)).astype(np.float32)
    acts = rs.uniform(-0.9, 0.9, (16, 10)).astype(np.float32)
    jlogp, _, jval, jmu, _ = jac.evaluate(jd["params"], jnp.asarray(obs),
                                          jnp.asarray(acts))
    with torch.no_grad():
        tlogp, _, tval, tmu, _ = tac.evaluate(torch.as_tensor(obs),
                                              torch.as_tensor(acts))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-5, rtol=0)
    # values are O(100): f32 re-association shows at a relative 1e-7
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(
        tac.act(torch.as_tensor(obs)).detach().numpy(),
        np.asarray(jac.act(jd["params"], jnp.asarray(obs))), atol=1e-5, rtol=0)


READ_ALONE = r"""
import sys
from partmanip_tpu_torch.utils import checkpoint
from partmanip_tpu_torch.algos import ppo
d = ppo._from_jax(checkpoint.load_jax(sys.argv[1]))
print("KEYS", sorted(d["ac"])[:2], d["iteration"])
print("BANNED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax",
                                              "partmanip_tpu")))
"""


def test_reading_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", READ_ALONE, CKPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(ln.split(" ", 1) for ln in out.stdout.strip().splitlines())
    assert lines["KEYS"].endswith("30000")
    assert lines["BANNED"] == "[]"


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


def test_reader_refuses_foreign_classes(tmp_path):
    path = tmp_path / "evil.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"params": _Evil()}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tckpt.load_jax(str(path))
    assert tckpt.is_jax_checkpoint(CKPT)
    port = tmp_path / "port.ckpt"
    tckpt.save(str(port), {"iteration": 1})
    assert not tckpt.is_jax_checkpoint(str(port))


def test_cli_evaluates_the_jax_checkpoint_on_the_cpu(tmp_path):
    """``train_torch.main --taskcfg open_drawer --resume <JAX ckpt>`` at 4
    envs and 2 steps: the checkpoint is detected, its iteration carried, and
    the Test/* metrics are the JAX open_drawer env's extras, finite."""
    import train_torch
    runner = train_torch.main([
        "--taskcfg", "open_drawer", "--algocfg", "ppo", "--device", "cpu",
        "--test_only", "--algo.tricks.use_state_norm", "--resume", CKPT,
        "--algo.num_envs", "4", "--task.maxEpisodeLength", "2",
        "--task.asset.num_objects", "3",
        "--task.asset.assetRoot", str(tmp_path / "assets"),
        "--log.mode", "screen", "--log.log_root", str(tmp_path / "logs")])
    assert runner.curr_iter == 30000 and runner.total_envsteps == 983040000
    extras = ["is_open", "is_open_notgrasp", "reaching_reward", "close_reward",
              "rot_reward", "is_reached", "joint_state_reward", "raw_reward",
              "is_grasped", "success_objnum", "step_id", "open_frac",
              "succ_rate", "reward"]
    log = runner.last_log
    assert sorted(log) == sorted(f"Test/{k}_{s}" for k in extras
                                 for s in ("mean", "max"))
    assert all(np.isfinite(v) for v in log.values()), log
    assert log["Test/step_id_max"] == 2.0
    sd = convert.actor_critic_from_jax(tckpt.load_jax(CKPT)["params"]._asdict())
    for k, v in sd.items():
        assert torch.equal(runner.ac.state_dict()[k], v), k
