"""The port's command line end to end on the CPU:
``train_torch.main([... "--test_only", "--device", "cpu"])`` gives finite
``Test/*`` metrics under the names the JAX package logs, resumes a checkpoint
of the port's own format, trains PPO (two iterations, a checkpoint with both
Adam states, resumed for a third), and refuses what is not ported by naming
the ROADMAP item that will bring it.  (No JAX needed; the names of the env's
extras are compared with the JAX env in ``test_torch_slice.py``.)"""

import os

import numpy as np
import pytest
import torch

from partmanip_tpu_torch.models.actor_critic import ActorCritic as TActorCritic
from partmanip_tpu_torch.utils import checkpoint as ckpt_lib

import _torch_vision as tv
import train_torch

# extras of partmanip_tpu/envs/grasp_cube.py:_reward, + what _eval_round adds
JAX_METRICS = ["reaching_reward", "close_reward", "rot_reward", "is_reached",
               "reaching_goal_reward", "obj_movement", "raw_reward",
               "obj_height", "obj_up_flag", "step_id", "succ_rate", "reward"]


def _main_args(tmp_path, *extra):
    return ["--taskcfg", "grasp_cube", "--algocfg", "ppo", "--device", "cpu",
            "--algo.num_envs", "4", "--algo.model.network.hid_dim", "32", "32",
            "--task.maxEpisodeLength", "3", "--log.mode", "screen",
            "--log.log_root", str(tmp_path), "--exp_name", "slice_seed5",
            *extra]


def test_cli_test_only_end_to_end(tmp_path):
    torch.backends.cudnn.allow_tf32 = True           # cuDNN's default
    runner = train_torch.main(_main_args(tmp_path, "--test_only"))
    assert not torch.backends.cudnn.allow_tf32       # f32 convolutions, as JAX's
    log = runner.last_log
    assert sorted(log) == sorted(
        f"Test/{k}_{s}" for k in JAX_METRICS for s in ("mean", "max"))
    assert all(np.isfinite(v) for v in log.values()), log
    assert log["Test/step_id_max"] == 3.0
    assert runner.env.device.type == "cpu"
    sim = runner.last_env_state.sim
    assert bool(torch.isfinite(sim.robot.qpos).all())
    assert bool(torch.isfinite(sim.body.pos).all())


def test_cli_resumes_the_ports_checkpoint(tmp_path):
    donor = TActorCritic(37, 7, {
        "action_std": 0.5, "action_activate": "tanh", "clipAction": 1.0,
        "network": {"name": "MLP", "hid_dim": [32, 32], "activation": "tanh"}})
    donor.init(99)
    tricks = {"mini_adv_norm": False, "whole_adv_norm": False,
              "use_state_norm": True, "use_clipped_value_loss": False,
              "use_grad_clip": True}
    path = os.path.join(str(tmp_path), "ckpts", "model_12.ckpt")
    ckpt_lib.save(path, {
        "iteration": 12, "ac": donor.state_dict(), "total_steps": 12 * 8 * 4,
        "rms": {"n": torch.tensor(5, dtype=torch.int32),
                "mean": torch.full((1, 37), 0.25), "S": torch.full((1, 37), 2.0)},
        "update_rms": False, "tricks": tricks, "obs_mode": "normal_state"})
    runner = train_torch.main(
        _main_args(tmp_path, "--test_only", "--resume", path))
    assert runner.curr_iter == 12 and runner.total_envsteps == 12 * 8 * 4
    for k, v in donor.state_dict().items():
        assert torch.equal(runner.ac.state_dict()[k], v), k
    assert all(np.isfinite(v) for v in runner.last_log.values())
    tricks["use_state_norm"] = False
    ckpt_lib.save(path, dict(ckpt_lib.load(path), tricks=tricks))
    with pytest.raises(SystemExit, match="state-norm"):
        train_torch.main(_main_args(tmp_path, "--test_only", "--resume", path))


TEACHER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "artifacts", "open_drawer_ppo", "expert_r3c_seed389",
                       "model_30000.ckpt")


def _capture_dirs(tmp_path, group):
    pose = tmp_path / "scene_pose" / group / "slice_seed5" / "Iter0"
    video = tmp_path / "video" / group / "slice_seed5" / "Iter0"
    return pose, video


def _check_poses(pose_dir, steps, envs, obs, actions):
    files = sorted(os.listdir(pose_dir), key=lambda f: int(f.split(".")[0]))
    assert files == [f"{i}.npy" for i in range(steps)]
    d = np.load(pose_dir / "0.npy", allow_pickle=True).item()
    assert {k: v.shape for k, v in d.items()} == {
        "rot": (envs, 12, 3, 3), "pos": (envs, 12, 3), "state": (envs, obs),
        "action": (envs, actions), "success": (envs,)}
    assert d["success"].dtype == bool and np.isfinite(d["rot"]).all()


def _check_frames(video_dir, steps):
    """cv2 present: the mp4 (frames removed); absent: the .npy frames."""
    names = sorted(os.listdir(video_dir))
    assert names == ["video.mp4"] or names == [f"{i:04d}.npy" for i in range(steps)], names


@pytest.mark.parametrize("extra,roadmap_item", [
    (("--taskcfg", "open_drawer", "--algocfg", "dagger", "--algo.teacher", TEACHER,
      "--algo.obs_mode", "normal_state", "--algo.model.network.name", "MLP",
      "--algo.model.network.hid_dim", "16", "--test_only", "--save_video",
      "--algo.eval_round", "1", "--task.asset.num_objects", "2",
      "--task.asset.assetRoot", "{tmp}"), None),
    (("--test_only", "--save_video", "--save_pose"), None),
    (("--test_only", "--save_pose"), None),
    (("--test_only", "--save_video"), None),
    (("--test_only", "--parallel.num_devices", "2"), None),
    (("--test_only", "--sim.coriolis"), None),
], ids=["dagger", "vision_obs", "save_pose",
        "save_video", "multi_gpu", "coriolis"])
def test_unported_parts_raise_naming_the_roadmap(tmp_path, monkeypatch, extra, roadmap_item):
    """What the port does not run raises, naming its ROADMAP queue: no
    case is left, each runs.  The tooling cases: the evaluation capture
    writes a pose dict per step (``save_pose``), frames made into a video
    (``save_video``, at a small ``VIDEO_RES`` on the CPU), or both from the
    rendered path (``vision_obs``); the DAgger evaluation ignores
    ``--save_video``, as the JAX package's does; ``--sim.coriolis``
    evaluates with the velocity-product term; and ``parallel.num_devices
    2`` evaluates on two gloo ranks of two envs each (rank 0's metrics come
    back; tests/test_torch_parallel.py holds them against one process)."""
    from partmanip_tpu_torch.algos import ppo
    monkeypatch.setattr(ppo, "VIDEO_RES", (24, 48))
    args = _main_args(tmp_path) + [a.format(tmp=tmp_path) for a in extra]
    if roadmap_item is not None:
        with pytest.raises(NotImplementedError, match=roadmap_item):
            train_torch.main(args)
        return
    runner = train_torch.main(args)
    assert all(np.isfinite(v) for v in runner.last_log.values())
    group = "open_drawer_dagger" if "dagger" in extra else "grasp_cube_ppo"
    pose_dir, video_dir = _capture_dirs(tmp_path, group)
    assert pose_dir.exists() == ("--save_pose" in extra)
    assert video_dir.exists() == ("--save_video" in extra and "dagger" not in extra)
    if pose_dir.exists():
        _check_poses(pose_dir, 3, 4, 37, 7)
    if video_dir.exists():
        _check_frames(video_dir, 3)
    if "--sim.coriolis" in extra:
        assert runner.env.scene.params.coriolis


@pytest.fixture
def one_thread():
    with tv.one_torch_thread():
        yield


def test_cli_trains_and_resumes(tmp_path, one_thread):
    """PPO without ``--test_only``: two iterations on the CPU give finite
    ``Train/*`` metrics (every minibatch update applied, as the JAX
    package's smoke run expects at init), save ``model_2.ckpt`` with both
    Adam states, and a run resumed from it continues at iteration 3 from
    those states."""
    args = _main_args(tmp_path, "--algo.n_steps", "2", "--algo.max_iterations", "2",
                      "--algo.eval_frequence", "2", "--algo.save_frequence", "2")
    runner = train_torch.main(args)
    log = runner.last_log
    assert runner.curr_iter == 2 and runner.total_envsteps == 2 * 2 * 4
    assert all(np.isfinite(v) for v in log.values()), log
    assert log["Train/kl_update_count"] == 5 * 8
    for k in ("Train/value_function_loss", "Train/surrogate_loss", "Train/kl",
              "Train/raw_reward_mean", "Train/value_pred_mean"):
        assert k in log, k
    ckpt = ckpt_lib.load(os.path.join(runner.save_ckpt_dir, "model_2.ckpt"))
    assert ckpt["opt_actor"]["count"] == ckpt["opt_critic"]["count"] == 2 * 5 * 8
    assert set(ckpt["opt_actor"]["mu"]) == {n for n in ckpt["ac"] if not n.startswith("critic")}
    # the later --algo.max_iterations wins
    resumed = train_torch.main(args + [
        "--algo.max_iterations", "3", "--resume",
        os.path.join(runner.save_ckpt_dir, "model_2.ckpt")])
    assert resumed.curr_iter == 3 and resumed.last_log["Progress/total_steps"] == 3
    assert resumed.last_log["Train/kl_update_count"] == 5 * 8
    assert all(torch.isfinite(p).all() for p in resumed.ac.parameters())
