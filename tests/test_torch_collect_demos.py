"""``collect_demos_torch.py`` (the twin of ``tools/collect_demos.py``) on the
CPU at 2 envs, one 3-step episode and res 8: the tree's layout (the keys
and shapes ``algos/bc.load_demo_tree`` and ``DAgger.load_offline`` read,
``scene_XXXXX/step_XXXXX.npy``), the volume rounded through bf16 as the JAX
tool stores it, the proprio dims stripped from it and kept beside it, and
the ``action`` rows equal to the port's teacher on the ``tea_obs`` rows
(bit for bit: the same batched forward as in the rollout).  The same
expert and states give the same files."""

import os

import numpy as np
import pytest
import torch

import _torch_dagger as td
import _torch_vision as tv
import collect_demos_torch

RES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _collect(out, root, task="open_drawer", teacher=tv.TEACHER, *extra):
    args = ["--device", "cpu", "--taskcfg", task, "--algo.num_envs", "2",
            "--task.maxEpisodeLength", "3", "--task.obs_mode.tsdf.resolution", str(RES),
            "--teacher", teacher, "--out", str(out), *extra]
    if task == "open_drawer":
        args += ["--task.asset.num_objects", "3", "--task.asset.assetRoot", str(root)]
    return collect_demos_torch.main(args)


def _read(out):
    return {(s, f): np.load(os.path.join(out, s, f), allow_pickle=True).item()
            for s in sorted(os.listdir(out)) for f in sorted(os.listdir(os.path.join(out, s)))}


def _teacher_rows(files, teacher):
    """The teacher's action on each step's ``tea_obs`` rows, batched over the
    scenes as the rollout batches its envs."""
    steps = sorted({f for _, f in files})
    for f in steps:
        keys = sorted(k for k in files if k[1] == f)
        tea = torch.as_tensor(np.stack([files[k]["tea_obs"] for k in keys]))
        with torch.no_grad():
            act = teacher.act(tea).numpy()
        yield keys, act


def test_open_drawer_tree(tmp_path):
    out = tmp_path / "demos"
    torch.backends.cudnn.allow_tf32 = True           # cuDNN's default
    summary = _collect(out, tmp_path / "assets")
    assert not torch.backends.cudnn.allow_tf32       # f32 convolutions, as JAX's
    assert (summary["scenes"], summary["rows"], summary["episodes"]) == (2, 6, 1)
    files = _read(out)
    assert sorted(files) == [(f"scene_{s:05d}", f"step_{t:05d}.npy")
                             for s in range(2) for t in range(3)]
    for d in files.values():
        assert sorted(d) == ["action", "proprio_state", "tea_obs", "tsdf"]
        assert d["tsdf"].shape == (RES,) * 3 and d["tsdf"].dtype == np.float32
        assert d["action"].shape == (10,) and d["tea_obs"].shape == (53,)
        assert d["proprio_state"].shape == (0,)
        np.testing.assert_array_equal(
            torch.from_numpy(d["tsdf"]).bfloat16().float().numpy(), d["tsdf"])
        assert (np.abs(d["tsdf"]) <= 1).all() and (d["tsdf"] < 1).any()
    env = type("Env", (), {"num_obs": {"normal_state": 53}, "num_actions": 10})()
    teacher, rms, mode = collect_demos_torch.load_teacher(tv.TEACHER, env, "cpu")
    assert mode == "normal_state" and rms is None
    for keys, act in _teacher_rows(files, teacher):
        np.testing.assert_array_equal(np.stack([files[k]["action"] for k in keys]), act)
    again = tmp_path / "again"
    _collect(again, tmp_path / "assets")
    for k, d in _read(again).items():
        for name, v in d.items():
            np.testing.assert_array_equal(v, files[k][name], err_msg=str((k, name)))


def test_grasp_cube_tree_keeps_the_proprio_beside_the_volume(tmp_path):
    """grasp_cube's TSDF obs carries the 25 proprio dims: the collector
    writes the volume without them and them as ``proprio_state``; a JAX
    package teacher (normal_state MLP) labels."""
    teacher_path = td.write_teacher(os.path.join(tmp_path, "teacher.ckpt"), 37, 7)
    out = tmp_path / "demos"
    _collect(out, tmp_path, "grasp_cube", teacher_path)
    files = _read(out)
    assert len(files) == 6
    for d in files.values():
        assert d["tsdf"].shape == (RES,) * 3 and d["proprio_state"].shape == (25,)
        assert d["action"].shape == (7,) and d["tea_obs"].shape == (37,)
    env = type("Env", (), {"num_obs": {"normal_state": 37}, "num_actions": 7})()
    teacher, _, _ = collect_demos_torch.load_teacher(teacher_path, env, "cpu")
    for keys, act in _teacher_rows(files, teacher):
        np.testing.assert_array_equal(np.stack([files[k]["action"] for k in keys]), act)
    # the proprio written is the one the observation carried: tip pose,
    # normalised qpos and qvel, the first 7 and the last 18 of the state
    for d in files.values():
        np.testing.assert_allclose(d["proprio_state"][:7], d["tea_obs"][:7], rtol=0, atol=0)
        np.testing.assert_allclose(d["proprio_state"][7:], d["tea_obs"][19:], rtol=0, atol=0)
    empty = tmp_path / "only_success"
    summary = _collect(empty, tmp_path, "grasp_cube", teacher_path, "--only_success")
    assert summary["scenes"] == 0 and not os.path.exists(empty)
