"""The port's tooling against the JAX package's, on the CPU:
``utils/profiler.py``, ``utils/video.py`` and ``utils/viewer.py`` as
``tests/test_utils_misc.py`` holds the JAX package's (plus the Chrome
trace of ``profiler.trace`` and the ``.npy`` fallback without ``cv2``);
``data_proc_torch.py``'s subcommands (``obj2urdf`` and ``genbox`` write the
JAX tool's bytes; ``check_pose`` reads a pose dump; ``filter_success``;
``armmask`` against the JAX package's ``render_depth_seg`` at 36×64, the
masks equal on 99.5 % of the pixels, a silhouette pixel on a sphere's rim
may flip); and one control step of ``tune_pid_torch.py``'s harness through
the plain version against the JAX engine on the same scene (4 inner steps
of a free arm: qpos 1e-5, qvel 1e-3, tip position and gripper 1e-5)."""

import importlib.util
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import data_proc_torch
import tune_pid_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_data_proc():
    spec = importlib.util.spec_from_file_location(
        "jax_data_proc", os.path.join(ROOT, "tools", "data_proc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_time_counter():
    from partmanip_tpu_torch.utils import profiler
    profiler.reset()

    @profiler.TimeCounter
    def f():
        return 1

    for _ in range(3):
        f()
    with profiler.TimeCounterSession("sess"):
        pass
    assert profiler._STATS[f.__qualname__][0] == 3
    assert profiler._STATS["sess"][0] == 1
    profiler.reset()
    assert not profiler._STATS


def test_trace_writes_a_chrome_trace(tmp_path):
    import json
    from partmanip_tpu_torch.utils import profiler
    with profiler.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_viewer_dump(tmp_path):
    from partmanip_tpu_torch.utils import viewer
    p = tmp_path / "pc.txt"
    pts = np.random.RandomState(0).randn(10, 3)
    viewer.dump_pointcloud(str(p), torch.as_tensor(pts), colors=np.ones((10, 3)))
    np.testing.assert_allclose(np.loadtxt(p), np.concatenate([pts, np.ones((10, 3))], -1))
    v = viewer.PointCloudViewer(str(tmp_path / "snaps"))
    v.update(np.random.randn(20, 3))
    assert v.count == 1 and len(os.listdir(tmp_path / "snaps")) == 1


def test_frames_and_video(tmp_path, monkeypatch):
    """Depth and RGB frames as png and a video from them (cv2 present), or
    as .npy and no video (cv2 absent), as the JAX package writes them."""
    from partmanip_tpu.utils import video as jvideo
    from partmanip_tpu_torch.utils import video
    rgb = np.random.RandomState(1).rand(16, 24, 3).astype(np.float32)
    for mod, d in ((video, tmp_path / "port"), (jvideo, tmp_path / "jax")):
        mod.save_depth_frame(str(d / "depth.png"), np.ones((8, 8)) * 1.5)
        for i in range(3):
            mod.save_rgb_frame(str(d / "frames" / f"{i:04d}.png"), rgb)
    for name in ("depth.png", "frames/0000.png"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    out = video.path_to_video(str(tmp_path / "port" / "frames"))
    assert out is not None and os.listdir(tmp_path / "port" / "frames") == ["video.mp4"]
    monkeypatch.setitem(sys.modules, "cv2", None)
    video.save_rgb_frame(str(tmp_path / "npy" / "0000.png"), rgb)
    assert np.array_equal(np.load(tmp_path / "npy" / "0000.npy"),
                          (255 * np.clip(rgb, 0, 1)).astype(np.uint8))
    assert video.path_to_video(str(tmp_path / "npy")) is None


def test_obj2urdf_and_genbox_write_the_jax_tools_bytes(tmp_path):
    jtool = _jax_data_proc()
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    data_proc_torch.main(["genbox", "--out", str(tmp_path / "port" / "box.obj"), "--half", "0.03"])
    jtool.cmd_genbox(type("A", (), {"out": str(tmp_path / "jax" / "box.obj"), "half": 0.03}))
    assert (tmp_path / "port" / "box.obj").read_bytes() == (tmp_path / "jax" / "box.obj").read_bytes()
    for d, fn in (("port", lambda a: data_proc_torch.cmd_obj2urdf(a)), ("jax", jtool.cmd_obj2urdf)):
        fn(type("A", (), {"mesh": str(tmp_path / d / "box.obj"), "out": None, "mass": 0.2,
                          "scale": 1.5}))
    assert (tmp_path / "port" / "box.urdf").read_bytes() == (tmp_path / "jax" / "box.urdf").read_bytes()


def _pose_dump(d, steps=3, E=2, M=12):
    rs = np.random.RandomState(3)
    d.mkdir(parents=True)
    for i in range(steps):
        q, _ = np.linalg.qr(rs.normal(size=(E * M, 3, 3)))
        np.save(d / f"{i}.npy", {"rot": q.reshape(E, M, 3, 3).astype(np.float32),
                                 "pos": rs.uniform(-0.5, 0.5, (E, M, 3)).astype(np.float32),
                                 "success": np.array([True, False])})


def test_check_pose_and_filter_success(tmp_path, capsys):
    _pose_dump(tmp_path / "poses")
    data_proc_torch.main(["check_pose", str(tmp_path / "poses")])
    assert "pose dumps OK" in capsys.readouterr().out
    bad = np.load(tmp_path / "poses" / "1.npy", allow_pickle=True).item()
    bad["pos"][0, 0] = 9.0
    np.save(tmp_path / "poses" / "1.npy", bad)
    with pytest.raises(AssertionError, match="workspace"):
        data_proc_torch.main(["check_pose", str(tmp_path / "poses")])
    for scene, ok in (("scene_00000", True), ("scene_00001", False)):
        (tmp_path / "demos" / scene).mkdir(parents=True)
        np.save(tmp_path / "demos" / scene / "step_00000.npy", {"success": np.array([ok, ok])})
    assert data_proc_torch.main(["filter_success", str(tmp_path / "demos")]) == (1, 1)
    assert data_proc_torch.main(["filter_success", str(tmp_path / "demos"), "--apply"]) == (1, 1)
    assert os.listdir(tmp_path / "demos") == ["scene_00000"]


def test_armmask_matches_jax_render_depth_seg(tmp_path):
    from partmanip_tpu.ops import raymarch as jray
    from partmanip_tpu.utils import camera
    _pose_dump(tmp_path / "poses", steps=1)
    pos = np.load(tmp_path / "poses" / "0.npy", allow_pickle=True).item()["pos"]
    pos[0] = pos[0] * 0.3 + np.array([0.0, 0.0, 0.2], np.float32)   # in the camera's view
    np.save(tmp_path / "poses" / "0.npy", {"pos": pos, "rot": np.zeros((2, 12, 3, 3))})
    data_proc_torch.main(["armmask", str(tmp_path / "poses"), "--out", str(tmp_path / "masks"),
                          "--width", "64", "--height", "36", "--device", "cpu"])
    got = np.load(tmp_path / "masks" / "0_mask.npy")
    p = data_proc_torch.armmask_prims(pos[0], "cpu")
    poses = camera.gen_camera_poses([0, 0, 0.2], radius=1.0, num_views=1)
    intr = camera.camera_intrinsics(64, 36)
    _, seg = jax.jit(lambda *x: jray.render_depth_seg(
        jray.ScenePrims(*x, ground=False), poses, intr, 36, 64))(
        *[jnp.asarray(x.numpy()) for x in p[:-1]])
    want = (np.asarray(seg[0, 0]) == 1).astype(np.uint8) * 255
    assert got.shape == want.shape == (36, 64) and got.dtype == np.uint8
    assert (want > 0).mean() > 0.02, "the arm is not in view"
    assert (got == want).mean() >= 0.995


@pytest.fixture(scope="module")
def calib():
    """The calibration scene of tune_pid_torch.py on the CPU, 6 envs."""
    return tune_pid_torch.build(6, torch.device("cpu"))


def test_tune_pid_control_step_matches_jax(calib):
    """One control step of the calibration harness (ik targets from a
    random command, two physics steps of the robot alone) through the
    port's plain version and the JAX engine, from the same state."""
    from partmanip_tpu.envs import control as jcontrol
    from partmanip_tpu.sim import engine as jengine, franka as jfranka
    from partmanip_tpu.sim import kinematics as jkin
    from partmanip_tpu.sim.types import SimParams as JParams, TreeState as JTree
    scene, state, ctrl = calib
    built = jfranka.build_franka(mobile=True)
    params = JParams(coriolis=False, inner_substeps=2, use_fused=False)
    jscene = jengine.SceneSpec(robot=built.spec, spheres=jfranka.franka_collision_spheres(built),
                               params=params)
    bi = jfranka.franka_body_indices(built)
    jctrl = jcontrol.FrankaControlConfig(drive_mode="ik", mobile=True, dt=params.dt,
                                         num_dofs=12, lefttip_idx=bi["lefttip"],
                                         righttip_idx=bi["righttip"])
    a = np.random.RandomState(1).uniform(-1, 1, (6, 10)).astype(np.float32)

    @jax.jit
    def jstep(st, action):
        fk = jkin.forward_kinematics(jscene.robot, st.robot)
        view = jcontrol.robot_view(jctrl, jscene.robot, fk, st.robot)
        tgt = jcontrol.compute_targets(jctrl, jscene.robot, view, action)
        for _ in range(2):
            st = jengine.physics_step(jscene, st, tgt)
        fk2 = jkin.forward_kinematics(jscene.robot, st.robot)
        return st, jcontrol.robot_view(jctrl, jscene.robot, fk2, st.robot)

    jst = jengine.SceneState(robot=JTree(**{k: jnp.asarray(v.numpy())
                                            for k, v in state.robot._asdict().items()}))
    want, wview = jstep(jst, jnp.asarray(a))
    got, _, gview = tune_pid_torch.step(scene, ctrl, state, torch.as_tensor(a), 2)
    assert float(np.abs(np.asarray(want.robot.qvel)).max()) > 1e-2
    close = lambda g, w, tol: np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=0)
    close(got.robot.qpos, want.robot.qpos, 1e-5)
    close(got.robot.qvel, want.robot.qvel, 1e-3)
    close(gview.tip_pos, wview.tip_pos, 1e-5)
    close(gview.gripper_length, wview.gripper_length, 1e-5)
