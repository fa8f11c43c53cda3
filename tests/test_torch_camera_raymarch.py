"""The camera rig and the depth renderer of the port against the JAX
package, on the CPU (the plain versions of kernel B2).

* camera poses, intrinsics and the Kabsch fit to 1e-6;
* the exact unculled march (``cull=False``) against
  ``raymarch.render_depth`` (the JAX package's XLA path, which does not
  cull) and the culled coarse-to-fine march against
  ``raymarch_tpu.render_depth_tpu(..., interpret=True, coarse_to_fine=True)``
  (the Pallas kernel, interpreted; ``test_torch_raymarch_cull.py`` holds
  the culling itself):
  99.9 % of pixels within 1e-4 m and at most 1e-4 m where both hit
  (``tests/test_vision.py`` asks 98 % within 1e-3 and 1e-2);
* the coarse-to-fine start (3×3 min filter, margins, 4× upsample) equal to
  the TPU wrapper's ``lax.reduce_window`` expression;
* routing: CPU prims never reach the kernel, the kernel refuses CPU
  tensors, and its build command and C signature."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv

from partmanip_tpu.ops import raymarch as jrm
from partmanip_tpu.ops import raymarch_tpu
from partmanip_tpu.utils import camera as jcam
from partmanip_tpu_torch.ops import raymarch as trm
from partmanip_tpu_torch.ops import raymarch_cuda
from partmanip_tpu_torch.utils import camera as tcam
from partmanip_tpu_torch.utils import cuda_lib

E = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _prims(pkg):
    """Two spheres and two rotated boxes (one dead) over the ground."""
    a = dict(
        sphere_center=np.array([[[0.0, 0, 0.08], [0.1, 0.05, 0.15]]] * E, np.float32),
        sphere_radius=np.full((E, 2), 0.05, np.float32),
        box_pos=np.array([[[-0.1, 0, 0.1], [0.2, -0.1, 0.05]],
                          [[-0.1, 0.02, 0.1], [0.2, -0.1, 0.05]]], np.float32),
        box_quat=np.tile(np.array([0.0, 0, 0.3827, 0.9239], np.float32), (E, 2, 1)),
        box_half=np.tile(np.array([0.06, 0.04, 0.08], np.float32), (E, 2, 1)),
        box_mask=np.array([[1.0, 1.0], [1.0, 0.0]], np.float32))
    if pkg == "jax":
        return jrm.ScenePrims(**{k: jnp.asarray(v) for k, v in a.items()}, ground=True)
    return trm.ScenePrims(**{k: torch.as_tensor(v) for k, v in a.items()}, ground=True)


def _rig():
    return jcam.gen_camera_poses([0, 0, 0.1], radius=0.8, num_views=3), \
        jcam.camera_intrinsics(64, 36)


def _assert_depth_close(got, want):
    assert got.shape == want.shape == (E, 3, 36, 64)
    err = np.abs(got - want)
    assert (err <= 1e-4).mean() >= 0.999, (err <= 1e-4).mean()
    both = (got < 99.0) & (want < 99.0)
    assert both.mean() > 0.5 and err[both].max() <= 1e-4, err[both].max()


@pytest.mark.parametrize("look_at,radius,views", [
    ([0.0, 0.0, 0.7], 1.5, 3), ([0.1, 0.2, 0.7], 1.2, 5)])
def test_camera_poses_and_intrinsics(look_at, radius, views):
    np.testing.assert_allclose(tcam.gen_camera_poses(look_at, radius, num_views=views),
                               jcam.gen_camera_poses(look_at, radius, num_views=views),
                               atol=1e-6, rtol=0)
    rs_a, rs_b = np.random.RandomState(2), np.random.RandomState(2)
    np.testing.assert_allclose(
        tcam.gen_camera_poses(look_at, radius, views, rng=rs_a, angle_noise_deg=5,
                              trans_noise=0.02),
        jcam.gen_camera_poses(look_at, radius, views, rng=rs_b, angle_noise_deg=5,
                              trans_noise=0.02), atol=1e-6, rtol=0)
    for w, h in ((512, 288), (64, 36), (128, 72)):
        np.testing.assert_allclose(tcam.camera_intrinsics(w, h),
                                   jcam.camera_intrinsics(w, h), atol=1e-6, rtol=0)
    pts = np.random.RandomState(3).randn(20, 3)
    R, t = jcam.kabsch_rt(pts, pts @ tcam.look_at_pose([1, 0, 0], [0, 0, 0])[:3, :3].T + 0.3)
    R2, t2 = tcam.kabsch_rt(pts, pts @ tcam.look_at_pose([1, 0, 0], [0, 0, 0])[:3, :3].T + 0.3)
    np.testing.assert_allclose(R2, R, atol=1e-6)
    np.testing.assert_allclose(t2, t, atol=1e-6)


def test_exact_march_matches_the_xla_renderer():
    poses, intr = _rig()
    want = np.asarray(jrm.render_depth(_prims("jax"), poses, intr, 36, 64))
    got = trm.render_depth(_prims("torch"), poses, intr, 36, 64, cull=False).numpy()
    _assert_depth_close(got, want)


def test_coarse_to_fine_matches_the_pallas_kernel():
    poses, intr = _rig()
    want = np.asarray(raymarch_tpu.render_depth_tpu(
        _prims("jax"), poses, intr, 36, 64, interpret=True, coarse_to_fine=True))
    got = trm.render_depth(_prims("torch"), poses, intr, 36, 64,
                           coarse_to_fine=True).numpy()
    _assert_depth_close(got, want)
    exact = trm.render_depth(_prims("torch"), poses, intr, 36, 64).numpy()
    assert (np.abs(got - exact) < 5e-3).mean() > 0.95      # test_vision.py's bound
    # H, W not multiples of 4: the exact march, as the TPU wrapper does
    odd = trm.render_depth(_prims("torch"), poses, intr, 35, 64, coarse_to_fine=True)
    np.testing.assert_array_equal(
        odd.numpy(), trm.render_depth(_prims("torch"), poses, intr, 35, 64).numpy())


def test_coarse_start_equals_the_tpu_wrappers_filter():
    d = np.random.RandomState(5).uniform(0.1, 3.0, (2, 3, 9, 16)).astype(np.float32)
    d[0, 1, 2:4, 5:9] = 100.0                                  # misses
    dmin = -jax.lax.reduce_window(-jnp.asarray(d), -jnp.inf, jax.lax.max,
                                  (1, 1, 3, 3), (1, 1, 1, 1), "SAME")
    t0 = jnp.clip(dmin * 0.9 - 0.05, 0.05, 100.0)
    want = np.asarray(jnp.repeat(jnp.repeat(t0, 4, axis=2), 4, axis=3))
    got = raymarch_cuda.coarse_start(torch.as_tensor(d), 100.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_march_counts_its_scene_evaluations():
    poses, intr = _rig()
    rays = raymarch_cuda.ray_table(poses, intr, 36, 64, "cpu")
    assert rays.dirs.shape == (3, 3, 36 * 64) and rays.dirs.dtype == torch.float32
    depth, evals = trm.march_plain(_prims("torch"), rays, 0.05, 40, 100.0, 1e-3,
                                   count_evals=True)
    assert torch.equal(depth, trm.march_plain(_prims("torch"), rays, 0.05, 40,
                                              100.0, 1e-3))
    n = evals[..., 0]
    assert int(n.min()) >= 2 and int(n.max()) <= 41
    # the kept spheres and boxes of each ray's tile, per evaluation
    keep = trm.tile_masks(_prims("torch"), rays, 100.0)[:, :, rays.tile_of]   # [E, V, N, 4]
    assert torch.equal(evals[..., 1], n * keep[..., :2].sum(-1))
    assert torch.equal(evals[..., 2], n * keep[..., 2:].sum(-1))
    live = torch.tensor([4, 3])[:, None, None]              # env 1 has a dead box
    assert bool((evals[..., 1] + evals[..., 2] <= live * n).all())
    assert raymarch_cuda.ray_table(poses, intr, 36, 64, "cpu") is rays      # cached


def test_cpu_prims_never_reach_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the kernel was asked for on the CPU")
    monkeypatch.setattr(raymarch_cuda, "march", boom)
    for name in ("load", "start"):
        monkeypatch.setattr(cuda_lib.Library, name, boom)
    before = raymarch_cuda.launch_counts["b2"]
    trm.render_depth(_prims("torch"), *_rig(), 36, 64, coarse_to_fine=True)
    assert raymarch_cuda.launch_counts["b2"] == before
    monkeypatch.undo()
    rays = raymarch_cuda.ray_table(*_rig(), 36, 64, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        raymarch_cuda.march(_prims("torch"), rays, 0.05, 40, 100.0, 1e-3)


def test_build_command_and_c_signature(monkeypatch):
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: "nvcc")
    cmd = raymarch_cuda.LIBRARY.command()
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd
    assert not any("fast" in c for c in cmd) and cmd[-1] == raymarch_cuda.SOURCE
    with open(raymarch_cuda.SOURCE) as f:
        src = f.read()
    params = re.search(r"int rm_launch\((.*?)\)", src, re.S).group(1).split(",")
    argtypes, _ = raymarch_cuda.LIBRARY.signatures["rm_launch"]
    assert len(argtypes) == len(params) == 21
    kinds = [("float" if "float " in p and "*" not in p else
              "int" if p.split()[0] == "int" else "ptr") for p in params]
    import ctypes
    want = {"float": ctypes.c_float, "int": ctypes.c_int, "ptr": ctypes.c_void_p}
    assert [want[k] for k in kinds] == list(argtypes)


@pytest.mark.parametrize("task", ["grasp_cube", "open_drawer"])
def test_scene_prims_of_both_scene_kinds(task, tmp_path):
    """``vision.scene_prims``: robot spheres and the free cube (grasp_cube)
    or the cabinet's boxes (open_drawer) from the same state, to 1e-5."""
    import random
    import _torch_port as tp
    from partmanip_tpu import config as jconfig
    from partmanip_tpu.envs import vision as jvision
    from partmanip_tpu_torch import config as tconfig
    from partmanip_tpu_torch.envs import vision as tvision
    from partmanip_tpu_torch.utils import convert
    import train_torch
    flags = ["--taskcfg", task, "--algo.num_envs", "3", "--task.asset.num_objects", "2",
             "--task.asset.assetRoot", str(tmp_path)]
    if task == "grasp_cube":
        jenv, _, _, tenv, _ = tp.make_envs(flags[:4])
    else:
        from partmanip_tpu.envs.open_drawer import OpenDrawerEnv
        jcfg, jsp = jconfig.process_cfgs(flags)
        tcfg, tsp = tconfig.process_cfgs(flags)
        random.seed(1)
        jenv = OpenDrawerEnv(jcfg["task"], jsp)
        random.seed(1)
        tenv = train_torch.make_env(tcfg, tsp, "cpu")
    tstate = tenv.init_state(tenv.make_generator(3))
    jsim = jenv.init_state(jax.random.PRNGKey(0)).sim
    jsim = jsim._replace(**{
        part: type(getattr(jsim, part))(**{k: jnp.asarray(v) for k, v in leaves.items()})
        for part, leaves in convert.scene_state_to_numpy(tstate.sim).items()})
    want = jax.jit(lambda s: jvision.scene_prims(jenv, s))(jsim)
    got = tvision.scene_prims(tenv, tstate.sim)
    for name in ("sphere_center", "sphere_radius", "box_pos", "box_quat", "box_half",
                 "box_mask"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert got.ground and want.ground
