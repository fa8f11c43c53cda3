"""The Python side of the kernel wrapper that needs no JAX: the scene packed
into the kernel's ``struct Spec`` (read out of the ``.cu`` source, since
there is no nvcc on a CPU host), the state rows, the build command, and the
scenes the kernel refuses."""

import os
import re

import numpy as np
import pytest
import torch

import _torch_cu

from partmanip_tpu_torch.config import process_cfgs
from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv
from partmanip_tpu_torch.sim import contact as tcontact
from partmanip_tpu_torch.sim import fused
from partmanip_tpu_torch.utils import cuda_lib

E = 8


@pytest.fixture(scope="module")
def tenv():
    cfg, sp = process_cfgs(["--taskcfg", "grasp_cube", "--algo.num_envs", str(E)])
    return GraspCubeEnv(cfg["task"], sp, device="cpu")


def _cu_source():
    return _torch_cu.read(fused.KERNEL_SOURCE)


def test_packed_spec_matches_the_kernel_struct(tenv):
    """No nvcc here, so read ``struct Spec`` out of the .cu source: the
    wrapper must pack exactly as many 4-byte words, in the order the kernel
    declares them (checked on fields with telling values)."""
    L, D, S = fused._dims(tenv.scene)
    body = re.search(r"struct Spec \{(.*?)\n\};", _cu_source(), re.S).group(1)
    dims = {"L": L, "D": D, "S": S}
    offsets, words = {}, 0
    for kind, name, extents in re.findall(
            r"^\s*(int|float)\s+(\w+)((?:\[\w+\])*);", body, re.M):
        size = 1
        for ext in re.findall(r"\[(\w+)\]", extents):
            size *= dims[ext] if ext in dims else int(ext)
        offsets[name] = (words, size)
        words += size
    spec = fused.pack_spec(tenv.scene)
    assert spec.dtype == np.float32 and spec.size == words

    def field(name, dtype=np.float32):
        lo, n = offsets[name]
        return spec[lo:lo + n].view(dtype)

    robot = tenv.built.spec
    np.testing.assert_array_equal(field("parent", np.int32), robot.parent[0])
    np.testing.assert_array_equal(field("sph_link", np.int32),
                                  tenv.spheres.link_idx.numpy())
    np.testing.assert_array_equal(field("kp"), robot.drive_kp[0])
    np.testing.assert_array_equal(field("effort"), robot.dof_effort[0])
    np.testing.assert_array_equal(field("ancestor"), robot.ancestor[0].ravel())
    np.testing.assert_array_equal(field("sph_sticky"),
                                  tenv.spheres.sticky.numpy())
    np.testing.assert_allclose(field("cube_mass"), [0.125])
    np.testing.assert_allclose(field("h"), [tenv.scene.params.h])
    np.testing.assert_allclose(field("sat_veps"), [1e-2])
    np.testing.assert_allclose(field("anchor_ks"), [tcontact.ANCHOR_KS])


def test_state_rows_match_the_kernel_enum(tenv):
    L, D, S = fused._dims(tenv.scene)
    assert fused.variant(tenv.scene) == "b1a"
    src = _cu_source()
    rows = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)\s*=", rows)
    assert names == ["R_QPOS", "R_QVEL", "R_ROOTP", "R_ROOTQ", "R_BPOS",
                     "R_BQUAT", "R_BLIN", "R_BANG", "R_ANCP", "R_TGT", "FIS_NF"]
    assert fused.state_rows(D, S) == 2 * D + 7 + 13 + 3 * S + D


def test_build_command_targets_hopper(monkeypatch):
    """The command line the GPU host runs: sm_90a, no fast-math, only the
    port's own source."""
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: "nvcc")
    cmd = fused.library("b1a", (13, 9, 18)).command()
    assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
    assert not any("fast" in c for c in cmd)
    assert cmd[-1] == fused.KERNEL_SOURCE and os.path.exists(cmd[-1])
    assert "-DFIS_L=13" in cmd and "-DFIS_D=9" in cmd and "-DFIS_S=18" in cmd


def test_pack_spec_refuses_a_robot_under_gravity(tenv):
    """A robot under gravity used to be refused; it now takes the bias build
    (``FIS_BIAS=1``): the scene asks for it, its library is keyed on it, and
    the packed Spec is that build's struct, with the robot's gravity_scale
    and the coriolis flag in its last fields."""
    robot = tenv.scene.robot._replace(gravity_scale=torch.ones(1))
    scene = tenv.scene._replace(robot=robot)
    assert not fused.needs_bias(tenv.scene) and fused.needs_bias(scene)
    lib = fused.scene_library(scene)
    assert ("FIS_BIAS", 1) in lib.defines and lib.path.endswith("_bias.so")
    L, D, S = fused._dims(scene)
    body = re.search(r"struct Spec \{(.*?)\n\};",
                     _torch_cu.read(fused.KERNEL_SOURCE, {"FIS_BODY": 1, "FIS_BIAS": 1}),
                     re.S).group(1)
    names = re.findall(r"^\s*(?:int|float)\s+(\w+)", body, re.M)
    assert names[-2:] == ["gscale", "coriolis"]
    spec = fused.pack_spec(scene, bias=True)
    assert spec.size == fused.struct_words((L, D, S), bias=True)["spec"]
    np.testing.assert_array_equal(spec[-2:], [1.0, 0.0])
    np.testing.assert_array_equal(spec[:-2], fused.pack_spec(tenv.scene))


@pytest.mark.parametrize("what", ["robot topology", "free body"])
def test_per_env_specs_raise(tenv, what):
    scene = tenv.scene
    if what == "robot topology":
        scene = scene._replace(robot=scene.robot._replace(
            parent=scene.robot.parent.expand(E, -1)))
    else:
        scene = scene._replace(free_body=scene.free_body._replace(
            mass=scene.free_body.mass.expand(E)))
    with pytest.raises(NotImplementedError, match="shared"):
        fused.check_scene(scene)


def test_packed_spec_follows_the_scene_not_only_the_robot(tenv):
    """Two scenes may share the robot tensors and differ in their
    parameters: the cached packing must not be reused across them."""
    a = fused._packed_spec(tenv.scene)
    assert fused._packed_spec(tenv.scene) is a
    finer = tenv.scene._replace(
        params=tenv.scene.params._replace(inner_substeps=4))
    b = fused._packed_spec(finer)
    assert b is not a and b.size == a.size
    assert np.count_nonzero(a != b) >= 1      # h and the h-scaled coefficients
    np.testing.assert_array_equal(fused._packed_spec(tenv.scene), a)
