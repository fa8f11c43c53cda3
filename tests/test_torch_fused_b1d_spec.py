"""Kernel B1d (the robot and the ground alone: ``csrc/fused_inner_step.cu``
with ``FIS_BODY=0``) and the bias builds of every B1 variant
(``FIS_BIAS=1``), the parts that need neither nvcc nor a GPU: B1d's packed
``Spec`` and state rows against the source as that build sees it (its
``#if`` blocks resolved, ``tests/_torch_cu.py``), the launch configuration
and struct sizes of each new build against the source, the build commands
(the default builds' commands and names unchanged), B1d's state layout
round trip and the CPU routing.  The kernels themselves are held against
the plain version on the card by ``chip_smoke.py`` (phase ``tooling``)."""

import os
import re

import numpy as np
import pytest
import torch

import _torch_cu
import tune_pid_torch
from partmanip_tpu_torch.sim import engine, fused
from partmanip_tpu_torch.utils import cuda_lib
from test_torch_fused_warp import _constants as obj_constants, _words as obj_words
from test_torch_fused_warp_b1a import _constants as b1a_constants, _words as b1a_words

E = 6
B1D_DIMS = (16, 12, 18)          # the mobile Franka: L, D, S
B1A_DIMS = (13, 9, 18)
B1B_DIMS = (16, 12, 18, 9, 4, 25)
B1C_DIMS = (16, 12, 18, 9, 4, 21, 4, 29, 73, 73)


@pytest.fixture(scope="module")
def calib():
    """The calibration scene of tune_pid_torch.py on the CPU."""
    return tune_pid_torch.build(E, torch.device("cpu"))


def _expand_bias_macro(src):
    """``FIS_BIAS_SCRATCH(a, b)`` written out as ``fused_bias.cuh`` defines it."""
    with open(os.path.join(cuda_lib.CSRC, "fused_bias.cuh")) as f:
        body = re.search(r"#define FIS_BIAS_SCRATCH\(NL, ND\) (.*)", f.read()).group(1)
    return re.sub(r"FIS_BIAS_SCRATCH\((\w+), (\w+)\)",
                  lambda m: body.replace("NL", m.group(1)).replace("ND", m.group(2)), src)


def _source(path, body, bias):
    return _expand_bias_macro(_torch_cu.read(path, {"FIS_BODY": int(body), "FIS_BIAS": int(bias)}))


def _spec_offsets(src, dims):
    L, D, S = dims
    body = re.search(r"struct Spec \{(.*?)\n\};", src, re.S).group(1)
    offsets, words = {}, 0
    for _, name, ext in re.findall(r"^\s*(int|float)\s+(\w+)((?:\[\w+\])*);", body, re.M):
        n = int(np.prod([{"L": L, "D": D, "S": S}.get(x) or int(x)
                         for x in re.findall(r"\[(\w+)\]", ext)]))
        offsets[name] = (words, n)
        words += n
    return offsets, words


@pytest.mark.parametrize("bias", [False, True], ids=["default", "bias"])
def test_b1d_packed_spec_matches_the_kernel_struct(calib, bias):
    scene, _, _ = calib
    assert fused.variant(scene) == "b1d" and fused._dims(scene) == B1D_DIMS
    src = _source(fused.KERNEL_SOURCE, body=False, bias=bias)
    offsets, words = _spec_offsets(src, B1D_DIMS)
    assert "cube_mass" not in offsets and "hold_vel" not in offsets
    spec = fused.pack_spec(scene, bias)
    assert spec.dtype == np.float32 and spec.size == words
    field = lambda name, dt=np.float32: spec[offsets[name][0]:sum(offsets[name])].view(dt)
    np.testing.assert_array_equal(field("parent", np.int32), scene.robot.parent[0].numpy())
    np.testing.assert_array_equal(field("kp"), scene.robot.drive_kp[0].numpy())
    np.testing.assert_array_equal(field("sph_sticky"), scene.spheres.sticky.numpy())
    np.testing.assert_allclose(field("h"), [scene.params.h])
    np.testing.assert_allclose(field("coef_anchor")[0], fused.pack_spec(
        scene)[offsets["coef_anchor"][0]])
    np.testing.assert_allclose(field("sat_veps"), [1e-2])
    if bias:
        np.testing.assert_array_equal(spec[-2:], [field("gscale")[0], 0.0])


def test_b1d_state_rows_match_the_kernel_enum(calib):
    scene, state, _ = calib
    src = _source(fused.KERNEL_SOURCE, body=False, bias=False)
    rows = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"(\w+)\s*=", rows) == ["R_QPOS", "R_QVEL", "R_ROOTP", "R_ROOTQ",
                                              "R_ANCP", "R_TGT", "FIS_NF"]
    env = b1a_constants(src, B1D_DIMS)
    L, D, S = B1D_DIMS
    assert env["FIS_NF"] == fused.state_rows_robot(D, S) == 3 * D + 7 + 3 * S
    assert fused._rows("b1d", B1D_DIMS) == env["FIS_NF"]


@pytest.mark.parametrize("variant,dims,bias", [
    ("b1a", B1A_DIMS, True), ("b1d", B1D_DIMS, False), ("b1d", B1D_DIMS, True),
    ("b1b", B1B_DIMS, True), ("b1c", B1C_DIMS, True)],
    ids=["b1a_bias", "b1d", "b1d_bias", "b1b_bias", "b1c_bias"])
def test_new_builds_launch_configuration_matches_the_source(variant, dims, bias):
    """``struct_words`` / ``launch_config`` for each new build equal the
    structs and constants of the source as that build sees it, and the
    block still fits the shared memory the launch bounds assume."""
    body = variant == "b1a"          # the object source's FIS_BODY build is B1e
    if variant in ("b1a", "b1d"):
        src = _source(fused.KERNEL_SOURCE, body, bias)
        env = b1a_constants(src, dims)
        words = {"spec": b1a_words(src, "Spec", env), "work": b1a_words(src, "Work", env)}
        smem = 4 * (words["spec"] + env["FIS_ENVS"] * words["work"])
    else:
        src = _source(fused.KERNEL_SOURCE_OBJ, body, bias)
        env = obj_constants(src, dims)
        words = {"spec": obj_words(src, "Spec", env), "obj": obj_words(src, "ObjSpec", env),
                 "grid": obj_words(src, "GridSpec", env) if len(dims) > 6 else 0,
                 "work": obj_words(src, "Work", env)}
        smem = 4 * (words["spec"] + fused.WARPS * (words["work"] + words["obj"] + words["grid"]))
    assert fused.struct_words(dims, body, bias) == words
    cfg = fused.launch_config(2048, dims, body, bias)
    assert cfg["dynamic_smem_bytes"] == smem and cfg["work_bytes"] == 4 * words["work"]
    assert smem <= fused.SMEM_LIMIT
    if bias:
        assert fused.struct_words(dims, body, False)["work"] < words["work"]


def test_build_commands_and_names(monkeypatch, calib):
    """B1d adds -DFIS_BODY=0, a bias build -DFIS_BIAS=1, each with its own
    library name; the default builds pass neither and keep their names."""
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: "nvcc")
    scene, _, _ = calib
    lib = fused.scene_library(scene)
    cmd = lib.command()
    assert lib.name == "b1d" and "-DFIS_BODY=0" in cmd and not any("FIS_BIAS" in c for c in cmd)
    assert cmd[-1] == fused.KERNEL_SOURCE
    assert lib.path.endswith("libfused_inner_step_L16_D12_S18_robot.so")
    cor = scene._replace(params=scene.params._replace(coriolis=True))
    assert fused.scene_library(cor).path.endswith("libfused_inner_step_L16_D12_S18_robot_bias.so")
    assert "-DFIS_BIAS=1" in fused.scene_library(cor).command()
    for variant, dims, so in (("b1a", B1A_DIMS, "libfused_inner_step_L13_D9_S18.so"),
                              ("b1b", B1B_DIMS,
                               "libfused_inner_step_obj_L16_D12_S18_Lo9_Do4_G25.so")):
        default = fused.library(variant, dims)
        assert default.path.endswith(so) and default.name == variant
        assert not any("FIS_BODY" in c or "FIS_BIAS" in c for c in default.command())
        assert fused.library(variant, dims, True).name == variant + "_bias"


def test_b1d_layout_roundtrip_and_cpu_routing(calib, monkeypatch):
    """pack_state / unpack_state are exact for a scene without body or
    object; physics_step on CPU tensors takes the plain version and never
    builds, loads or launches; launch_packed refuses CPU tensors."""
    scene, state, _ = calib
    rs = np.random.RandomState(0)
    S = scene.spheres.link_idx.shape[0]
    from partmanip_tpu_torch.sim import contact
    sim = state._replace(anchors=contact.AnchorState(
        point=torch.as_tensor(rs.normal(size=(E, S, 3)).astype(np.float32)),
        body=torch.as_tensor(rs.randint(-1, 1, (E, S)).astype(np.int32))))
    targets = state.robot.qpos + 0.01
    buf, anc_b = fused.pack_state(sim, targets)
    assert buf.shape == (fused.state_rows_robot(12, S), E)
    back = fused.unpack_state(buf, anc_b, sim)
    assert back.obj is None and back.body is None
    for a, b in zip((*back.robot, *back.anchors), (*sim.robot, *sim.anchors)):
        assert torch.equal(a, b)

    def boom(*a, **k):
        raise AssertionError("the kernel library was asked for on the CPU")
    for name in ("load", "start"):
        monkeypatch.setattr(cuda_lib.Library, name, boom)
    monkeypatch.setattr(cuda_lib, "find_nvcc", boom)
    cuda_lib.reset_launch_counts()
    out = engine.physics_step(scene, sim, targets)
    assert torch.isfinite(out.robot.qpos).all() and sum(fused.launch_counts.values()) == 0
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        fused.launch_packed(scene, buf, anc_b, 1)
