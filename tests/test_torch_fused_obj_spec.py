"""The Python side of kernel B1b that needs no JAX and no GPU
(``partmanip_tpu_torch/sim/fused.py`` for an open_drawer scene): the robot
packed into the kernel's ``struct Spec`` and the per-env cabinet into
``struct ObjSpec`` records (both read out of ``csrc/fused_inner_step_obj.cu``,
since there is no nvcc on a CPU host), the state rows, the build keyed on
every compile-time size, routing, and the scenes the kernel refuses."""

import os
import random
import re

import numpy as np
import pytest
import torch

import _torch_cu
from partmanip_tpu_torch.config import process_cfgs
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv
from partmanip_tpu_torch.sim import engine, fused
from partmanip_tpu_torch.utils import contact_states, convert, cuda_lib

E = 8


@pytest.fixture(scope="module")
def denv(tmp_path_factory):
    cfg, sp = process_cfgs(["--taskcfg", "open_drawer", "--algo.num_envs", str(E),
                            "--task.asset.num_objects", "3", "--task.asset.assetRoot",
                            str(tmp_path_factory.mktemp("assets"))])
    random.seed(0)
    return OpenDrawerEnv(cfg["task"], sp, device="cpu")


def _struct_offsets(name, dims, macros=None):
    body = re.search(r"struct %s \{(.*?)\n\};" % name,
                     _torch_cu.read(fused.KERNEL_SOURCE_OBJ, macros), re.S).group(1)
    offsets, words = {}, 0
    for _, field, extents in re.findall(
            r"^\s*(int|float)\s+(\w+)((?:\[\w+\])*);", body, re.M):
        size = 1
        for ext in re.findall(r"\[(\w+)\]", extents):
            size *= dims[ext] if ext in dims else int(ext)
        offsets[field] = (words, size)
        words += size
    return offsets, words


def _dims(denv):
    return dict(zip(("L", "D", "S", "LO", "DO", "G"), fused._dims(denv.scene)))


def test_packed_spec_matches_the_kernel_struct(denv):
    offsets, words = _struct_offsets("Spec", _dims(denv))
    spec = fused.pack_spec_obj(denv.scene)
    assert spec.dtype == np.float32 and spec.size == words

    def field(name, dtype=np.float32):
        lo, n = offsets[name]
        return spec[lo:lo + n].view(dtype)

    robot = denv.built.spec
    np.testing.assert_array_equal(field("parent", np.int32), robot.parent[0])
    np.testing.assert_array_equal(field("sph_link", np.int32),
                                  denv.spheres.link_idx.numpy())
    np.testing.assert_array_equal(field("kp"), robot.drive_kp[0])
    np.testing.assert_array_equal(field("ancestor"), robot.ancestor[0].ravel())
    p = denv.scene.params
    np.testing.assert_allclose(field("h"), [p.h])
    cd_obj = 2.0 * p.contact_damping_ratio * np.sqrt(p.contact_kn * 0.3)
    np.testing.assert_allclose(field("cd_obj"), [cd_obj], rtol=1e-6)
    np.testing.assert_allclose(field("coef_obj"), [p.h * cd_obj + p.h ** 2 * p.contact_kn],
                               rtol=1e-6)
    np.testing.assert_allclose(field("sat_veps"), [1e-2])


def test_obj_table_matches_the_kernel_struct(denv):
    """One ObjSpec record per distinct cabinet; record obj_id[e] holds env
    e's tree and boxes, field by field."""
    offsets, words = _struct_offsets("ObjSpec", _dims(denv))
    (table,), obj_id = fused.pack_obj_table(denv.scene)
    assert table.dtype == np.float32 and table.shape == (3, words)
    assert obj_id.dtype == np.int32 and obj_id.shape == (E,)
    # same cabinet <=> same record
    lst = denv.obj_lstid
    assert all((obj_id[a] == obj_id[b]) == (lst[a] == lst[b])
               for a in range(E) for b in range(E))
    o, b = denv.scene.obj_tree, denv.scene.obj_boxes

    def field(e, name, dtype=np.float32):
        lo, n = offsets[name]
        return table[obj_id[e], lo:lo + n].view(dtype)

    for e in range(E):
        np.testing.assert_array_equal(field(e, "parent", np.int32), o.parent[e].numpy())
        np.testing.assert_array_equal(field(e, "b_link", np.int32), b.link_idx[e].numpy())
        np.testing.assert_array_equal(field(e, "mass"), (o.mass * o.link_mask)[e].numpy())
        np.testing.assert_array_equal(field(e, "damping"), o.dof_damping[e].numpy())
        np.testing.assert_array_equal(field(e, "b_quat"), b.offset_quat[e].numpy().ravel())
        np.testing.assert_array_equal(field(e, "b_mu"), b.friction[e].numpy())
    np.testing.assert_array_equal(o.dof_damping.numpy(), 20.0)
    np.testing.assert_array_equal(o.dof_friction.numpy(), 5.0)


def test_state_rows_match_the_kernel_enum(denv):
    rows = re.search(r"enum \{(.*?)\};", _torch_cu.read(fused.KERNEL_SOURCE_OBJ), re.S).group(1)
    assert re.findall(r"(\w+)\s*=", rows) == [
        "R_QPOS", "R_QVEL", "R_ROOTP", "R_ROOTQ", "R_OQ", "R_OV", "R_ORP", "R_ORQ",
        "R_ANCP", "R_TGT", "FIS_NF"]
    L, D, S, Lo, Do, G = fused._dims(denv.scene)
    assert fused.variant(denv.scene) == "b1b"
    assert (L, D, S, Do) == (16, 12, 18, 4)
    assert fused.state_rows_obj(D, S, Do) == 3 * D + 7 + 2 * Do + 7 + 3 * S


def test_build_is_keyed_on_every_size(monkeypatch):
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: "nvcc")
    cmd = fused.library("b1b", (16, 12, 18, 9, 4, 25)).command()
    for flag in ("-DFIS_L=16", "-DFIS_D=12", "-DFIS_S=18", "-DFIS_LO=9",
                 "-DFIS_DO=4", "-DFIS_G=25", "arch=compute_90a,code=sm_90a"):
        assert flag in cmd
    assert not any("fast" in c for c in cmd)
    assert cmd[-1] == fused.KERNEL_SOURCE_OBJ and os.path.exists(cmd[-1])
    assert fused.library("b1b", (16, 12, 18, 9, 4, 25)).path.endswith(
        "libfused_inner_step_obj_L16_D12_S18_Lo9_Do4_G25.so")
    assert fused.library("b1b", (16, 12, 18, 9, 4, 24)).path != fused.library(
        "b1b", (16, 12, 18, 9, 4, 25)).path
    assert fused.library("b1a", (13, 9, 18)).path.endswith(
        "libfused_inner_step_L13_D9_S18.so")


def test_layout_roundtrip_is_exact(denv):
    st, tg = contact_states.drawer_contact_states(denv, E, seed=3)
    st["anchors"]["body"] = np.random.RandomState(0).randint(
        -1, 27, st["anchors"]["body"].shape).astype(np.int32)
    sim = convert.scene_state_from_numpy(st)
    assert sim.body is None and sim.obj is not None
    buf, anc_b = fused.pack_state(sim, torch.as_tensor(tg))
    D, S, Do = 12, 18, 4
    assert buf.shape == (fused.state_rows_obj(D, S, Do), E) and buf.is_contiguous()
    np.testing.assert_array_equal(buf[-D:].numpy(), tg.T)
    back = fused.unpack_state(buf, anc_b, sim)
    assert back.body is None
    for part in ("robot", "obj", "anchors"):
        for a, b in zip(getattr(back, part), getattr(sim, part)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
    assert convert.scene_state_to_numpy(sim).keys() == {"robot", "obj", "anchors"}


def test_cpu_state_never_touches_the_build(denv, monkeypatch):
    """physics_step on CPU tensors takes the plain version and neither
    builds, loads nor launches; launch_packed refuses CPU tensors."""
    def boom(*a, **k):
        raise AssertionError("the kernel library was asked for on the CPU")
    for name in ("load", "start"):
        monkeypatch.setattr(cuda_lib.Library, name, boom)
    monkeypatch.setattr(cuda_lib, "find_nvcc", boom)
    monkeypatch.setattr(fused, "launch_packed", boom)
    cuda_lib.reset_launch_counts()
    sim = denv._default_sim(E)
    targets = torch.as_tensor(np.tile(denv.default_dof, (E, 1)))
    out = engine.physics_step(denv.scene, sim, targets)
    via_wrapper = fused.fused_physics_step(denv.scene, sim, targets)
    assert torch.equal(out.obj.qpos, via_wrapper.obj.qpos)
    assert fused.launch_counts == {"b1a": 0, "b1b": 0, "b1c": 0, "b1d": 0, "b1e": 0}
    monkeypatch.undo()
    buf, anc_b = fused.pack_state(sim, targets)
    with pytest.raises(ValueError, match="CUDA"):      # the launch itself refuses
        fused.launch_packed(denv.scene, buf, anc_b, 1)


def _refused(scene, what):
    if what == "free_body_and_object":
        from partmanip_tpu_torch.sim.types import FreeBodySpec
        one = torch.ones(1)
        fb = FreeBodySpec(mass=one, inertia=torch.eye(3)[None], half_extents=torch.ones(1, 3),
                          gravity_scale=one, friction=one)
        return scene._replace(free_body=fb), fused.pack_spec_obj, None     # ported: B1e
    if what == "more_than_32_boxes":
        b = scene.obj_boxes
        wide = type(b)(*[torch.cat([x] * 2, dim=1) for x in b])
        return scene._replace(obj_boxes=wide), fused.check_scene, NotImplementedError
    if what == "object_gravity":     # ported: the bias build, no refusal
        o = scene.obj_tree._replace(gravity_scale=torch.ones_like(scene.obj_tree.gravity_scale))
        return scene._replace(obj_tree=o), fused.pack_obj_table, None
    b = scene.obj_boxes._replace(geom_mask=scene.obj_boxes.geom_mask * 0.5)
    return scene._replace(obj_boxes=b), fused.pack_obj_table, NotImplementedError


@pytest.mark.parametrize("what", ["free_body_and_object", "more_than_32_boxes",
                                  "object_gravity", "fractional_box_mask"])
def test_scenes_kernel_b1b_cannot_run_raise(denv, what):
    """Each scene B1b cannot run raises.  An object under gravity was one of
    them; it now runs the bias build (``FIS_BIAS=1``), whose ObjSpec record
    ends with the object's gravity_scale.  A free body beside the object
    was another; it now runs kernel B1e (``FIS_BODY=1``), whose Spec adds
    the cube's fields after B1b's."""
    scene, fn, err = _refused(denv.scene, what)
    if what == "free_body_and_object":
        fused.check_scene(scene)
        assert fused.variant(scene) == "b1e" and fused._dims(scene) == fused._dims(denv.scene)
        offsets, words = _struct_offsets("Spec", _dims(denv), {"FIS_BODY": 1, "FIS_BIAS": 0})
        spec = fn(scene)
        assert spec.size == words and offsets["hold_vel"] == (words - 1, 1)
        plain = fn(denv.scene)
        np.testing.assert_array_equal(spec[:plain.size], plain)
        np.testing.assert_array_equal(spec[offsets["cube_inertia"][0]:][:9],
                                      np.eye(3, dtype=np.float32).ravel())
        return
    if err is None:
        assert fused.needs_bias(scene) and not fused.needs_bias(denv.scene)
        (table,), obj_id = fn(scene, bias=True)
        offsets, words = _struct_offsets("ObjSpec", _dims(denv), {"FIS_BODY": 1, "FIS_BIAS": 1})
        assert table.shape[1] == words and offsets["gscale"] == (words - 1, 1)
        np.testing.assert_array_equal(table[:, -1], 1.0)
        (plain,), plain_id = fn(denv.scene)
        np.testing.assert_array_equal(table[:, :-1], plain)
        np.testing.assert_array_equal(obj_id, plain_id)
        return
    with pytest.raises(err):
        fn(scene)
