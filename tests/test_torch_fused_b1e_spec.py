"""Kernel B1e (``csrc/fused_inner_step_obj.cu`` built with ``FIS_BODY=1``:
open_drawer's cabinet with grasp_cube's free cube beside it), the parts that
need neither nvcc nor a GPU: the packed ``Spec`` and the state rows against
the source as that build sees it (``tests/_torch_cu.py``), the launch
configuration and the build commands, the state layout (the cube's rows
after the object's, the object's where B1b has them), the CPU routing, and
one inner step of the composed scene through the port's plain engine (what
the kernel is held against on the card) against the JAX package's jnp
engine, with box handles and with mesh handles.

No entry point of either package builds this scene: it is open_drawer's
scene with grasp_cube's ``free_body`` spec added, the state
``contact_states.body_drawer_contact_states`` two reference inner steps in
(so that anchors exist on the cube and on the handle).  Tolerances are
those of ``tests/test_torch_drawer_engine.py``: qpos 1e-5, qvel 1e-3,
object qpos 1e-5, object qvel 1e-3, anchor points 1e-4, partner ids
≥ 99.9 % equal; the cube's pose 1e-5, its linear velocity 1e-3 and angular
velocity 1e-2 (``chip_smoke.TOL``).  The kernel itself is held against the
plain version on the card by ``chip_smoke.py`` (``kernel_check``, path
``b1e``)."""

import random
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_cu
import _torch_vision as tv
from partmanip_tpu import config as jconfig
from partmanip_tpu.envs.grasp_cube import GraspCubeEnv as JCube
from partmanip_tpu.envs.open_drawer import OpenDrawerEnv as JEnv
from partmanip_tpu.sim import contact as jcontact
from partmanip_tpu.sim import engine as jengine
from partmanip_tpu.sim.types import FreeBodyState as JBody, TreeState as JTree
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv as TCube
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv as TEnv
from partmanip_tpu_torch.sim import engine as tengine, fused
from partmanip_tpu_torch.utils import contact_states, convert, cuda_lib
from test_torch_fused_warp import _constants as obj_constants, _words as obj_words

B1E = (16, 12, 18, 9, 4, 25)
B1E_GRID = (16, 12, 18, 9, 4, 21, 4, 29, 73, 73)
SM_BYTES, BLOCK_RESERVED = 233_472, 1024      # an H100 SM's shared memory, the runtime's share


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _scenes(tmp_path_factory, E, extra):
    """(JAX env, port env, JAX scene, port scene, JAX jitted inner step):
    open_drawer's scene with grasp_cube's cube in both packages."""
    flags = ["--taskcfg", "open_drawer", "--algo.num_envs", str(E),
             "--task.asset.assetRoot", str(tmp_path_factory.mktemp("assets"))] + extra
    cube = ["--taskcfg", "grasp_cube", "--algo.num_envs", str(E)]
    jcfg, jsp = jconfig.process_cfgs(list(flags))
    tcfg, tsp = tconfig.process_cfgs(list(flags))
    random.seed(4)
    tenv = TEnv(tcfg["task"], tsp, device="cpu")
    random.seed(4)
    jenv = JEnv(jcfg["task"], jsp)
    jcube = JCube(jconfig.process_cfgs(cube)[0]["task"], jsp)
    tcube = TCube(tconfig.process_cfgs(cube)[0]["task"], tsp, device="cpu")
    jscene = jenv.scene._replace(free_body=jcube.scene.free_body,
                                 params=jsp._replace(use_fused=False))
    tscene = tenv.scene._replace(free_body=tcube.scene.free_body)
    gravity = jnp.array([0.0, 0.0, jsp.gravity])
    jstep = jax.jit(lambda s, t: jengine._inner_step(jscene, s, t, jsp.h, gravity,
                                                     coriolis=False))
    return jenv, tenv, jscene, tscene, jstep


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    return _scenes(tmp_path_factory, 8, ["--task.asset.num_objects", "3"])


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    return _scenes(tmp_path_factory, 10, ["--task.asset.num_objects", "2",
                                          "--task.asset.mesh_handle"])


def _offsets(src, struct, dims):
    names = dict(zip(("L", "D", "S", "LO", "DO", "G", "K"), dims))
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    offsets, words = {}, 0
    for _, field, ext in re.findall(r"^\s*(int|float)\s+(\w+)((?:\[\w+\])*);", body, re.M):
        n = int(np.prod([names[x] if x in names else int(x) for x in re.findall(r"\[(\w+)\]", ext)]))
        offsets[field] = (words, n)
        words += n
    return offsets, words


def _b1e_source(bias=False):
    return _torch_cu.read(fused.KERNEL_SOURCE_OBJ, {"FIS_BODY": 1, "FIS_BIAS": int(bias)})


@pytest.mark.parametrize("bias", [False, True], ids=["default", "bias"])
def test_packed_spec_matches_the_kernel_struct(boxes, bias):
    """B1e's Spec is B1b's with the cube's fields after the constants (and
    the bias fields last): each packed field against the scene."""
    _, tenv, _, scene, _ = boxes
    assert fused.variant(scene) == "b1e" and fused._dims(scene) == B1E
    assert fused.needs_bias(scene) is False       # the shipped scenes: no bias
    offsets, words = _offsets(_b1e_source(bias), "Spec", B1E)
    spec = fused.pack_spec_obj(scene, bias)
    assert spec.dtype == np.float32 and spec.size == words
    field = lambda name, dt=np.float32: spec[offsets[name][0]:sum(offsets[name])].view(dt)
    fb, p = scene.free_body, scene.params
    np.testing.assert_array_equal(field("parent", np.int32), scene.robot.parent[0].numpy())
    np.testing.assert_array_equal(field("cube_mass"), fb.mass.numpy().ravel()[:1])
    np.testing.assert_array_equal(field("cube_inertia"), fb.inertia[0].numpy().ravel())
    np.testing.assert_array_equal(field("cube_half"), fb.half_extents[0].numpy())
    np.testing.assert_array_equal(field("cube_mu"), fb.friction.numpy().ravel()[:1])
    m = float(fb.mass.reshape(-1)[0])
    cd = 2.0 * p.contact_damping_ratio * np.sqrt(p.contact_kn * m)
    np.testing.assert_allclose(field("cd_cube"), [cd], rtol=1e-6)
    np.testing.assert_allclose(field("coef_cube"), [p.h * cd + p.h ** 2 * p.contact_kn], rtol=1e-6)
    np.testing.assert_allclose(field("hold_vel"), [0.05], rtol=1e-6)
    # B1b's fields where B1b has them
    b1b = fused.pack_spec_obj(tenv.scene, bias)
    np.testing.assert_array_equal(spec[:offsets["cube_mass"][0]], b1b[:offsets["cube_mass"][0]])
    if bias:
        np.testing.assert_array_equal(spec[-2:], b1b[-2:])


def test_state_rows_match_the_kernel_enum():
    """The cube's 13 rows follow the object's, the anchors and targets
    follow them; B1b's rows keep their offsets."""
    src = _b1e_source()
    rows = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"(\w+)\s*=", rows) == [
        "R_QPOS", "R_QVEL", "R_ROOTP", "R_ROOTQ", "R_OQ", "R_OV", "R_ORP", "R_ORQ",
        "R_BPOS", "R_BQUAT", "R_BLIN", "R_BANG", "R_ANCP", "R_TGT", "FIS_NF"]
    env = obj_constants(src, B1E)
    L, D, S, Lo, Do, G = B1E
    assert env["FIS_NF"] == fused.state_rows_obj_body(D, S, Do) == fused._rows("b1e", B1E)
    assert env["R_BPOS"] == obj_constants(_torch_cu.read(fused.KERNEL_SOURCE_OBJ), B1E)["R_ANCP"]


@pytest.mark.parametrize("dims", [B1E, B1E_GRID], ids=["boxes", "grids"])
def test_launch_configuration_matches_the_source(dims):
    """``struct_words`` / ``launch_config`` of each B1e build (default and
    bias) equal the structs of the source as that build sees it; Work is
    B1b's / B1c's with the cube's 13 state rows (its depths are not kept),
    so four blocks (16 warps) still fit on an SM, the bias builds too."""
    from test_torch_fused_b1d_spec import _expand_bias_macro
    for bias in (False, True):
        src = _expand_bias_macro(_b1e_source(bias))
        env = obj_constants(src, dims)
        words = {"spec": obj_words(src, "Spec", env), "obj": obj_words(src, "ObjSpec", env),
                 "grid": obj_words(src, "GridSpec", env) if len(dims) > 6 else 0,
                 "work": obj_words(src, "Work", env)}
        assert fused.struct_words(dims, True, bias) == words
        assert words["work"] == fused.struct_words(dims, False, bias)["work"] + 13
        assert words["spec"] == fused.struct_words(dims, False, bias)["spec"] + 19
        cfg = fused.launch_config(2048, dims, True, bias)
        smem = 4 * (words["spec"] + fused.WARPS * (words["work"] + words["obj"] + words["grid"]))
        assert cfg["dynamic_smem_bytes"] == smem and cfg["blocks"] == 512
        assert SM_BYTES // (smem + BLOCK_RESERVED) * fused.WARPS >= 16, (bias, smem)


def test_build_commands_and_names(monkeypatch, boxes):
    """B1e adds -DFIS_BODY=1 and ``_body`` to the library name, with the
    grid dims when the cabinet has mesh geoms; B1b / B1c's default builds
    keep their commands and names."""
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: "nvcc")
    _, _, _, scene, _ = boxes
    lib = fused.scene_library(scene)
    assert lib.name == "b1e" and "-DFIS_BODY=1" in lib.command()
    assert lib.path.endswith("libfused_inner_step_obj_L16_D12_S18_Lo9_Do4_G25_body.so")
    grid = fused.library("b1e", B1E_GRID, True)
    assert grid.name == "b1e_bias" and grid.path.endswith(
        "libfused_inner_step_obj_L16_D12_S18_Lo9_Do4_G21_K4_X29_Y73_Z73_body_bias.so")
    assert "fis_grid_bytes" in grid.signatures and "fis_grid_bytes" not in lib.signatures
    for variant, dims in (("b1b", B1E), ("b1c", B1E_GRID)):
        cmd = fused.library(variant, dims).command()
        assert not any("FIS_BODY" in c or "FIS_BIAS" in c for c in cmd)


def _composed_state(env, scene, E, seed=0):
    st, tg = contact_states.body_drawer_contact_states(env, scene.free_body, E, seed)
    return st, tg


def test_layout_roundtrip_and_cpu_routing(boxes, monkeypatch):
    """pack_state / unpack_state are exact with both parts, the object's
    rows where B1b packs them; physics_step on CPU tensors takes the plain
    version and never builds, loads or launches; launch_packed refuses CPU
    tensors."""
    _, tenv, _, scene, _ = boxes
    st, tg = _composed_state(tenv, scene, 8)
    sim = convert.scene_state_from_numpy(st)
    targets = torch.as_tensor(tg)
    buf, anc_b = fused.pack_state(sim, targets)
    L, D, S, Lo, Do, G = B1E
    assert buf.shape == (fused.state_rows_obj_body(D, S, Do), 8)
    b1b, _ = fused.pack_state(sim._replace(body=None), targets)
    n_obj = fused.state_rows_obj(D, S, Do) - 3 * S - D
    assert torch.equal(buf[:n_obj], b1b[:n_obj])
    assert torch.equal(buf[n_obj:n_obj + 13].t(), torch.cat(list(sim.body), dim=1))
    back = fused.unpack_state(buf, anc_b, sim)
    for part in ("robot", "obj", "body", "anchors"):
        for a, b in zip(getattr(back, part), getattr(sim, part)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def boom(*a, **k):
        raise AssertionError("the kernel library was asked for on the CPU")
    for name in ("load", "start"):
        monkeypatch.setattr(cuda_lib.Library, name, boom)
    monkeypatch.setattr(cuda_lib, "find_nvcc", boom)
    cuda_lib.reset_launch_counts()
    out = tengine.physics_step(scene, sim, targets)
    assert torch.isfinite(out.body.pos).all() and sum(fused.launch_counts.values()) == 0
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        fused.launch_packed(scene, buf, anc_b, 1)


def _to_jax(d):
    tree = lambda t: JTree(**{k: jnp.asarray(v) for k, v in t.items()})
    return jengine.SceneState(
        robot=tree(d["robot"]), obj=tree(d["obj"]),
        body=JBody(**{k: jnp.asarray(v) for k, v in d["body"].items()}),
        anchors=jcontact.AnchorState(point=jnp.asarray(d["anchors"]["point"]),
                                     body=jnp.asarray(d["anchors"]["body"], jnp.int32)))


def _to_numpy(sim):
    leaves = lambda t: {k: np.asarray(getattr(t, k)) for k in t._fields}
    return {k: leaves(getattr(sim, k)) for k in ("robot", "obj", "body", "anchors")}


@pytest.mark.parametrize("case", ["boxes", "mesh"])
def test_inner_step_matches_jax(request, case):
    """One inner step of the composed scene, two reference steps into the
    hand-made states: the port's plain engine against the JAX jnp engine.
    The spheres choose the cube (partner 1) and the handle's boxes (2 + g)
    or grids (2 + G + k), and their anchors sit on both."""
    jenv, tenv, jscene, tscene, jstep = request.getfixturevalue(case)
    E = tenv.num_envs
    st, tg = _composed_state(tenv, tscene, E)
    sim = _to_jax(st)
    for _ in range(2):
        sim = jstep(sim, jnp.asarray(tg))
    sim_np = _to_numpy(sim)
    census_env = type("Census", (), {"scene": tscene, "spheres": tenv.spheres})
    live = contact_states.touching_counts(census_env, convert.scene_state_from_numpy(sim_np))
    for k in ("ground", "cube", "boxes", "anchors_on_cube", "anchors_on_ground",
              "anchors_on_grids" if case == "mesh" else "anchors_on_boxes"):
        assert live[k] > 0, f"{case}: a contact branch is dead: {live}"
    want = jstep(sim, jnp.asarray(tg))
    sp = tscene.params
    got = tengine._inner_step(tscene, convert.scene_state_from_numpy(sim_np), torch.as_tensor(tg),
                              sp.h, torch.tensor([0.0, 0.0, sp.gravity]), coriolis=False)
    close = lambda a, b, tol, what: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), atol=tol, rtol=0, err_msg=f"{case}: {what}")
    close(got.robot.qpos, want.robot.qpos, 1e-5, "robot qpos")
    close(got.robot.qvel, want.robot.qvel, 1e-3, "robot qvel")
    close(got.obj.qpos, want.obj.qpos, 1e-5, "obj qpos")
    close(got.obj.qvel, want.obj.qvel, 1e-3, "obj qvel")
    close(got.body.pos, want.body.pos, 1e-5, "cube pos")
    close(got.body.quat, want.body.quat, 1e-5, "cube quat")
    close(got.body.linvel, want.body.linvel, 1e-3, "cube linvel")
    close(got.body.angvel, want.body.angvel, 1e-2, "cube angvel")
    close(got.anchors.point, want.anchors.point, 1e-4, "anchor points")
    ids = np.asarray(want.anchors.body)
    assert (got.anchors.body.numpy() == ids).mean() >= 0.999
    koff = 2 + tscene.obj_boxes.link_idx.shape[-1]
    on_obj = (ids >= koff) if case == "mesh" else ((ids >= 2) & (ids < koff))
    assert (ids == 1).sum() > 0 and on_obj.sum() > 0, np.unique(ids, return_counts=True)
    assert float(np.abs(np.asarray(want.body.linvel) - st["body"]["linvel"]).max()) > 1e-3
