"""The plain version of kernel B1c — the mesh-SDF branch (3b) of
``partmanip_tpu_torch/sim/engine.py:_inner_step`` — against the JAX
reference ``partmanip_tpu/sim/engine.py:_inner_step`` on an open_drawer
scene whose handle bars are mesh geoms (10 envs, 2 cabinets, 4 mesh geoms
per env), for ONE inner step from identical states, on the warmed state and
on hand-made states with live grid contacts; the ported "handle pulls the
drawer, a far cabinet does not move" case; and the routing of such a scene
(CPU state takes the plain version and never builds kernel B1c).  The
kernel itself is held against the plain version on the GPU by
``chip_smoke.py``.

Tolerances are those of tests/test_torch_drawer_engine.py (from
tests/test_fused.py): qpos 1e-5, qvel 1e-3, object qpos 1e-5, object qvel
1e-3, anchor points 1e-4, partner ids ≥ 99.9 % equal.  The port's env is
built first into a fresh asset root and bakes the grids; the JAX env then
reads those caches (the bakes themselves are compared in
tests/test_torch_assets.py and tests/test_torch_sdf.py), after the same
``random.seed`` (the object order is a shuffle by the global ``random``)."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv

from partmanip_tpu import config as jconfig
from partmanip_tpu.envs.open_drawer import OpenDrawerEnv as JEnv
from partmanip_tpu.sim import contact as jcontact
from partmanip_tpu.sim import engine as jengine
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv as TEnv
from partmanip_tpu_torch.ops import rotations as trot
from partmanip_tpu_torch.sim import contact as tcontact
from partmanip_tpu_torch.sim import engine as tengine
from partmanip_tpu_torch.sim import fused, kinematics as tkin
from partmanip_tpu_torch.utils import contact_states, convert, cuda_lib

E = 10          # two of each kind of hand-made contact state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: the bakes and the plain steps are many small ops,
    which spin-wait under the test run's several workers when each op is
    split over every core (tests/_torch_vision.py)."""
    with tv.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    flags = ["--taskcfg", "open_drawer", "--algo.num_envs", str(E),
             "--task.asset.num_objects", "2", "--task.asset.mesh_handle",
             "--task.asset.assetRoot", str(tmp_path_factory.mktemp("assets"))]
    jcfg, jsp = jconfig.process_cfgs(list(flags))
    tcfg, tsp = tconfig.process_cfgs(list(flags))
    random.seed(4)
    tenv = TEnv(tcfg["task"], tsp, device="cpu")
    random.seed(4)
    jenv = JEnv(jcfg["task"], jsp)
    ref_scene = jenv.scene._replace(params=jsp._replace(use_fused=False))
    gravity = jnp.array([0.0, 0.0, jsp.gravity])
    jstep = jax.jit(lambda s, t: jengine._inner_step(
        ref_scene, s, t, jsp.h, gravity, coriolis=False))
    return jenv, tenv, jstep


def _to_jax(d):
    from partmanip_tpu.sim.types import TreeState as JTree
    tree = lambda t: JTree(**{k: jnp.asarray(v) for k, v in t.items()})
    return jengine.SceneState(
        robot=tree(d["robot"]), obj=tree(d["obj"]),
        anchors=jcontact.AnchorState(point=jnp.asarray(d["anchors"]["point"]),
                                     body=jnp.asarray(d["anchors"]["body"], jnp.int32)))


def _to_numpy(sim):
    leaves = lambda t: {k: np.asarray(getattr(t, k)) for k in t._fields}
    return {"robot": leaves(sim.robot), "obj": leaves(sim.obj),
            "anchors": leaves(sim.anchors)}


def _torch_step(tenv, sim_np, targets):
    sp = tenv.scene.params
    return tengine._inner_step(
        tenv.scene, convert.scene_state_from_numpy(sim_np), torch.as_tensor(targets),
        sp.h, torch.tensor([0.0, 0.0, sp.gravity]), coriolis=False)


def _assert_close(got, want, msg):
    t = lambda x: x.detach().numpy()
    close = np.testing.assert_allclose
    close(t(got.robot.qpos), np.asarray(want.robot.qpos), atol=1e-5, rtol=0,
          err_msg=msg + " robot qpos")
    close(t(got.robot.qvel), np.asarray(want.robot.qvel), atol=1e-3, rtol=0,
          err_msg=msg + " robot qvel")
    close(t(got.obj.qpos), np.asarray(want.obj.qpos), atol=1e-5, rtol=0,
          err_msg=msg + " obj qpos")
    close(t(got.obj.qvel), np.asarray(want.obj.qvel), atol=1e-3, rtol=0,
          err_msg=msg + " obj qvel")
    close(t(got.anchors.point), np.asarray(want.anchors.point), atol=1e-4, rtol=0,
          err_msg=msg + " anchor points")
    same = (t(got.anchors.body) == np.asarray(want.anchors.body)).mean()
    assert same >= 0.999, f"{msg} anchor partner ids diverge: {same}"


def test_scenes_are_equal(envs):
    """Grid geoms per env (K = 4 mesh handles, grid ids into one stack) and
    the stack itself, beside the box scene of the B1b tests."""
    jenv, tenv, _ = envs
    for part in ("robot", "obj_tree", "obj_boxes", "obj_grids", "grid_stack", "spheres"):
        for a, b in zip(getattr(jenv.scene, part), getattr(tenv.scene, part)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=part)
    g = tenv.scene.obj_grids
    assert g.link_idx.shape == (E, 4) and float(g.geom_mask.sum()) > E
    assert fused.variant(tenv.scene) == "b1c"
    M = tenv.scene.grid_stack.sdf.shape[0]
    assert int(g.grid_id.max()) < M == int(g.geom_mask[:2].sum())


def test_inner_step_after_warmup(envs):
    """Env init state, targets ±0.05 rad around the default pose, 8
    reference inner steps, then one step through both packages."""
    jenv, tenv, jstep = envs
    sim = jenv.init_state(jax.random.PRNGKey(0)).sim
    rng = np.random.RandomState(1)
    targets = (np.tile(jenv.default_dof, (E, 1))
               + rng.uniform(-0.05, 0.05, (E, 12))).astype(np.float32)
    for _ in range(8):
        sim = jstep(sim, jnp.asarray(targets))
    want = jstep(sim, jnp.asarray(targets))
    got = _torch_step(tenv, _to_numpy(sim), targets)
    assert float(np.abs(np.asarray(want.robot.qvel)).max()) > 1e-3
    _assert_close(got, want, "warmed state:")


@pytest.fixture(scope="module")
def contact_case(envs):
    """Hand-made contact states (fingers in and against the mesh bar, a pad
    hooked behind its back face, a pad on a post box and the bar, pads in
    the ground), two reference steps in so anchors exist."""
    jenv, tenv, jstep = envs
    st, targets = contact_states.drawer_contact_states(tenv, E, seed=0)
    sim = _to_jax(st)
    for _ in range(2):
        sim = jstep(sim, jnp.asarray(targets))
    return sim, targets


def test_inner_step_in_contact(envs, contact_case):
    jenv, tenv, jstep = envs
    sim, targets = contact_case
    sim_np = _to_numpy(sim)
    live = contact_states.touching_counts(tenv, convert.scene_state_from_numpy(sim_np))
    for k in ("ground", "boxes", "grids", "grid_pairs", "anchors_on_ground",
              "anchors_on_boxes", "anchors_on_grids"):
        assert live[k] > 0, f"a contact branch is dead: {live}"
    want = jstep(sim, jnp.asarray(targets))
    got = _torch_step(tenv, sim_np, targets)
    _assert_close(got, want, "contact state:")
    assert float(np.abs(np.asarray(want.obj.qvel)).max()) > 1e-4, "the cabinet did not move"
    # the partner ids of grid geoms start after the boxes
    G = tenv.scene.obj_boxes.link_idx.shape[-1]
    ids = got.anchors.body.numpy()
    assert ids.max() >= 2 + G and ids.max() < 2 + G + 4


def test_handle_contact_pulls_drawer(envs):
    """The case of the JAX package's tests/test_mesh_collision.py on the
    port: the cabinet teleported so that a finger-pad sphere sits just
    behind its mesh handle's back face (overlapping by 0.8 r) — the
    penalty contact pulls the drawer dof; the same cabinet 10 m up gives no
    object motion.  Drawer friction off and damping 1 (the contact
    coupling is measured, not drive-through-friction)."""
    _, tenv, _ = envs
    ot = tenv.scene.obj_tree
    scene = tenv.scene._replace(obj_tree=ot._replace(
        dof_friction=torch.zeros_like(ot.dof_friction),
        dof_damping=torch.ones_like(ot.dof_damping)))
    sim = tenv._default_sim(E)
    fk = tkin.forward_kinematics(scene.robot, sim.robot)
    centers = tcontact.sphere_positions(scene.robot, fk, tenv.spheres, E)
    pad = int(np.nonzero(tenv.spheres.sticky.numpy())[0][0])
    pad_pos = centers[:, pad].numpy()
    bbox0 = np.asarray(tenv.part_bbox_init)
    mid_local = 0.5 * (bbox0[:, 0] + bbox0[:, 6])
    R = trot.quat_to_mat(sim.obj.root_quat).numpy()
    ho = 0.5 * (bbox0[:, :, 0].max(1) - bbox0[:, :, 0].min(1))
    r = float(tenv.spheres.radius[pad])
    off = np.zeros_like(mid_local)
    off[:, 0] = ho + 0.2 * r
    root_pos = pad_pos - np.einsum("eab,eb->ea", R, mid_local + off)
    targets = torch.as_tensor(np.tile(tenv.default_dof, (E, 1)))
    td = torch.as_tensor(tenv.target_dof).long()
    ar = torch.arange(E)

    touch = sim._replace(obj=sim.obj._replace(root_pos=torch.as_tensor(root_pos)))
    out = tengine.physics_step(scene, touch, targets)
    qv = out.obj.qvel[ar, td]
    assert bool(torch.isfinite(out.robot.qpos).all())
    assert bool((qv.abs() > 1e-4).all()), qv
    far = sim._replace(obj=sim.obj._replace(
        root_pos=torch.as_tensor(root_pos + np.array([0, 0, 10.0], np.float32))))
    qv2 = tengine.physics_step(scene, far, targets).obj.qvel[ar, td]
    assert bool((qv2.abs() < 1e-6).all()), qv2


def test_cpu_state_never_touches_the_build(envs, monkeypatch):
    """physics_step on CPU tensors of a mesh-handle scene takes the plain
    version and neither builds, loads nor launches B1c; the B1c library is
    keyed on K and the grid stack's shape."""
    _, tenv, _ = envs

    def boom(*a, **k):
        raise AssertionError("the kernel library was asked for on the CPU")
    for name in ("load", "start"):
        monkeypatch.setattr(cuda_lib.Library, name, boom)
    monkeypatch.setattr(cuda_lib, "find_nvcc", boom)
    monkeypatch.setattr(fused, "launch_packed", boom)
    cuda_lib.reset_launch_counts()
    sim = tenv._default_sim(E)
    targets = torch.as_tensor(np.tile(tenv.default_dof, (E, 1)))
    out = tengine.physics_step(tenv.scene, sim, targets)
    via_wrapper = fused.fused_physics_step(tenv.scene, sim, targets)
    assert torch.equal(out.obj.qpos, via_wrapper.obj.qpos)
    assert fused.launch_counts == {"b1a": 0, "b1b": 0, "b1c": 0, "b1d": 0, "b1e": 0}
    monkeypatch.undo()
    buf, anc_b = fused.pack_state(sim, targets)
    with pytest.raises(ValueError, match="CUDA"):
        fused.launch_packed(tenv.scene, buf, anc_b, 1)
    dims = fused._dims(tenv.scene)
    X, Y, Z = tenv.scene.grid_stack.sdf.shape[1:]
    assert dims[6:] == (4, X, Y, Z)
    assert fused.library("b1c", dims).path.endswith(
        "_K4_X%d_Y%d_Z%d.so" % (X, Y, Z))
