"""The plain version of kernel B1b — the articulated-object branch of
``partmanip_tpu_torch/sim/engine.py:_inner_step`` — against the JAX
reference ``partmanip_tpu/sim/engine.py:_inner_step`` on an open_drawer
scene (8 envs, 3 cabinets), for ONE inner step from identical states
(longer horizons are chaotic under the effort-clamped drives), and the
per-env object helpers it is built from (kinematics, mass matrix, box
poses, sphere × box contacts with G > 1).  The kernel itself is held
against the plain version on the GPU by ``chip_smoke.py``.

Tolerances are those of tests/test_fused.py: qpos 1e-5, qvel 1e-3, object
qpos 1e-5, object qvel 1e-3, anchor points 1e-4, partner ids ≥ 99.9 %
equal.  Both packages' envs are built after seeding ``random`` alike: the
object order is a shuffle by the global ``random``."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu import config as jconfig
from partmanip_tpu.envs.open_drawer import OpenDrawerEnv as JEnv
from partmanip_tpu.sim import contact as jcontact
from partmanip_tpu.sim import dynamics as jdyn
from partmanip_tpu.sim import engine as jengine
from partmanip_tpu.sim import kinematics as jkin
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv as TEnv
from partmanip_tpu_torch.sim import contact as tcontact
from partmanip_tpu_torch.sim import dynamics as tdyn
from partmanip_tpu_torch.sim import engine as tengine
from partmanip_tpu_torch.sim import kinematics as tkin
from partmanip_tpu_torch.sim.types import TreeState
from partmanip_tpu_torch.utils import contact_states, convert

E = 8


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    flags = ["--taskcfg", "open_drawer", "--algo.num_envs", str(E),
             "--task.asset.num_objects", "3",
             "--task.asset.assetRoot", str(tmp_path_factory.mktemp("assets"))]
    jcfg, jsp = jconfig.process_cfgs(list(flags))
    tcfg, tsp = tconfig.process_cfgs(list(flags))
    random.seed(4)
    jenv = JEnv(jcfg["task"], jsp)
    random.seed(4)
    tenv = TEnv(tcfg["task"], tsp, device="cpu")
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
    jenv, tenv, _ = envs
    for part in ("robot", "obj_tree", "obj_boxes", "spheres"):
        for a, b in zip(getattr(jenv.scene, part), getattr(tenv.scene, part)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=part)
    np.testing.assert_array_equal(jenv.obj_lstid, tenv.obj_lstid)
    np.testing.assert_array_equal(jenv.part_bbox_init, tenv.part_bbox_init)
    np.testing.assert_array_equal(jenv.target_dof, tenv.target_dof)


def test_per_env_object_helpers(envs):
    """Per-env (leading size E) specs through forward kinematics, frame
    Jacobians, the mass matrix, the box world poses and sphere × box
    contacts with G > 1 and a box-velocity function."""
    jenv, tenv, _ = envs
    rs = np.random.RandomState(0)
    Do = tenv.scene.obj_tree.dof_mask.shape[-1]
    st = {"qpos": rs.uniform(0, 0.2, (E, Do)), "qvel": rs.uniform(-0.3, 0.3, (E, Do)),
          "root_pos": np.tile([-0.6, 0.0, 0.5], (E, 1)) + rs.uniform(-0.05, 0.05, (E, 3)),
          "root_quat": np.tile([0.0, 0.0, 1.0, 0.0], (E, 1))}
    st = {k: np.asarray(v, np.float32) for k, v in st.items()}
    from partmanip_tpu.sim.types import TreeState as JTree
    jst = JTree(**{k: jnp.asarray(v) for k, v in st.items()})
    tst = TreeState(**{k: torch.as_tensor(v) for k, v in st.items()})
    jo, to = jenv.scene.obj_tree, tenv.scene.obj_tree
    jfk, tfk = jkin.forward_kinematics(jo, jst), tkin.forward_kinematics(to, tst)
    for a, b in zip(jfk, tfk):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    G = tenv.scene.obj_boxes.link_idx.shape[-1]
    np.testing.assert_allclose(
        tkin.frame_jacobian(to, tfk, tenv.scene.obj_boxes.link_idx).numpy(),
        np.asarray(jkin.frame_jacobian(jo, jfk, jnp.asarray(jenv.scene.obj_boxes.link_idx))),
        atol=1e-6)
    np.testing.assert_allclose(tdyn.mass_matrix(to, tfk, E).numpy(),
                               np.asarray(jdyn.mass_matrix(jo, jfk, E)), atol=1e-5)
    jbp, jbq = jengine.obj_box_world(jo, jenv.scene.obj_boxes, jfk, E)
    tbp, tbq = tengine.obj_box_world(to, tenv.scene.obj_boxes, tfk, E)
    np.testing.assert_allclose(tbp.numpy(), np.asarray(jbp), atol=1e-6)
    np.testing.assert_allclose(tbq.numpy(), np.asarray(jbq), atol=1e-6)
    # spheres placed around the boxes so that some touch
    S = 18
    centers = (np.asarray(jbp)[:, rs.randint(0, G, S)]
               + rs.uniform(-0.03, 0.03, (E, S, 3))).astype(np.float32)
    radii = np.full(S, 0.01, np.float32)
    mu = np.ones(S, np.float32)
    w = rs.uniform(-1, 1, (E, G, 3)).astype(np.float32)
    jv = lambda pts: jnp.cross(jnp.asarray(w)[:, None], pts - jbp[:, None])
    tv = lambda pts: torch.linalg.cross(torch.as_tensor(w)[:, None].expand_as(pts),
                                        pts - tbp[:, None])
    b = tenv.scene.obj_boxes
    jcs, _ = jcontact.spheres_vs_boxes(
        jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(mu), jbp, jbq,
        jnp.asarray(b.half_extents.numpy()), jnp.asarray(b.geom_mask.numpy()),
        jnp.asarray(b.friction.numpy()), jv)
    tcs, _ = tcontact.spheres_vs_boxes(
        torch.as_tensor(centers), torch.as_tensor(radii), torch.as_tensor(mu), tbp, tbq,
        b.half_extents, b.geom_mask, b.friction, tv)
    assert int((tcs.depth < 0).sum()) > 0
    for a, c in zip(jcs, tcs):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=1e-5)


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
    """Hand-made contact states (fingers in / on the handle bar, spheres on
    two boxes, pads in the ground), two reference steps in so anchors exist."""
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
    for k in ("ground", "boxes", "two_boxes", "anchors_on_ground", "anchors_on_boxes"):
        assert live[k] > 0, f"a contact branch is dead: {live}"
    want = jstep(sim, jnp.asarray(targets))
    got = _torch_step(tenv, sim_np, targets)
    _assert_close(got, want, "contact state:")
    assert float(np.abs(np.asarray(want.obj.qvel)).max()) > 1e-4, "the cabinet did not move"


def test_partner_choice_on_two_boxes(envs, contact_case):
    """A sphere touching two boxes takes the first of the deepest: the
    port's argmin agrees with the JAX package's on every such sphere."""
    jenv, tenv, jstep = envs
    sim, targets = contact_case
    sim_np = _to_numpy(sim)
    tsim = convert.scene_state_from_numpy(sim_np)
    two = (contact_states.sphere_box_depths(tenv, tsim) < 0).sum(-1) > 1
    assert int(two.sum()) > 0
    want = jstep(sim, jnp.asarray(targets))
    got = _torch_step(tenv, sim_np, targets)
    ids_t = got.anchors.body.numpy()[two.numpy()]
    ids_j = np.asarray(want.anchors.body)[two.numpy()]
    np.testing.assert_array_equal(ids_t, ids_j)
