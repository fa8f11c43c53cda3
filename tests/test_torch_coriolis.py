"""``sim.coriolis=True`` in the port: the velocity-product term of
``partmanip_tpu_torch/sim/dynamics.py:bias_forces`` against the JAX
package's (jitted) on the mobile Franka and on an open_drawer cabinet tree
with random ``qpos`` / ``qvel`` and ``gravity_scale`` 1, against the port's
own ``bias_forces_jvp``, the double pendulum's energy with it on (the check
of ``tests/test_dynamics.py``), and one plain inner step with it of each
scene the kernels run (cube, cabinet, the robot alone) against the JAX
engine's jitted ``_inner_step``.  The kernels' bias builds are held against
these plain versions on the card by ``chip_smoke.py`` (phase ``tooling``).

Tolerances: the biases atol 1e-4 on values up to ~20 N·m (f32 sums in
other orders); the inner step those of ``tests/test_fused.py`` (qpos 1e-5,
qvel 1e-3, object qpos 1e-5, object qvel 1e-3, body angvel 1e-2, anchor
points 1e-4, partner ids ≥ 99.9 % equal); the pendulum's energy drift
< 2 % of its scale over 1 s."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu import config as jconfig
from partmanip_tpu.envs.open_drawer import OpenDrawerEnv as JDrawer
from partmanip_tpu.sim import contact as jcontact
from partmanip_tpu.sim import dynamics as jdyn
from partmanip_tpu.sim import engine as jengine
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv as TDrawer
from partmanip_tpu_torch.sim import builder, dynamics as tdyn
from partmanip_tpu_torch.sim import engine as tengine
from partmanip_tpu_torch.sim import kinematics as tkin
from partmanip_tpu_torch.sim.types import JOINT_REVOLUTE, TreeState
from partmanip_tpu_torch.utils import contact_states, convert

import _torch_port as tp

E = 4
G_VEC = np.array([0.0, 0.0, -9.81], np.float32)
T = torch.as_tensor


@pytest.fixture(scope="module")
def drawer(tmp_path_factory):
    flags = ["--taskcfg", "open_drawer", "--algo.num_envs", str(E),
             "--task.asset.num_objects", "3",
             "--task.asset.assetRoot", str(tmp_path_factory.mktemp("assets"))]
    jcfg, jsp = jconfig.process_cfgs(list(flags))
    tcfg, tsp = tconfig.process_cfgs(list(flags))
    random.seed(4)
    jenv = JDrawer(jcfg["task"], jsp)
    random.seed(4)
    tenv = TDrawer(tcfg["task"], tsp, device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def cube():
    jenv, _, jsp, tenv, _ = tp.make_envs(["--taskcfg", "grasp_cube", "--algo.num_envs", str(E)])
    return jenv, tenv


def _tree(name, drawer):
    """(JAX spec, port spec, JAX state, port state) of a tree under gravity
    (gravity_scale 1) with a random state: the mobile Franka near its
    default pose, or the cabinet, its root tilted at random and its
    drawers partly open."""
    rs = np.random.RandomState(3)
    if name == "franka_mobile":
        r = tp.make_robot(True, E)
        js, ts, jst, tst = r["jspec"], r["tspec"], r["jstate"], r["tstate"]
        tst = tst._replace(qvel=tst.qvel * 4.0)          # up to 2 rad/s
        jst = jst._replace(qvel=jnp.asarray(tst.qvel.numpy()))
    else:
        jenv, tenv = drawer
        js, ts = jenv.scene.obj_tree, tenv.scene.obj_tree
        Do = ts.dof_mask.shape[-1]
        quat = rs.normal(size=(E, 4))                     # tilted: gravity along the joints
        st = {"qpos": rs.uniform(0, 0.3, (E, Do)), "qvel": rs.uniform(-2, 2, (E, Do)),
              "root_pos": np.tile([-0.6, 0.0, 0.5], (E, 1)),
              "root_quat": quat / np.linalg.norm(quat, axis=-1, keepdims=True)}
        st = {k: np.asarray(v, np.float32) for k, v in st.items()}
        from partmanip_tpu.sim.types import TreeState as JTree
        jst = JTree(**{k: jnp.asarray(v) for k, v in st.items()})
        tst = TreeState(**{k: T(v) for k, v in st.items()})
    js = js._replace(gravity_scale=jnp.ones_like(jnp.asarray(js.gravity_scale)))
    ts = ts._replace(gravity_scale=torch.ones_like(ts.gravity_scale))
    return js, ts, jst, tst


@pytest.mark.parametrize("name", ["franka_mobile", "cabinet"])
def test_bias_with_coriolis_matches_jax(drawer, name):
    js, ts, jst, tst = _tree(name, drawer)
    want = jax.jit(lambda st: jdyn.bias_forces(js, st, jnp.asarray(G_VEC), coriolis=True))(jst)
    got = tdyn.bias_forces(ts, tst, T(G_VEC), coriolis=True)
    velocity = got - tdyn.bias_forces(ts, tst, T(G_VEC), coriolis=False)
    assert float(got.abs().max()) > 1e-1
    if name == "franka_mobile":    # the drawers slide: no velocity product
        assert float(velocity.abs().max()) > 1e-2, "the velocity-product term is idle"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["franka_mobile", "cabinet"])
def test_bias_matches_its_jvp(drawer, name):
    _, ts, _, tst = _tree(name, drawer)
    got = tdyn.bias_forces(ts, tst, T(G_VEC), coriolis=True)
    want = tdyn.bias_forces_jvp(ts, tst, T(G_VEC), coriolis=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


def test_double_pendulum_energy_with_coriolis():
    """The chaotic double pendulum of tests/test_dynamics.py conserves
    energy through M(q) and the velocity-product terms together."""
    l, m, g = 0.4, 1.0, 9.81
    t = builder.build_tree([
        builder.LinkDef("base"),
        builder.LinkDef("rod1", parent="base", joint_type=JOINT_REVOLUTE,
                        axis=(0, 1, 0), lower=-20, upper=20, mass=m,
                        com=(0, 0, -l), inertia=(1e-4,) * 3),
        builder.LinkDef("rod2", parent="rod1", joint_type=JOINT_REVOLUTE,
                        origin_pos=(0, 0, -l), axis=(0, 1, 0),
                        lower=-20, upper=20, mass=m,
                        com=(0, 0, -l), inertia=(1e-4,) * 3),
    ])
    from partmanip_tpu_torch.sim.types import to_device
    spec = to_device(t.spec, "cpu")
    h = 1.0 / 1920
    grav = T(G_VEC)
    st = TreeState(qpos=T([[1.5, 0.5]]), qvel=torch.zeros(1, 2),
                   root_pos=torch.zeros(1, 3), root_quat=T([[0.0, 0, 0, 1]]))

    def energy(st):
        fk = tkin.forward_kinematics(spec, st)
        M = tdyn.mass_matrix(spec, fk, 1)
        ke = 0.5 * float(st.qvel[0] @ M[0] @ st.qvel[0])
        _, _, com_w = tkin.link_jacobians(spec, fk)
        return ke + float(m * g * (com_w[0, 1, 2] + com_w[0, 2, 2]))

    e0 = energy(st)
    tau = torch.zeros(1, 2)
    with torch.no_grad():
        for _ in range(1920):
            fk = tkin.forward_kinematics(spec, st)
            M = tdyn.mass_matrix(spec, fk, 1)
            st = tdyn.step_tree(spec, st, fk, M, st.qpos, tau, h, grav, coriolis=True)
    assert abs(energy(st) - e0) / (2 * m * g * 2 * l) < 0.02
    assert float(st.qvel.abs().max()) > 1.0, "the pendulum did not swing"


def _cube_case(tenv):
    st, targets = contact_states.grasp_contact_states(tenv, E, seed=2)
    st["robot"]["qvel"] = np.random.RandomState(5).uniform(
        -1.5, 1.5, st["robot"]["qvel"].shape).astype(np.float32)
    return st, targets


def _drawer_case(tenv):
    st, targets = contact_states.drawer_contact_states(tenv, E, seed=1)
    rs = np.random.RandomState(6)
    st["robot"]["qvel"] = rs.uniform(-1.5, 1.5, st["robot"]["qvel"].shape).astype(np.float32)
    st["obj"]["qvel"] = rs.uniform(-1.0, 1.0, st["obj"]["qvel"].shape).astype(np.float32)
    return st, targets


def _to_jax(d):
    from partmanip_tpu.sim.types import FreeBodyState as JBody
    from partmanip_tpu.sim.types import TreeState as JTree
    tree = lambda t: None if t is None else JTree(**{k: jnp.asarray(v) for k, v in t.items()})
    body = d.get("body")
    return jengine.SceneState(
        robot=tree(d["robot"]), obj=tree(d.get("obj")),
        body=None if body is None else JBody(**{k: jnp.asarray(v) for k, v in body.items()}),
        anchors=jcontact.AnchorState(point=jnp.asarray(d["anchors"]["point"]),
                                     body=jnp.asarray(d["anchors"]["body"], jnp.int32)))


@pytest.mark.parametrize("scene_kind", ["cube", "cabinet", "robot_only"])
def test_inner_step_with_coriolis_matches_jax(cube, drawer, scene_kind):
    """One plain inner step with coriolis=True, from states with fast
    joints (and, for the cabinet, a moving object), equals the JAX engine's
    on the same state: the cube's and the cabinet's contact states, and the
    cube's with its cube taken out (the robot and the ground alone)."""
    jenv, tenv = drawer if scene_kind == "cabinet" else cube
    st, targets = (_drawer_case if scene_kind == "cabinet" else _cube_case)(tenv)
    jscene, tscene = jenv.scene, tenv.scene
    if scene_kind == "robot_only":
        st = {k: v for k, v in st.items() if k != "body"}
        jscene, tscene = jscene._replace(free_body=None), tscene._replace(free_body=None)
    jsp = jscene.params._replace(use_fused=False)
    jscene = jscene._replace(params=jsp)
    gravity = jnp.array([0.0, 0.0, jsp.gravity])
    want = jax.jit(lambda s, tg: jengine._inner_step(jscene, s, tg, jsp.h, gravity,
                                                     coriolis=True))(
        _to_jax(st), jnp.asarray(targets))
    sp = tscene.params
    sim = convert.scene_state_from_numpy(st)
    got = tengine._inner_step(tscene, sim, T(targets), sp.h, T([0.0, 0.0, sp.gravity]),
                              coriolis=True)
    off = tengine._inner_step(tscene, sim, T(targets), sp.h, T([0.0, 0.0, sp.gravity]),
                              coriolis=False)
    assert float((got.robot.qvel - off.robot.qvel).abs().max()) > 1e-5, "coriolis idle"
    close = lambda a, b, tol, what: np.testing.assert_allclose(
        a.detach().numpy(), np.asarray(b), atol=tol, rtol=0, err_msg=f"{scene_kind} {what}")
    close(got.robot.qpos, want.robot.qpos, 1e-5, "robot qpos")
    close(got.robot.qvel, want.robot.qvel, 1e-3, "robot qvel")
    close(got.anchors.point, want.anchors.point, 1e-4, "anchor points")
    assert (got.anchors.body.numpy() == np.asarray(want.anchors.body)).mean() >= 0.999
    if scene_kind == "cabinet":
        close(got.obj.qpos, want.obj.qpos, 1e-5, "object qpos")
        close(got.obj.qvel, want.obj.qvel, 1e-3, "object qvel")
    if scene_kind == "cube":
        close(got.body.pos, want.body.pos, 1e-5, "body pos")
        close(got.body.linvel, want.body.linvel, 1e-3, "body linvel")
        close(got.body.angvel, want.body.angvel, 1e-2, "body angvel")
