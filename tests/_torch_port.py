"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: build the
JAX env and its counterpart in the port from the same flags, and hand
states and weights across as numpy."""

import numpy as np
import jax


def jax_scene_to_numpy(sim):
    """A JAX ``SceneState`` as the nested numpy dict the port's
    ``utils.convert.scene_state_from_numpy`` takes."""
    leaves = lambda t: {k: np.asarray(getattr(t, k)) for k in t._fields}
    return {"robot": leaves(sim.robot), "body": leaves(sim.body),
            "anchors": leaves(sim.anchors)}


def jax_env_state_to_numpy(st):
    out = {k: np.asarray(getattr(st, k)) for k in (
        "progress", "rew_buf", "success", "reset_buf", "reset_succ",
        "epis_max_rew", "epis_max_step")}
    out["sim"] = jax_scene_to_numpy(st.sim)
    return out


def numpy_scene_to_jax(d):
    """The inverse of :func:`jax_scene_to_numpy`."""
    import jax.numpy as jnp
    from partmanip_tpu.sim import contact, engine
    from partmanip_tpu.sim.types import FreeBodyState, TreeState
    return engine.SceneState(
        robot=TreeState(**{k: jnp.asarray(v) for k, v in d["robot"].items()}),
        body=FreeBodyState(**{k: jnp.asarray(v) for k, v in d["body"].items()}),
        anchors=contact.AnchorState(
            point=jnp.asarray(d["anchors"]["point"]),
            body=jnp.asarray(d["anchors"]["body"], jnp.int32)))


def jax_params_to_numpy(params):
    """JAX ``ACParams`` flattened to plain numpy for
    ``utils.convert.actor_critic_from_jax``."""
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return {"actor": to_np(params.actor), "critic": to_np(params.critic),
            "log_std": np.asarray(params.log_std)}


def make_envs(flags):
    """(jax env, jax cfg, jax sim params, port env, port cfg) from one list
    of CLI flags; the port's env on the CPU."""
    from partmanip_tpu import config as jconfig
    from partmanip_tpu.envs.grasp_cube import GraspCubeEnv as JEnv
    from partmanip_tpu_torch import config as tconfig
    from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv as TEnv
    jcfg, jsp = jconfig.process_cfgs(list(flags))
    tcfg, tsp = tconfig.process_cfgs(list(flags))
    return (JEnv(jcfg["task"], jsp), jcfg, jsp,
            TEnv(tcfg["task"], tsp, device="cpu"), tcfg)


def assert_scene_close(torch_sim, jax_sim, err_msg=""):
    """One-inner-step tolerances of tests/test_fused.py (f32 re-association
    only; the effort-clamped drives amplify it in the velocities)."""
    t = lambda x: x.detach().cpu().numpy()
    close = np.testing.assert_allclose
    close(t(torch_sim.robot.qpos), np.asarray(jax_sim.robot.qpos), atol=1e-5,
          rtol=0, err_msg=err_msg + " robot qpos")
    close(t(torch_sim.robot.qvel), np.asarray(jax_sim.robot.qvel), atol=1e-3,
          rtol=0, err_msg=err_msg + " robot qvel")
    close(t(torch_sim.body.pos), np.asarray(jax_sim.body.pos), atol=1e-5,
          rtol=0, err_msg=err_msg + " body pos")
    close(t(torch_sim.body.linvel), np.asarray(jax_sim.body.linvel), atol=1e-3,
          rtol=0, err_msg=err_msg + " body linvel")
    close(t(torch_sim.body.angvel), np.asarray(jax_sim.body.angvel), atol=1e-2,
          rtol=0, err_msg=err_msg + " body angvel")
    close(t(torch_sim.anchors.point), np.asarray(jax_sim.anchors.point),
          atol=1e-4, rtol=0, err_msg=err_msg + " anchor points")
    same = (t(torch_sim.anchors.body) == np.asarray(jax_sim.anchors.body)).mean()
    assert same > 0.999, f"{err_msg} anchor partner ids diverge: {same}"


DEFAULT_DOF = np.array([0.6806, -0.2319, -0.6754, -2.4905, -0.1961, 2.2925,
                        -0.6390, 0.04, 0.04], np.float32)


def make_robot(mobile, E=4):
    """Both packages' Franka specs (each built by its own package) and one
    random state near the default pose."""
    import jax.numpy as jnp
    import torch
    from partmanip_tpu.sim import franka as jfranka
    from partmanip_tpu.sim import kinematics as jkin
    from partmanip_tpu.sim import types as jtypes
    from partmanip_tpu_torch.sim import franka as tfranka
    from partmanip_tpu_torch.sim import kinematics as tkin
    from partmanip_tpu_torch.sim import types as ttypes
    T = torch.as_tensor
    jb = jfranka.build_franka(mobile=mobile)
    tb = tfranka.build_franka(mobile=mobile)
    for a, b in zip(jb.spec, tb.spec):
        np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(11 + mobile)
    D = jb.spec.dof_mask.shape[-1]
    q0 = np.concatenate([np.zeros(D - 9, np.float32), DEFAULT_DOF])
    state = dict(
        qpos=(q0 + rs.uniform(-0.1, 0.1, (E, D))).astype(np.float32),
        qvel=rs.uniform(-0.5, 0.5, (E, D)).astype(np.float32),
        root_pos=rs.uniform(-0.1, 0.1, (E, 3)).astype(np.float32),
        root_quat=np.tile(np.array([0, 0, 0.70710678, 0.70710678], np.float32),
                          (E, 1)))
    state["qpos"][:, -2:] = rs.uniform(0.0, 0.04, (E, 2))
    jstate = jtypes.TreeState(**{k: jnp.asarray(v) for k, v in state.items()})
    tstate = ttypes.TreeState(**{k: T(v) for k, v in state.items()})
    tspec = ttypes.to_device(tb.spec, "cpu")
    jfk = jkin.forward_kinematics(jb.spec, jstate)
    tfk = tkin.forward_kinematics(tspec, tstate)
    return dict(jb=jb, tb=tb, jspec=jb.spec, tspec=tspec, jstate=jstate,
                tstate=tstate, jfk=jfk, tfk=tfk, rs=rs, D=D)


