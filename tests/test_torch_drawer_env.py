"""The open_drawer slice as a whole: the port's ``OpenDrawerEnv`` against
the JAX package's, through ``process_cfgs`` of both, at 8 envs and 3
cabinets.

* merged configs equal key by key;
* same initial ``EnvState`` (cabinet poses injected as numpy on both sides
  instead of the two frameworks' random draws) → ``reset`` obs to 1e-5,
  then three scripted ``env.step``s (actions from a numpy seed): obs and
  reward to 1e-3 (a control step is 8 inner steps of effort-clamped drives
  on f32 re-association seeds), reset flags, progress, success and the
  per-object success bitmap exact;
* the part-aware reward on hand-made grasps (gripper on the handle, aligned
  or not, drawer open or not) with a given bitmap: reward, success and
  ``succ_objid`` to 1e-5 / exact.

Both envs are built after seeding ``random`` alike (the object order is a
shuffle by the global ``random``)."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu import config as jconfig
from partmanip_tpu.envs.open_drawer import OpenDrawerEnv as JEnv
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv as TEnv
from partmanip_tpu_torch.ops import rotations as trot
from partmanip_tpu_torch.utils import convert

E = 8
N_STEPS = 3


def _deep_diff(a, b, path=""):
    if isinstance(a, dict) and isinstance(b, dict):
        out = [f"{path}{k}: only on one side" for k in set(a) ^ set(b)]
        for k in set(a) & set(b):
            out += _deep_diff(a[k], b[k], f"{path}{k}.")
        return out
    return [] if a == b and type(a) is type(b) else [f"{path[:-1]}: {a!r} != {b!r}"]


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    flags = ["--taskcfg", "open_drawer", "--algocfg", "ppo", "--algo.num_envs", str(E),
             "--task.asset.num_objects", "3", "--task.maxEpisodeLength", "10",
             "--task.asset.assetRoot", str(tmp_path_factory.mktemp("assets"))]
    jcfg, jsp = jconfig.process_cfgs(list(flags))
    tcfg, tsp = tconfig.process_cfgs(list(flags))
    random.seed(7)
    jenv = JEnv(jcfg["task"], jsp)
    random.seed(7)
    tenv = TEnv(tcfg["task"], tsp, device="cpu")

    rs = np.random.RandomState(21)
    dxyz = rs.uniform(-0.05, 0.05, (E, 3)).astype(np.float32)
    yaw = rs.uniform(-np.pi / 12, np.pi / 12, E).astype(np.float32)

    def injected_root(rng, n):
        from partmanip_tpu.ops import rotations as jrot
        base = jnp.tile(jnp.asarray([-0.6, 0.0, 0.5]), (n, 1))
        a = jnp.asarray(yaw)
        dq = jnp.stack([jnp.zeros(n), jnp.zeros(n), jnp.sin(a), jnp.cos(a)], -1)
        q0 = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0, 0.0]), (n, 4))
        return base + jnp.asarray(dxyz), jrot.quat_mul(q0, dq)
    jenv._random_obj_root = injected_root
    return dict(jenv=jenv, tenv=tenv, jcfg=jcfg, tcfg=tcfg, jsp=jsp, tsp=tsp,
                draws=(dxyz, yaw))


@pytest.fixture(scope="module")
def rollout(envs):
    jenv, tenv, draws = envs["jenv"], envs["tenv"], envs["draws"]
    jstate = jenv.init_state(jax.random.PRNGKey(0))
    tstate = tenv.init_state(tenv.make_generator(0), draws)
    init = (jstate, convert.env_state_to_numpy(tstate))
    jstate, jobs = jax.jit(jenv.reset)(jstate)
    jstep = jax.jit(lambda s, a: jenv.step(s, a, train=False))
    acts = np.random.RandomState(5).uniform(-1, 1, (N_STEPS, E, 10)).astype(np.float32)
    rec = lambda o, r, st, ex: dict(
        obs=np.array(o), rew=np.array(r), reset=np.array(st.reset_buf),
        progress=np.array(st.progress), success=np.array(st.success),
        task=np.array(st.task_state), extras=sorted(ex))
    with torch.no_grad():
        tstate, tobs = tenv.reset(tstate, draws)
        jtrace = [dict(obs=np.array(jobs["normal_state"]))]
        ttrace = [dict(obs=tobs["normal_state"].numpy())]
        for t in range(N_STEPS):
            jstate, jobs, jrew, _, jex = jstep(jstate, jnp.asarray(acts[t]))
            tstate, tobs, trew, _, tex = tenv.step(tstate, torch.as_tensor(acts[t]),
                                                   train=False)
            jtrace.append(rec(jobs["normal_state"], jrew, jstate, jex))
            ttrace.append(rec(tobs["normal_state"], trew, tstate, tex))
    return dict(init=init, jtrace=jtrace, ttrace=ttrace)


def test_merged_configs_are_equal(envs):
    assert _deep_diff(envs["jcfg"], envs["tcfg"]) == []
    assert envs["jsp"]._asdict() == envs["tsp"]._asdict()
    assert envs["tsp"].inner_substeps == 1 and envs["tcfg"]["task"]["controlFrequencyInv"] == 2


def test_initial_env_state_is_equal(rollout):
    jstate, tinit = rollout["init"]
    for part in ("robot", "obj", "anchors"):
        for k in getattr(jstate.sim, part)._fields:
            np.testing.assert_allclose(tinit["sim"][part][k],
                                       np.asarray(getattr(getattr(jstate.sim, part), k)),
                                       atol=1e-6, rtol=0, err_msg=f"{part}.{k}")
    np.testing.assert_array_equal(tinit["task_state"], np.asarray(jstate.task_state))
    assert tinit["task_state"].dtype == np.bool_ and tinit["task_state"].shape == (3,)


def test_reset_observation(rollout):
    got, want = rollout["ttrace"][0]["obs"], rollout["jtrace"][0]["obs"]
    assert got.shape == (E, 53)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("step", range(1, N_STEPS + 1))
def test_env_step(rollout, step):
    got, want = rollout["ttrace"][step], rollout["jtrace"][step]
    np.testing.assert_allclose(got["obs"], want["obs"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["rew"], want["rew"], atol=1e-3, rtol=0)
    for k in ("reset", "progress", "success", "task"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype, k
    assert got["extras"] == want["extras"]
    moved = np.abs(got["obs"] - rollout["ttrace"][0]["obs"]).max()
    assert moved > 1e-3, "the actions did not move the robot"


def _crafted(tenv):
    """Hand-made grasps on each env's handle: per env (reached, aligned,
    open) flags, the tip frame, finger tips and gripper length, and the
    cabinet joint positions."""
    flags = [(1, 1, 1), (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1), (1, 1, 1),
             (0, 0, 0), (1, 1, 1)]
    sim = tenv._default_sim(E)
    lower = tenv.scene.obj_tree.dof_lower.numpy()
    oq = lower.copy()
    td = tenv.target_dof
    for e, (_, _, opened) in enumerate(flags):
        oq[e, td[e]] = lower[e, td[e]] + (0.6 if opened else 0.2) * tenv.joint_upper[e]
    sim = sim._replace(obj=sim.obj._replace(qpos=torch.as_tensor(oq)))
    bbox = tenv._part_bbox(sim)
    out, long, short, mid, ol, ll, sl = (x.numpy() for x in tenv._handle_axes(bbox))
    R = np.stack([long, short, -out], axis=-1)           # columns: down, sep, grip
    R[np.linalg.det(R) < 0, :, 0] *= -1.0
    quat = trot.mat_to_quat(torch.as_tensor(R)).numpy()
    tip = np.zeros((E, 13), np.float32)
    ltip, rtip = tip.copy(), tip.copy()
    gl = np.zeros(E, np.float32)
    rs = np.random.RandomState(3)
    for e, (reached, aligned, _) in enumerate(flags):
        tip[e, :3] = mid[e] + (0.0 if reached else 0.2) + rs.uniform(-1e-3, 1e-3, 3)
        tip[e, 3:7] = quat[e] if aligned else [0.0, 0.0, 0.0, 1.0]
        ltip[e, :3] = tip[e, :3] + 0.6 * sl[e] * short[e]
        rtip[e, :3] = tip[e, :3] - 0.6 * sl[e] * short[e]
        gl[e] = 1.2 * sl[e]
    return sim, tip, ltip, rtip, gl


def test_part_aware_reward_and_success_bitmap(envs):
    """``_reward`` of both packages on the same crafted views and cabinet
    joints, from the same per-object success bitmap."""
    jenv, tenv = envs["jenv"], envs["tenv"]
    tsim, tip, ltip, rtip, gl = _crafted(tenv)
    bitmap = np.array([False, True, False])
    acts = np.zeros((E, 10), np.float32)

    tstate = tenv.init_state(tenv.make_generator(0), envs["draws"])
    tstate = tstate._replace(sim=tsim, task_state=torch.as_tensor(bitmap),
                             progress=torch.arange(E, dtype=torch.int32))
    tview, _ = tenv._robot_view(tsim)
    tview = tview._replace(tip_state=torch.as_tensor(tip), ltip_state=torch.as_tensor(ltip),
                           rtip_state=torch.as_tensor(rtip), gripper_length=torch.as_tensor(gl))
    trew, tsucc, tbits, tex = tenv._reward(tstate, tview, tenv._part_bbox(tsim),
                                           torch.as_tensor(acts))

    jstate = jenv.init_state(jax.random.PRNGKey(0))
    jobj = jstate.sim.obj._replace(
        qpos=jnp.asarray(tsim.obj.qpos.numpy()), root_pos=jnp.asarray(tsim.obj.root_pos.numpy()),
        root_quat=jnp.asarray(tsim.obj.root_quat.numpy()))
    jstate = jstate._replace(sim=jstate.sim._replace(obj=jobj),
                             task_state=jnp.asarray(bitmap),
                             progress=jnp.arange(E, dtype=jnp.int32))
    jview, _ = jenv._robot_view(jstate.sim)
    jview = jview._replace(tip_state=jnp.asarray(tip), ltip_state=jnp.asarray(ltip),
                           rtip_state=jnp.asarray(rtip), gripper_length=jnp.asarray(gl))
    jrew, jsucc, jbits, jex = jenv._reward(jstate, jview, jenv._part_bbox(jstate.sim),
                                           jnp.asarray(acts))

    succ = tsucc.numpy()
    assert succ.any() and not succ.all(), succ
    np.testing.assert_array_equal(succ, np.asarray(jsucc))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    assert tbits.numpy().sum() > bitmap.sum()
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-5, rtol=1e-6)
    assert sorted(tex) == sorted(jex)
    for k in tex:
        np.testing.assert_allclose(np.asarray(tex[k], np.float32),
                                   np.asarray(jex[k], np.float32), atol=1e-5, rtol=1e-6,
                                   err_msg=k)
