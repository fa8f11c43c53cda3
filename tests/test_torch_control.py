"""Parity of the port's Franka controller (``envs/control.py``) with the JAX
package: the cached robot view and all four drive modes, fixed and mobile
base, on the same random actions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import _torch_port as tp

E = 4
T = torch.as_tensor


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.fixture(scope="module", params=[False, True], ids=["fixed", "mobile"])
def robot(request):
    return tp.make_robot(request.param, E)


@pytest.mark.parametrize("drive_mode", ["ik", "pos", "ik_abs", "heuristic"])
def test_robot_view_and_compute_targets(robot, drive_mode):
    """The cached robot view and all four drive modes, fixed and mobile
    base, on the same random actions (IK solve: atol 1e-5)."""
    from partmanip_tpu.envs import control as jcontrol
    from partmanip_tpu_torch.envs import control as tcontrol
    mobile = robot["D"] == 12
    li = robot["jb"].link_index
    kw = dict(drive_mode=drive_mode, mobile=mobile, dt=1 / 60,
              num_dofs=robot["D"], lefttip_idx=li["panda_lefttip"],
              righttip_idx=li["panda_righttip"],
              root_quat=(0.0, 0.0, 0.707, 0.707))
    jcfg, tcfg = jcontrol.FrankaControlConfig(**kw), tcontrol.FrankaControlConfig(**kw)
    assert jcfg.num_actions == tcfg.num_actions
    jview = jcontrol.robot_view(jcfg, robot["jspec"], robot["jfk"], robot["jstate"])
    tview = tcontrol.robot_view(tcfg, robot["tspec"], robot["tfk"], robot["tstate"])
    for name in jview._fields:
        _close(getattr(tview, name), getattr(jview, name))
    acts = np.random.RandomState(13).uniform(
        -1, 1, (E, jcfg.num_actions)).astype(np.float32)
    want = jcontrol.compute_targets(jcfg, robot["jspec"], jview, jnp.asarray(acts))
    got = tcontrol.compute_targets(tcfg, robot["tspec"], tview, T(acts))
    _close(got, want)
    assert float((got - robot["tstate"].qpos).abs().max()) > 1e-4
