"""Parity of the port's kinematics and mass matrix with the JAX package on
random states near the default pose, fixed and mobile base: FK, point / link /
frame Jacobians, mass matrix.  (``step_tree`` and the contact functions are
in ``test_torch_contact.py``, the controller in ``test_torch_control.py``.)

Inputs are numpy from a seed, handed to both sides.  atol 1e-5 unless said:
same formulas, f32 rounding and the order of the einsum sums differ."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu.sim import dynamics as jdyn
from partmanip_tpu.sim import kinematics as jkin
from partmanip_tpu_torch.sim import dynamics as tdyn
from partmanip_tpu_torch.sim import kinematics as tkin

import _torch_port as tp

E = 4
T = torch.as_tensor


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.fixture(scope="module", params=[False, True], ids=["fixed", "mobile"])
def robot(request):
    return tp.make_robot(request.param, E)


def test_forward_kinematics(robot):
    for name in ("link_pos", "link_quat", "dof_axis_w", "dof_anchor_w"):
        _close(getattr(robot["tfk"], name), getattr(robot["jfk"], name), 1e-6)


def test_point_jacobian(robot):
    rs = np.random.RandomState(5)
    L = robot["jspec"].parent.shape[-1]
    link = rs.randint(0, L, (E, 6))
    pts = rs.uniform(-0.5, 0.5, (E, 6, 3)).astype(np.float32)
    want = jkin.point_jacobian(robot["jspec"], robot["jfk"], jnp.asarray(link),
                               jnp.asarray(pts))
    got = tkin.point_jacobian(robot["tspec"], robot["tfk"], T(link), T(pts))
    _close(got, want)


def test_link_jacobians(robot):
    want = jkin.link_jacobians(robot["jspec"], robot["jfk"])
    got = tkin.link_jacobians(robot["tspec"], robot["tfk"])
    for g, w in zip(got, want):
        _close(g, w)


def test_frame_jacobian(robot):
    L = robot["jspec"].parent.shape[-1]
    link = np.tile(np.array([L - 3, L - 1]), (E, 1))
    want = jkin.frame_jacobian(robot["jspec"], robot["jfk"], jnp.asarray(link))
    got = tkin.frame_jacobian(robot["tspec"], robot["tfk"], T(link))
    _close(got, want)


def test_mass_matrix(robot):
    want = jdyn.mass_matrix(robot["jspec"], robot["jfk"], E)
    got = tdyn.mass_matrix(robot["tspec"], robot["tfk"], E)
    _close(got, want)
