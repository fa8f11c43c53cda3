"""Parity of the port's ``step_tree`` and contact functions with the JAX
package: two-pass implicit PD with effort clamp, ``penalty_forces``,
``anchor_friction``, ``box_sdf``, free-body integration.

Inputs are numpy from a seed, handed to both sides; tolerances stated per
test (f32 rounding and the order of sums differ)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu.sim import contact as jcontact
from partmanip_tpu.sim import dynamics as jdyn
from partmanip_tpu.sim import types as jtypes
from partmanip_tpu_torch.sim import contact as tcontact
from partmanip_tpu_torch.sim import dynamics as tdyn
from partmanip_tpu_torch.sim import types as ttypes

import _torch_port as tp

E = 4
T = torch.as_tensor


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.fixture(scope="module", params=[False, True], ids=["fixed", "mobile"])
def robot(request):
    return tp.make_robot(request.param, E)


def test_step_tree(robot):
    """Two-pass implicit PD with effort clamp, with contact blocks: targets
    both near (unsaturated) and far (saturated servo) from the state.
    qvel atol 1e-3: the saturated servo's slope effort/|Δv| amplifies f32
    rounding of the solve (the tolerance of tests/test_fused.py)."""
    rs, D = np.random.RandomState(9), robot["D"]
    q = np.asarray(robot["jstate"].qpos)
    targets = (q + rs.uniform(-1, 1, (E, D))
               * np.array([[1e-4], [1e-2], [0.05], [0.3]])).astype(np.float32)
    tau = rs.uniform(-2, 2, (E, D)).astype(np.float32)
    Jp = rs.uniform(-0.3, 0.3, (E, 5, 3, D)).astype(np.float32)
    n = rs.normal(size=(E, 5, 3)).astype(np.float32)
    N = (0.05 * n[..., :, None] * n[..., None, :]).astype(np.float32)
    h = 1.0 / 480.0
    g = np.array([0, 0, -9.81], np.float32)
    jM = jdyn.mass_matrix(robot["jspec"], robot["jfk"], E)
    # jitted on the JAX side: one compile instead of one per unrolled op
    want = jax.jit(lambda st, fk, M, tg, tx, jp, nn: jdyn.step_tree(
        robot["jspec"], st, fk, M, tg, tx, h, jnp.asarray(g),
        implicit=jdyn.ImplicitBlocks(jp, nn), coriolis=False))(
            robot["jstate"], robot["jfk"], jM, jnp.asarray(targets),
            jnp.asarray(tau), jnp.asarray(Jp), jnp.asarray(N))
    got = tdyn.step_tree(robot["tspec"], robot["tstate"], robot["tfk"],
                         T(np.array(jM)), T(targets), T(tau), h, T(g),
                         implicit=tdyn.ImplicitBlocks(T(Jp), T(N)),
                         coriolis=False)
    _close(got.qpos, want.qpos)
    _close(got.qvel, want.qvel, 1e-3)


def test_coriolis_raises(robot):
    """``coriolis=True`` used to raise; the velocity-product term is now
    ported: the bias with it, under a gravity_scale of 1, equals the JAX
    package's (jitted) on the same random state, atol 1e-4 on biases of
    up to ~20 N·m."""
    g = np.array([0.0, 0.0, -9.81], np.float32)
    jspec = robot["jspec"]._replace(gravity_scale=jnp.ones_like(robot["jspec"].gravity_scale))
    tspec = robot["tspec"]._replace(gravity_scale=torch.ones_like(robot["tspec"].gravity_scale))
    want = jax.jit(lambda st: jdyn.bias_forces(jspec, st, jnp.asarray(g), coriolis=True))(
        robot["jstate"])
    got = tdyn.bias_forces(tspec, robot["tstate"], T(g), coriolis=True)
    assert float(np.abs(np.asarray(want)).max()) > 1.0
    _close(got, want, 1e-4)


def test_box_sdf():
    rs = np.random.RandomState(2)
    p = rs.uniform(-0.06, 0.06, (E, 40, 3)).astype(np.float32)
    half = np.full((E, 40, 3), 0.025, np.float32)
    wd, wn = jcontact.box_sdf(jnp.asarray(p), jnp.asarray(half))
    gd, gn = tcontact.box_sdf(T(p), T(half))
    _close(gd, wd, 1e-6)
    _close(gn, wn, 1e-6)


def _contact_set(rs, C, lib, conv):
    n = rs.normal(size=(E, C, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    f = dict(
        point=rs.uniform(-0.1, 0.1, (E, C, 3)).astype(np.float32), normal=n,
        depth=rs.uniform(-0.004, 0.002, (E, C)).astype(np.float32),
        active=(rs.uniform(size=(E, C)) > 0.2).astype(np.float32),
        sphere_idx=np.tile(np.arange(C), (E, 1)),
        friction=rs.uniform(0.3, 1.0, (E, C)).astype(np.float32),
        v_other=rs.uniform(-0.2, 0.2, (E, C, 3)).astype(np.float32))
    return lib.ContactSet(**{k: conv(v) for k, v in f.items()})


@pytest.mark.parametrize("m_eff,recede", [(0.5, 0.0), (0.125, 1.0)])
def test_penalty_forces(m_eff, recede):
    C = 12
    sp = dict(substeps=4, inner_substeps=2, coriolis=False)
    v = np.random.RandomState(4).uniform(-0.5, 0.5, (E, C, 3)).astype(np.float32)
    want = jcontact.penalty_forces(
        _contact_set(np.random.RandomState(3), C, jcontact, jnp.asarray),
        jnp.asarray(v), jtypes.SimParams(**sp), m_eff, recede_damp=recede)
    got = tcontact.penalty_forces(
        _contact_set(np.random.RandomState(3), C, tcontact, T), T(v),
        ttypes.SimParams(**sp), m_eff, recede_damp=recede)
    assert float(got[2].sum()) > 0, "no touching contact in the test data"
    # forces reach O(100 N): 1e-5 relative to that scale
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-5)


def test_anchor_friction():
    S = 10
    rs = np.random.RandomState(8)
    f = lambda *shape: rs.uniform(-1, 1, shape).astype(np.float32)
    n = f(E, S, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pos, vel, pvel = 0.1 * f(E, S, 3), 0.3 * f(E, S, 3), 0.1 * f(E, S, 3)
    fn = np.abs(f(E, S)) * 20
    mu = np.abs(f(E, S))
    touching = (f(E, S) > -0.5).astype(np.float32)
    pid = rs.randint(-1, 2, (E, S)).astype(np.int32)
    anc_body = np.where(f(E, S) > 0, pid, rs.randint(-1, 2, (E, S))).astype(np.int32)
    anc_point = pos + 0.002 * f(E, S, 3)
    shift = np.array([0.01, -0.02, 0.03], np.float32)

    def frames(where, conv):
        sh = conv(shift)
        to_local = lambda w, p: where((p == 1)[..., None], w - sh, w)
        to_world = lambda l, p: where((p == 1)[..., None], l + sh, l)
        return to_local, to_world

    sp = dict(substeps=4, inner_substeps=2, coriolis=False)
    J = jnp.asarray
    wl, ww = frames(jnp.where, jnp.asarray)
    want = jcontact.anchor_friction(
        J(pos), J(vel), J(n), J(fn), J(mu), J(touching), J(pid),
        jcontact.AnchorState(J(anc_point), J(anc_body)), wl, ww, J(pvel),
        jtypes.SimParams(**sp), 0.1)
    tl, tw = frames(torch.where, T)
    got = tcontact.anchor_friction(
        T(pos), T(vel), T(n), T(fn), T(mu), T(touching), T(pid),
        tcontact.AnchorState(T(anc_point), T(anc_body)), tl, tw, T(pvel),
        ttypes.SimParams(**sp), 0.1)
    _close(got[0], want[0])
    _close(got[1].point, want[1].point, 1e-6)
    np.testing.assert_array_equal(got[1].body.numpy(), np.asarray(want[1].body))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert bool(got[2].any()) and not bool(got[2].all()), \
        "test data must hold both sticking and sliding contacts"


def test_integrate_free_body():
    rs = np.random.RandomState(6)
    f = lambda *shape: rs.uniform(-1, 1, shape).astype(np.float32)
    q = f(E, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    st = dict(pos=f(E, 3), quat=q, linvel=f(E, 3), angvel=3 * f(E, 3))
    m = 0.125
    spec = dict(mass=np.full(1, m, np.float32),
                inertia=(np.eye(3, dtype=np.float32) * m * 0.05 ** 2 / 6)[None],
                half_extents=np.full((1, 3), 0.025, np.float32),
                gravity_scale=np.ones(1, np.float32),
                friction=np.ones(1, np.float32))
    force, torque = 2 * f(E, 3), 1e-3 * f(E, 3)
    g = np.array([0, 0, -9.81], np.float32)
    want = jcontact.integrate_free_body(
        jtypes.FreeBodySpec(**spec),
        jtypes.FreeBodyState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jnp.asarray(force), jnp.asarray(torque), 1 / 480, jnp.asarray(g))
    got = tcontact.integrate_free_body(
        ttypes.to_device(ttypes.FreeBodySpec(**spec), "cpu"),
        ttypes.FreeBodyState(**{k: T(v) for k, v in st.items()}),
        T(force), T(torque), 1 / 480, T(g))
    for name in ("pos", "quat", "linvel"):
        _close(getattr(got, name), getattr(want, name), 1e-6)
    # angular acceleration divides by an inertia of 5e-5
    _close(got.angvel, want.angvel, 1e-4)
