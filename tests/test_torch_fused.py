"""The module that holds the kernel: ``partmanip_tpu_torch/sim/fused.py`` and
its plain PyTorch version ``engine._inner_step``.

The CUDA kernel cannot run on a CPU host; it is held against the plain
version on the GPU by ``chip_smoke.py``.  Here the plain version is held
against the JAX reference ``partmanip_tpu.sim.engine._inner_step`` for ONE
inner step on contact-rich grasp_cube states (longer horizons are chaotic
under the effort-clamped drives), and the wrapper's Python side — layouts,
routing, refusals — is checked directly (the packed scene struct and the
build command in ``test_torch_fused_spec.py``).

Tolerances are those of tests/test_fused.py (f32 re-association only)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu.sim import engine as jengine
from partmanip_tpu_torch.sim import engine as tengine
from partmanip_tpu_torch.sim import fused
from partmanip_tpu_torch.utils import contact_states, convert, cuda_lib

import _torch_port as tp

E = 8


@pytest.fixture(scope="module")
def envs():
    jenv, _, jsp, tenv, _ = tp.make_envs(
        ["--taskcfg", "grasp_cube", "--algo.num_envs", str(E)])
    ref_scene = jenv.scene._replace(params=jsp._replace(use_fused=False))
    gravity = jnp.array([0.0, 0.0, jsp.gravity])
    # jitted: the same function as the eager reference of tests/test_fused.py
    jstep = jax.jit(lambda s, t: jengine._inner_step(
        ref_scene, s, t, jsp.h, gravity, coriolis=False))
    return jenv, jsp, tenv, jstep


def _torch_step(tenv, sim_np, targets):
    sp = tenv.scene.params
    return tengine._inner_step(
        tenv.scene, convert.scene_state_from_numpy(sim_np),
        torch.as_tensor(targets), sp.h, torch.tensor([0.0, 0.0, sp.gravity]),
        coriolis=False)


def test_inner_step_after_warmup(envs):
    """Protocol of tests/test_fused.py: env init state, targets ±0.05 rad
    around the default pose, 8 reference inner steps, then one step through
    both packages."""
    jenv, jsp, tenv, jstep = envs
    sim = jenv.init_state(jax.random.PRNGKey(0)).sim
    rng = np.random.RandomState(1)
    targets = (np.tile(jenv.default_dof, (E, 1))
               + rng.uniform(-0.05, 0.05, (E, 9))).astype(np.float32)
    for _ in range(8):
        sim = jstep(sim, jnp.asarray(targets))
    want = jstep(sim, jnp.asarray(targets))
    got = _torch_step(tenv, tp.jax_scene_to_numpy(sim), targets)
    assert float(np.abs(np.asarray(want.robot.qvel)).max()) > 1e-3
    tp.assert_scene_close(got, want, "warmed state:")


def test_inner_step_in_contact(envs):
    """Hand-made states (cube pinched between the pads / pads pressed into
    the ground beside the resting cube), two reference steps in so anchors
    exist: ground, cube and anchor branches must all be live."""
    jenv, jsp, tenv, jstep = envs
    sim_np, targets = contact_states.grasp_contact_states(tenv, E, seed=0)
    sim = tp.numpy_scene_to_jax(sim_np)
    for _ in range(2):
        sim = jstep(sim, jnp.asarray(targets))
    sim_np = tp.jax_scene_to_numpy(sim)
    live = contact_states.touching_counts(
        tenv, convert.scene_state_from_numpy(sim_np))
    assert min(live.values()) > 0, f"a contact branch is dead: {live}"
    want = jstep(sim, jnp.asarray(targets))
    got = _torch_step(tenv, sim_np, targets)
    assert int((np.asarray(want.anchors.body) == 1).sum()) > 0
    assert int((np.asarray(want.anchors.body) == 0).sum()) > 0
    tp.assert_scene_close(got, want, "contact state:")


def test_layout_roundtrip_is_exact(envs):
    """[E, feature] -> env-minor [feature, E] -> back, bit for bit."""
    tenv = envs[2]
    sim_np, targets = contact_states.grasp_contact_states(tenv, E, seed=3)
    sim_np["anchors"]["body"] = np.random.RandomState(0).randint(
        -1, 2, sim_np["anchors"]["body"].shape).astype(np.int32)
    sim_np["anchors"]["point"] = np.random.RandomState(1).normal(
        size=sim_np["anchors"]["point"].shape).astype(np.float32)
    sim = convert.scene_state_from_numpy(sim_np)
    buf, anc_b = fused.pack_state(sim, torch.as_tensor(targets))
    D, S = 9, tenv.spheres.link_idx.shape[0]
    assert buf.shape == (fused.state_rows(D, S), E) and buf.is_contiguous()
    assert anc_b.shape == (S, E) and anc_b.dtype == torch.int32
    np.testing.assert_array_equal(buf[-D:].numpy(), targets.T)
    back = fused.unpack_state(buf, anc_b, sim)
    for part in ("robot", "body", "anchors"):
        for a, b in zip(getattr(back, part), getattr(sim, part)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


def test_cpu_state_never_touches_the_build(envs, monkeypatch):
    """physics_step on CPU tensors takes the plain version and neither
    builds, loads nor launches anything."""
    tenv = envs[2]

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
    assert torch.equal(out.robot.qpos, via_wrapper.robot.qpos)
    assert bool(torch.isfinite(out.body.pos).all())
    assert sum(fused.launch_counts.values()) == 0


def test_launch_refuses_cpu_tensors(envs):
    tenv = envs[2]
    sim = tenv._default_sim(E)
    buf, anc_b = fused.pack_state(
        sim, torch.as_tensor(np.tile(tenv.default_dof, (E, 1))))
    with pytest.raises(ValueError, match="CUDA"):
        fused.launch_packed(tenv.scene, buf, anc_b, 1)


def _unsupported_scenes(scene):
    return {
        "coriolis": scene._replace(params=scene.params._replace(coriolis=True)),
        "obj_tree": scene._replace(obj_tree=scene.robot),
        "obj_grids": scene._replace(obj_grids=object()),
    }


@pytest.mark.parametrize("what", ["coriolis", "obj_tree", "obj_grids"])
def test_unsupported_scene_raises_with_reason(envs, what):
    """The JAX package's ``fused_supported`` silently switched paths; the
    port refuses, naming the part that is not ported.  ``coriolis`` was
    such a part and is ported: on the CPU the plain version takes it (equal
    to the wrapper's CPU route), and on the card the B1a build with
    ``FIS_BIAS=1``."""
    tenv = envs[2]
    scene = _unsupported_scenes(tenv.scene)[what]
    sim = tenv._default_sim(E)
    targets = torch.as_tensor(np.tile(tenv.default_dof, (E, 1)))
    if what == "coriolis":
        fused.check_scene(scene)
        assert fused.needs_bias(scene) and not fused.needs_bias(tenv.scene)
        assert ("FIS_BIAS", 1) in fused.scene_library(scene).defines
        out = tengine.physics_step(scene, sim, targets)
        assert torch.equal(out.robot.qvel,
                           fused.fused_physics_step(scene, sim, targets).robot.qvel)
        assert bool(torch.isfinite(out.robot.qvel).all())
        return
    with pytest.raises(NotImplementedError, match=what):
        tengine.physics_step(scene, sim, targets)
    with pytest.raises(NotImplementedError, match=what):
        fused.check_scene(scene)


def test_no_free_body_raises(envs):
    """Without its free body the scene used to be refused; it is the robot
    and the ground alone now, which kernel B1d runs (B1a's source with
    ``FIS_BODY=0``).  A free body beside an articulated object, once
    refused too, is kernel B1e's scene (B1b's source with ``FIS_BODY=1``;
    ``tests/test_torch_fused_b1e_spec.py``)."""
    tenv = envs[2]
    robot_only = tenv.scene._replace(free_body=None)
    fused.check_scene(robot_only)
    assert fused.variant(robot_only) == "b1d"
    assert ("FIS_BODY", 0) in fused.scene_library(robot_only).defines
    assert fused.variant(tenv.scene._replace(obj_tree=tenv.scene.robot,
                                             obj_boxes=object())) == "b1e"


def test_n_steps_plumbing_on_the_plain_path(envs):
    """``physics_step`` = substeps × inner_substeps inner steps; asking the
    wrapper for n steps at once equals n calls of one step."""
    tenv = envs[2]
    sim_np, targets = contact_states.grasp_contact_states(tenv, E, seed=4)
    sim = convert.scene_state_from_numpy(sim_np)
    targets = torch.as_tensor(targets)
    p = tenv.scene.params
    n = p.substeps * p.inner_substeps
    assert n == 8
    full = tengine.physics_step(tenv.scene, sim, targets)
    chain = sim
    for _ in range(n):
        chain = fused.fused_inner_steps(tenv.scene, chain, targets, 1)
    for part in ("robot", "body", "anchors"):
        for a, b in zip(getattr(full, part), getattr(chain, part)):
            assert torch.equal(a, b)
    three = tengine.plain_physics_step(tenv.scene, sim, targets, n_steps=3)
    assert not torch.equal(three.robot.qpos, full.robot.qpos)
