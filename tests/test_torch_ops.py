"""Parity of the port's small-matrix linear algebra (``ops/linalg.py``) and
the remaining rotation helpers with the JAX package on the same random inputs
(numpy, seeded).  The functions of ``ops/rotations.py`` themselves are in
``test_torch_rotations_{a,b,c}.py``.

atol 1e-6: same formulas in the same operation order, so only f32 rounding
of the two backends' elementary functions differs."""

import numpy as np
import jax.numpy as jnp
import pytest

from partmanip_tpu.ops import linalg as jlin
from partmanip_tpu.ops import rotations as jrot
from partmanip_tpu_torch.ops import linalg as tlin
from partmanip_tpu_torch.ops import rotations as trot

from _torch_ops_cases import B, angle, compare, quat, spd, unit

LIN_CASES = {
    "cholesky_factor": lambda rs: (spd(rs),),
    "spd_solve": lambda rs: (spd(rs), rs.normal(size=(B, 9)).astype(np.float32)),
    "spd_solve_6": lambda rs: (spd(rs, d=6),
                               rs.normal(size=(B, 6)).astype(np.float32)),
    "inv3": lambda rs: (spd(rs, d=3),),
}


def test_every_rotation_function_has_a_case():
    """The three rotation files together cover the module's public surface."""
    import inspect
    from _torch_ops_cases import ROT_CASES, rotation_names
    public = {n for n, f in inspect.getmembers(trot, inspect.isfunction)
              if not n.startswith("_") and f.__module__ == trot.__name__}
    # these three are checked below, the rest through ROT_CASES
    assert public - set(ROT_CASES) == {"quat_axis", "quat_identity",
                                       "angle_axis_to_exp_map"}
    spread = [n for part in range(3) for n in rotation_names(part)]
    assert sorted(spread) == sorted(ROT_CASES)
    assert all(len(rotation_names(part)) <= 10 for part in range(3))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_quat_axis_matches_jax(axis):
    q = quat(np.random.RandomState(axis))
    compare(lambda x: jrot.quat_axis(x, axis),
            lambda x: trot.quat_axis(x, axis), (q,))


def test_quat_identity_and_exp_map_helper():
    assert trot.quat_identity((3,)).tolist() == np.asarray(
        jrot.quat_identity((3,))).tolist()
    rs = np.random.RandomState(5)
    compare(jrot.angle_axis_to_exp_map, trot.angle_axis_to_exp_map,
            (angle(rs), unit(rs)))


@pytest.mark.parametrize("name", sorted(LIN_CASES))
def test_linalg_matches_jax(name):
    args = LIN_CASES[name](np.random.RandomState(len(name)))
    fn = name.split("_6")[0]
    # the solves divide by pivots of O(1..10): 1e-6 absolute on O(0.1) results
    compare(getattr(jlin, fn), getattr(tlin, fn), args)


def test_cholesky_solve_matches_jax():
    rs = np.random.RandomState(3)
    L = np.array(jlin.cholesky_factor(jnp.asarray(spd(rs))))
    b = rs.normal(size=(B, 9)).astype(np.float32)
    compare(jlin.cholesky_solve, tlin.cholesky_solve, (L, b))
