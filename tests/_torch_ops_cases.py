"""Inputs of the rotation / linalg parity tests (``test_torch_ops.py``,
``test_torch_rotations_{a,b,c}.py``):
for each function of ``ops/rotations.py`` a maker of its argument tuple
(numpy, from a RandomState), and the comparison both files use.

atol 1e-6: same formulas in the same operation order, so only f32 rounding
of the two backends' elementary functions differs."""

import numpy as np
import jax.numpy as jnp
import torch

from partmanip_tpu.ops import rotations as jrot
from partmanip_tpu_torch.ops import rotations as trot

B = 64


def quat(rs, n=B):
    q = rs.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def vec(rs, n=B, scale=1.0):
    return (rs.normal(size=(n, 3)) * scale).astype(np.float32)


def unit(rs, n=B):
    v = vec(rs, n)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def angle(rs, n=B):
    return rs.uniform(-3.0, 3.0, n).astype(np.float32)


def rotmat(rs, n=B):
    return np.array(jrot.quat_to_mat(jnp.asarray(quat(rs, n))))


def spd(rs, n=B, d=9):
    a = rs.normal(size=(n, d, d)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + d * np.eye(d, dtype=np.float32)


# name -> maker of the argument tuple (numpy) from a RandomState
ROT_CASES = {
    "normalize": lambda rs: (vec(rs),),
    "quat_unit": lambda rs: (quat(rs) * 1.7,),
    "quat_mul": lambda rs: (quat(rs), quat(rs)),
    "quat_conjugate": lambda rs: (quat(rs),),
    "quat_rotate": lambda rs: (quat(rs), vec(rs)),
    "quat_rotate_inverse": lambda rs: (quat(rs), vec(rs)),
    "quat_from_angle_axis": lambda rs: (angle(rs), unit(rs)),
    "quat_from_euler_xyz": lambda rs: (angle(rs), angle(rs), angle(rs)),
    "quat_to_mat": lambda rs: (quat(rs) * 1.3,),
    "mat_to_quat": lambda rs: (rotmat(rs),),
    "orientation_error": lambda rs: (quat(rs), quat(rs)),
    "quat_diff_rad": lambda rs: (quat(rs), quat(rs)),
    "mat_diff_rad": lambda rs: (rotmat(rs), rotmat(rs)),
    "scale_transform": lambda rs: (vec(rs), vec(rs) - 5.0, vec(rs) + 5.0),
    "unscale_transform": lambda rs: (vec(rs), vec(rs) - 5.0, vec(rs) + 5.0),
    "deambiguity_rotation": lambda rs: (quat(rs),),
    "transform_apply": lambda rs: (vec(rs), quat(rs), vec(rs)),
    "transform_compose": lambda rs: (vec(rs), quat(rs), vec(rs), quat(rs)),
    "transform_inverse": lambda rs: (vec(rs), quat(rs)),
    "quat_to_angle_axis": lambda rs: (quat(rs),),
    "normalize_angle": lambda rs: (angle(rs) * 4.0,),
    "quat_to_exp_map": lambda rs: (quat(rs),),
    "exp_map_to_angle_axis": lambda rs: (vec(rs),),
    "exp_map_to_quat": lambda rs: (vec(rs),),
    "quat_to_tan_norm": lambda rs: (quat(rs),),
    "slerp": lambda rs: (quat(rs), quat(rs),
                         rs.uniform(0, 1, (B, 1)).astype(np.float32)),
    "calc_heading": lambda rs: (quat(rs),),
    "calc_heading_quat": lambda rs: (quat(rs),),
    "calc_heading_quat_inv": lambda rs: (quat(rs),),
    "local_to_world_space": lambda rs: (
        vec(rs), np.concatenate([vec(rs), quat(rs)], -1)),
}

def compare(jfn, tfn, args, atol=1e-6):
    want = jfn(*[jnp.asarray(a) for a in args])
    got = tfn(*[torch.as_tensor(a) for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)




def check_rotation(name):
    """One function of ``ops/rotations.py`` through both packages."""
    args = ROT_CASES[name](np.random.RandomState(len(name) * 7 + 1))
    compare(getattr(jrot, name), getattr(trot, name), args)


def rotation_names(part, parts=3):
    """The ``part``-th of ``parts`` slices of the function names: the cases
    are spread over several small test files."""
    return sorted(ROT_CASES)[part::parts]
