"""The port's small geometry modules against the JAX package's:
``partmanip_tpu_torch/ops/pointcloud.py`` (the numpy samplers, and
``PCFromParts.query`` with the JAX package's permutation injected) and
``ops/sdf.py`` ``grid_query`` / ``scene_sdf`` / ``scene_tsdf`` (jitted on
the JAX side) on two baked box meshes in one grid stack.

Tolerances: the samplers bit for bit (the same numpy draws); posed points
1e-6 m (a 3-term rotation in another order); the grid lookups 1e-6 m
(trilinear weights, XLA's contractions aside), the truncated SDF 1e-5
(divided by a truncation of 0.08 m)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from partmanip_tpu.ops import pointcloud as jpc
from partmanip_tpu.ops import sdf as jsdf
from partmanip_tpu_torch.ops import pointcloud as tpc
from partmanip_tpu_torch.ops import sdf as tsdf

CUBE_V = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                  np.float32) * 0.1
CUBE_F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1], [2, 3, 7],
                   [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])


def test_samplers_draw_what_the_jax_package_draws():
    for j, t, args in ((jpc.sample_mesh_surface, tpc.sample_mesh_surface,
                        (CUBE_V * [1, 2, 0.5], CUBE_F, 300)),
                       (jpc.sample_box_surface, tpc.sample_box_surface, ([0.1, 0.2, 0.05], 300)),
                       (jpc.sample_sphere_surface, tpc.sample_sphere_surface, (0.07, 300))):
        want = j(*args, rng=np.random.RandomState(4))
        got = t(*args, rng=np.random.RandomState(4))
        assert got.dtype == np.float32 and got.shape == (300, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t(*args), j(*args))        # the default RandomState(0)


def test_posed_subsample_matches_with_the_same_permutation():
    parts = [tpc.sample_box_surface([0.1, 0.2, 0.05], 200, np.random.RandomState(1)),
             tpc.sample_sphere_surface(0.07, 200, np.random.RandomState(2))]
    rs = np.random.RandomState(3)
    E, M = 3, 2
    rot = Rotation.from_quat(rs.randn(E * M, 4)).as_matrix().reshape(E, M, 3, 3).astype(np.float32)
    pos = rs.uniform(-0.5, 0.5, (E, M, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jpc.PCFromParts(parts, 64).query(jnp.asarray(rot), jnp.asarray(pos), key))
    perm = torch.as_tensor(np.asarray(jax.random.permutation(key, M * 200)))
    pc = tpc.PCFromParts(parts, 64)
    got = pc.query(torch.as_tensor(rot), torch.as_tensor(pos), perm=perm)
    assert got.shape == (E, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # drawn from a generator: 64 distinct posed points, the same for a seed
    a = pc.query(torch.as_tensor(rot), torch.as_tensor(pos), torch.Generator().manual_seed(7))
    b = pc.query(torch.as_tensor(rot), torch.as_tensor(pos), torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and len({tuple(p) for p in a[0].tolist()}) == 64


@pytest.fixture(scope="module")
def stacks():
    grids = [jsdf.bake_mesh_sdf(CUBE_V, CUBE_F, voxel_size=0.02, trunc=0.08),
             jsdf.bake_mesh_sdf(CUBE_V * [1.5, 0.5, 1], CUBE_F, voxel_size=0.015, trunc=0.08)]
    return jsdf.stack_grids(grids, pad_value=0.08), tsdf.stack_grids(grids, pad_value=0.08)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["parts", "envs_parts"])
def test_grid_query_matches(stacks, lead):
    jst, tst = stacks
    pts = np.random.RandomState(6).uniform(-0.3, 0.3, lead + (2, 400, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: jsdf.grid_query(jst, p, 1.0))(jnp.asarray(pts)))
    got = tsdf.grid_query(tst, torch.as_tensor(pts), 1.0).numpy()
    assert got.shape == want.shape == lead + (2, 400)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    inside = want != 1.0
    assert 0.2 < inside.mean() < 0.8 and (want[inside] < 0).any()


@pytest.mark.parametrize("shared", [True, False], ids=["shared_points", "points_per_env"])
def test_scene_sdf_and_tsdf_match(stacks, shared):
    jst, tst = stacks
    rs = np.random.RandomState(8)
    E, M, N = 2, 2, 500
    rot = Rotation.from_quat(rs.randn(E * M, 4)).as_matrix().reshape(E, M, 3, 3).astype(np.float32)
    pos = rs.uniform(-0.1, 0.1, (E, M, 3)).astype(np.float32)
    pos[..., 2] += 0.15
    pts = rs.uniform(-0.3, 0.3, (N, 3) if shared else (E, N, 3)).astype(np.float32)
    pts[..., 2] += 0.2
    args_j = tuple(map(jnp.asarray, (rot, pos, pts)))
    args_t = tuple(map(torch.as_tensor, (rot, pos, pts)))
    want = np.asarray(jax.jit(lambda r, p, x: jsdf.scene_sdf(jst, r, p, x))(*args_j))
    got = tsdf.scene_sdf(tst, *args_t).numpy()
    assert got.shape == want.shape == (E, N)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)
    want = np.asarray(jax.jit(lambda r, p, x: jsdf.scene_tsdf(jst, r, p, x, 0.08))(*args_j))
    got = tsdf.scene_tsdf(tst, *args_t, sdf_trunc=0.08).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (np.abs(want) < 1).mean() > 0.1
    no_ground = tsdf.scene_tsdf(tst, *args_t, sdf_trunc=0.08, ground=False).numpy()
    np.testing.assert_allclose(no_ground, np.asarray(jsdf.scene_tsdf(
        jst, *args_j, sdf_trunc=0.08, ground=False)), rtol=0, atol=1e-5)
