"""The port's mesh-SDF operations (``partmanip_tpu_torch/ops/sdf.py``)
against the JAX package's (``partmanip_tpu/ops/sdf.py``):

* ``bake_mesh_sdf`` of handle bars' .obj files (the mesh-handle cabinets'
  geometry, at the voxel size and truncation ``assets.mesh_sdf_cached``
  picks): same grid shape, origin and voxel, values within 2e-6 — the
  largest differences are at grid points on the mesh's faces, where the
  distance is all rounding; the sign agrees wherever |sdf| > 1e-5.  Both
  bars have grid points where separately rounded dot products cancel to an
  exact 0 (ROADMAP Queue C), so they hold the port to XLA's fused
  multiply-add chains;
* ``stack_grids``: equal padding;
* ``grid_query_grad`` on one stack: points inside cells, exactly on cell
  faces, edges and corners, on the valid edge (index exactly 1 and exactly
  X − 2), just outside it and far outside — values within 1e-6, gradients
  within 1e-5 relative (the same cell is chosen: on a face both take the
  upper cell), and exactly ``outside_value`` and a zero gradient outside;
* the port's bake of a box reproduces the analytic box SDF, as the JAX
  package's own test holds its bake to."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv

from partmanip_tpu.ops import sdf as jsdf
from partmanip_tpu_torch.envs import assets as tassets
from partmanip_tpu_torch.ops import sdf as tsdf


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: the bakes and the plain steps are many small ops,
    which spin-wait under the test run's several workers when each op is
    split over every core (tests/_torch_vision.py)."""
    with tv.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def handle(tmp_path_factory):
    """A handle bar's mesh (generator geometry: 2.8 cm deep, 40 cm long,
    3.2 cm thick) scaled by obj_scale 0.5, and its voxel size."""
    path = str(tmp_path_factory.mktemp("mesh") / "handle_0.obj")
    tassets._write_box_obj(path, (0.028, 0.4, 0.032))
    v, f = tassets.load_obj_mesh(path)
    v = v * 0.5
    vs = float(np.clip((v.max(0) - v.min(0)).max() / 48.0, 0.003, 0.02))
    return v, f, vs


@pytest.mark.parametrize("size", [(0.028, 0.4, 0.032), (0.028, 0.5, 0.02)])
def test_bake_matches_jax(tmp_path, size):
    path = str(tmp_path / "handle.obj")
    tassets._write_box_obj(path, size)
    v, f = tassets.load_obj_mesh(path)
    v = v * 0.5
    vs = float(np.clip((v.max(0) - v.min(0)).max() / 48.0, 0.003, 0.02))
    want = jsdf.bake_mesh_sdf(v, f, voxel_size=vs, trunc=6.0 * vs)
    got = tsdf.bake_mesh_sdf(v, f, voxel_size=vs, trunc=6.0 * vs)
    assert got["sdf"].shape == want["sdf"].shape and got["sdf"].dtype == np.float32
    np.testing.assert_array_equal(got["bbox_min"], want["bbox_min"])
    assert got["voxel_size"] == want["voxel_size"]
    np.testing.assert_allclose(got["sdf"], want["sdf"], atol=2e-6, rtol=0)
    clear = np.abs(want["sdf"]) > 1e-5
    assert np.array_equal(np.sign(got["sdf"])[clear], np.sign(want["sdf"])[clear])
    assert (got["sdf"] < 0).any() and got["sdf"].max() == pytest.approx(6.0 * vs)


def test_stack_grids_matches_jax(handle):
    v, f, vs = handle
    small = tsdf.bake_mesh_sdf(v * 0.7, f, voxel_size=vs, trunc=6.0 * vs)
    big = tsdf.bake_mesh_sdf(v, f, voxel_size=vs, trunc=6.0 * vs)
    want = jsdf.stack_grids([small, big], pad_value=6.0 * vs)
    got = tsdf.stack_grids([small, big], pad_value=6.0 * vs)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _exact_stack():
    """Two grids with power-of-two voxels and origins, so that points on
    cell faces have exactly integer indices in both packages."""
    rs = np.random.RandomState(0)
    sdf = rs.uniform(-0.03, 0.03, (2, 7, 8, 9)).astype(np.float32)
    bbox = np.array([[-0.0625, -0.125, 0.0], [0.25, -0.5, -0.25]], np.float32)
    vox = np.array([2.0 ** -6, 2.0 ** -5], np.float32)
    grids = [{"sdf": sdf[i], "bbox_min": bbox[i], "voxel_size": float(vox[i])}
             for i in range(2)]
    return grids, bbox, vox


def _query_points():
    """Query positions in index units, per case (the test turns them into
    points of alternating grids)."""
    rs = np.random.RandomState(1)
    hi = np.array([7 - 2, 8 - 2, 9 - 2], np.float32)
    cases = {
        "inside": 1.0 + rs.uniform(0, 1, (40, 3)) * (hi - 1),
        "faces": np.floor(rs.uniform(1, hi, (40, 3))) + np.where(
            rs.rand(40, 3) < 0.5, 0.0, rs.uniform(0, 1, (40, 3))),
        "corners": np.floor(rs.uniform(1, hi + 1, (20, 3))),
        "valid_edge": np.stack([np.ones(3), hi, [1.0, hi[1], 1.0], [hi[0], 1.0, hi[2]]]),
        "just_outside": np.stack([[1.0 - 2 ** -10, 2.0, 2.0], [2.0, hi[1] + 2 ** -8, 2.0],
                                  [2.0, 2.0, -0.5], [hi[0] + 1.0, 2.0, 2.0]]),
        "far": rs.uniform(-50, 50, (20, 3)),
    }
    return {k: np.asarray(v, np.float32) for k, v in cases.items()}


@pytest.mark.parametrize("case", ["inside", "faces", "corners", "valid_edge",
                                  "just_outside", "far"])
def test_grid_query_grad_matches_jax(case):
    grids, bbox, vox = _exact_stack()
    jst = jsdf.stack_grids(grids, pad_value=0.03)
    tst = tsdf.stack_grids(grids, pad_value=0.03)
    idx = _query_points()[case]
    n = idx.shape[0]
    gid = (np.arange(n) % 2).astype(np.int32)
    pts = (bbox[gid] + idx * vox[gid, None]).astype(np.float32)
    if case in ("faces", "corners", "valid_edge"):
        # the points sit exactly on the faces: their indices are integers
        np.testing.assert_array_equal((pts - bbox[gid]) / vox[gid, None] % 1 == 0,
                                      idx % 1 == 0)
    jv, jg = jsdf.grid_query_grad(jst, jnp.asarray(gid), jnp.asarray(pts), 1.0)
    tv, tg = tsdf.grid_query_grad(tst, torch.as_tensor(gid), torch.as_tensor(pts), 1.0)
    jv, jg = np.asarray(jv), np.asarray(jg)
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-5, rtol=1e-5)
    inside = case in ("inside", "faces", "corners", "valid_edge")
    assert bool((tv.numpy() != 1.0).all()) == inside
    if not inside:
        assert (tv.numpy() == 1.0).all() and (tg.numpy() == 0.0).all()


def test_port_bake_of_a_box_matches_the_analytic_sdf(tmp_path):
    """As the JAX package's tests/test_mesh_collision.py holds its bake:
    within two voxels of the analytic box SDF across edges and corners, a
    unit outward gradient just outside, an outward one inside."""
    size = (0.2, 0.1, 0.06)
    path = str(tmp_path / "box.obj")
    tassets._write_box_obj(path, size)
    verts, faces = tassets.load_obj_mesh(path)
    grid = tsdf.bake_mesh_sdf(verts, faces, voxel_size=0.005, trunc=0.03)
    stack = tsdf.stack_grids([grid], pad_value=0.03)
    pts = np.random.RandomState(0).uniform(-0.14, 0.14, (64, 3)).astype(np.float32)
    val, grad = tsdf.grid_query_grad(stack, torch.zeros(64, dtype=torch.int64),
                                     torch.as_tensor(pts), outside_value=0.03)
    val, grad = val.numpy(), grad.numpy()
    q = np.abs(pts) - np.asarray(size) / 2
    ref = np.clip(np.linalg.norm(np.maximum(q, 0), axis=-1) + np.minimum(q.max(-1), 0),
                  -0.03, 0.03)
    assert np.abs(val - ref)[val < 0.029].max() < 0.011
    near_out = (ref > 0.004) & (ref < 0.02)
    assert (np.abs(np.linalg.norm(grad[near_out], axis=-1) - 1.0) < 0.15).all()
    pen = ref < -0.004
    assert ((grad[pen] * np.sign(pts[pen])).max(-1) > 0).all()
