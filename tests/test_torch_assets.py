"""The port's asset pipeline (``partmanip_tpu_torch/envs/assets.py``)
against the JAX package's (``partmanip_tpu/envs/assets.py``): each package
generates the same procedural cabinets into its own root, byte for byte,
under the same version stamp and marker (so the two never wipe each other's
shared cache), and parses / loads them into equal arrays.  A mesh-handle
cabinet's mesh geoms are baked by each package into equal grids (2e-6:
rounding at grid points on the mesh's faces, tests/test_torch_sdf.py), cached next to the
mesh under the same file name, and either package reads the other's
cache."""

import os

import numpy as np
import pytest

import _torch_vision as tv

from partmanip_tpu.envs import assets as jassets
from partmanip_tpu_torch.envs import assets as tassets

N_OBJ = 3


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX dirs, port dirs) of the train split, each package in its own
    root."""
    jroot = str(tmp_path_factory.mktemp("jax_assets"))
    troot = str(tmp_path_factory.mktemp("port_assets"))
    return (jassets.ensure_drawer_assets(jroot, "train", N_OBJ),
            tassets.ensure_drawer_assets(troot, "train", N_OBJ))


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_generated_files_are_byte_equal(roots):
    jdirs, tdirs = roots
    assert [os.path.basename(d) for d in jdirs] == [os.path.basename(d) for d in tdirs]
    assert len(tdirs) == N_OBJ
    for jd, td in zip(jdirs, tdirs):
        assert _files(jd) == _files(td) == [".generated", "bbox_info.json",
                                            "mobility_new.urdf"]
        for f in _files(jd):
            with open(os.path.join(jd, f), "rb") as a, open(os.path.join(td, f), "rb") as b:
                assert a.read() == b.read(), f
    stamp = lambda d: open(os.path.join(os.path.dirname(d), ".genver")).read()
    assert stamp(jdirs[0]) == stamp(tdirs[0]) == str(tassets.DRAWER_GEN_VERSION)
    assert tassets.DRAWER_GEN_VERSION == jassets.DRAWER_GEN_VERSION


@pytest.mark.parametrize("split", ["valIntra", "valInter"])
def test_other_splits_generate_the_same_bytes(tmp_path, split):
    jd = jassets.generate_drawer_asset(str(tmp_path / "j"), split, 5)
    td = tassets.generate_drawer_asset(str(tmp_path / "t"), split, 5)
    assert os.path.basename(jd) == os.path.basename(td)
    for f in ("mobility_new.urdf", "bbox_info.json"):
        with open(os.path.join(jd, f), "rb") as a, open(os.path.join(td, f), "rb") as b:
            assert a.read() == b.read(), f


def test_parse_urdf_is_equal(roots):
    for jd, td in zip(*roots):
        jp = jassets.parse_urdf(os.path.join(jd, "mobility_new.urdf"))
        tp = tassets.parse_urdf(os.path.join(td, "mobility_new.urdf"))
        assert jp.dof_names == tp.dof_names
        assert [l.__dict__ for l in jp.links] == [l.__dict__ for l in tp.links]
        assert [b.__dict__ for b in jp.boxes] == [b.__dict__ for b in tp.boxes]
        assert jp.meshes == tp.meshes == []


def test_load_drawer_object_arrays_are_equal(roots):
    parsed = [tassets.parse_urdf(os.path.join(d, "mobility_new.urdf"))
              for d in roots[1]]
    pad = dict(pad_links=max(len(p.links) for p in parsed),
               pad_dofs=max(len(p.dof_names) for p in parsed),
               max_boxes=max(len(p.boxes) for p in parsed))
    for jd, td in zip(*roots):
        jo = jassets.load_drawer_object(jd, 0.5, **pad)
        to = tassets.load_drawer_object(td, 0.5, **pad)
        for a, b in zip(jo.built.spec, to.built.spec):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert jo.built.link_index == to.built.link_index
        for k in ("boxes_link_idx", "boxes_pos", "boxes_quat", "boxes_half",
                  "boxes_mask", "handle_bbox", "axis_xyz", "axis_dir"):
            np.testing.assert_array_equal(getattr(jo, k), getattr(to, k), err_msg=k)
        for k in ("target_dof", "target_link", "target_handle", "joint_lower",
                  "joint_upper", "num_dofs", "num_links"):
            assert getattr(jo, k) == getattr(to, k), k
        assert to.grids_link_idx == []


def test_mesh_collision_geoms_raise(tmp_path):
    """Baking a mesh collision geom whose mesh file is gone raises in both
    packages; the loader of each then skips that geom alike, and nothing is
    cached."""
    jdirs = jassets.ensure_drawer_assets(str(tmp_path / "j"), "train", 1, mesh_handle=True)
    dirs = tassets.ensure_drawer_assets(str(tmp_path / "t"), "train", 1, mesh_handle=True)
    loaded = []
    for pkg, d in ((jassets, jdirs[0]), (tassets, dirs[0])):
        parsed = pkg.parse_urdf(os.path.join(d, "mobility_new.urdf"))
        assert parsed.meshes
        for mesh in parsed.meshes:
            path = os.path.join(d, os.path.basename(mesh.filename))
            os.remove(path)
            with pytest.raises(FileNotFoundError):
                pkg.mesh_sdf_cached(path, np.asarray(mesh.scale, np.float32) * 0.5)
        pad = dict(pad_links=len(parsed.links), pad_dofs=len(parsed.dof_names),
                   max_boxes=len(parsed.boxes))
        loaded.append(pkg.load_drawer_object(d, 0.5, **pad))
        assert not [f for f in os.listdir(d) if ".sdf_" in f]
    assert loaded[0].grid_dicts == loaded[1].grid_dicts == []
    assert loaded[0].grids_link_idx == loaded[1].grids_link_idx == []


def test_mesh_geoms_bake_like_jax_and_share_the_cache(tmp_path):
    """A mesh-handle asset generates like the JAX package's, and loading it
    bakes each mesh geom (on the CPU here) into a grid equal to the JAX
    package's bake, cached next to the mesh under the JAX package's file
    name; the port reads a cache the JAX package wrote as it is."""
    jdirs = jassets.ensure_drawer_assets(str(tmp_path / "j"), "train", 1, mesh_handle=True)
    dirs = tassets.ensure_drawer_assets(str(tmp_path / "t"), "train", 1, mesh_handle=True)
    assert os.path.basename(os.path.dirname(dirs[0])) == "train_mesh"
    parsed = tassets.parse_urdf(os.path.join(dirs[0], "mobility_new.urdf"))
    assert parsed.meshes
    pad = dict(pad_links=len(parsed.links), pad_dofs=len(parsed.dof_names),
               max_boxes=len(parsed.boxes))
    jo = jassets.load_drawer_object(jdirs[0], 0.5, **pad)
    with tv.one_torch_thread():      # the bake: many small ops
        to = tassets.load_drawer_object(dirs[0], 0.5, **pad)
    assert len(to.grid_dicts) == len(parsed.meshes) == len(jo.grid_dicts)
    assert to.grids_link_idx == jo.grids_link_idx
    for k in ("grids_pos", "grids_quat"):
        np.testing.assert_array_equal(np.stack(getattr(to, k)), np.stack(getattr(jo, k)))
    for tg, jg in zip(to.grid_dicts, jo.grid_dicts):
        assert tg["sdf"].shape == jg["sdf"].shape and tg["sdf"].dtype == np.float32
        np.testing.assert_array_equal(tg["bbox_min"], jg["bbox_min"])
        assert tg["voxel_size"] == jg["voxel_size"]
        np.testing.assert_allclose(tg["sdf"], jg["sdf"], atol=2e-6, rtol=0)
    caches = lambda d: sorted(f for f in os.listdir(d) if ".sdf_" in f)
    assert caches(dirs[0]) == caches(jdirs[0]) and len(caches(dirs[0])) == len(parsed.meshes)
    # the port reads the JAX package's cache (the JAX bake, not its own)
    mesh = parsed.meshes[0]
    jmesh = os.path.join(jdirs[0], os.path.basename(mesh.filename))
    got = tassets.mesh_sdf_cached(jmesh, np.asarray(mesh.scale, np.float32) * 0.5)
    np.testing.assert_array_equal(got["sdf"], jo.grid_dicts[0]["sdf"])
