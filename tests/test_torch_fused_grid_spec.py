"""The Python side of kernel B1c that needs no JAX and no GPU
(``partmanip_tpu_torch/sim/fused.py`` for an open_drawer scene with mesh
handles): each cabinet's record is B1b's ``struct ObjSpec`` followed by a
``struct GridSpec`` (both read out of ``csrc/fused_inner_step_obj.cu``,
since there is no nvcc on a CPU host), the state rows are B1b's, the build
is keyed on K and the grid stack's shape, ``FIS_K`` stays out of B1b's
build, and the scenes B1c cannot run raise with the reason."""

import random
import re

import numpy as np
import pytest
import torch

import _torch_cu
import _torch_vision as tv

from partmanip_tpu_torch.config import process_cfgs
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv
from partmanip_tpu_torch.sim import fused
from partmanip_tpu_torch.utils import cuda_lib

E = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: the bakes and the plain steps are many small ops,
    which spin-wait under the test run's several workers when each op is
    split over every core (tests/_torch_vision.py)."""
    with tv.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def menv(tmp_path_factory):
    cfg, sp = process_cfgs(["--taskcfg", "open_drawer", "--algo.num_envs", str(E),
                            "--task.asset.num_objects", "2", "--task.asset.mesh_handle",
                            "--task.asset.assetRoot",
                            str(tmp_path_factory.mktemp("assets"))])
    random.seed(0)
    return OpenDrawerEnv(cfg["task"], sp, device="cpu")


def _struct_words(name, dims):
    """{field: (offset, words)} and the size of ``struct name`` in 4-byte
    words, parsed from the kernel source."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, _torch_cu.read(fused.KERNEL_SOURCE_OBJ),
                     re.S).group(1)
    offsets, words = {}, 0
    for _, field, extents in re.findall(
            r"^\s*(int|float)\s+(\w+)((?:\[\w+\])*);", body, re.M):
        size = 1
        for ext in re.findall(r"\[(\w+)\]", extents):
            size *= dims[ext] if ext in dims else int(ext)
        offsets[field] = (words, size)
        words += size
    return offsets, words


def _dims(env):
    return dict(zip(("L", "D", "S", "LO", "DO", "G", "K", "GX", "GY", "GZ"),
                    fused._dims(env.scene)))


def test_obj_and_grid_records_match_the_kernel_structs(menv):
    """One ObjSpec and one GridSpec record per distinct cabinet; GridSpec
    record obj_id[e] holds env e's mesh geoms, grid ids into the stack."""
    dims = _dims(menv)
    _, obj_words = _struct_words("ObjSpec", dims)
    offsets, grid_words = _struct_words("GridSpec", dims)
    (objs, grids), obj_id = fused.pack_obj_table(menv.scene)
    assert objs.shape == (2, obj_words) and grids.shape == (2, grid_words)
    assert obj_id.shape == (E,)
    g = menv.scene.obj_grids
    for e in range(E):
        rec = grids[obj_id[e]]

        def field(name, dtype=np.float32):
            lo, n = offsets[name]
            return rec[lo:lo + n].view(dtype)
        np.testing.assert_array_equal(field("g_link", np.int32), g.link_idx[e].numpy())
        np.testing.assert_array_equal(field("g_gid", np.int32), g.grid_id[e].numpy())
        np.testing.assert_array_equal(field("g_pos"), g.offset_pos[e].numpy().ravel())
        np.testing.assert_array_equal(field("g_quat"), g.offset_quat[e].numpy().ravel())
        np.testing.assert_array_equal(field("g_mask"), g.geom_mask[e].numpy())
        np.testing.assert_array_equal(field("g_mu"), g.friction[e].numpy())
    # the ObjSpec part is exactly B1b's packing of the same cabinets
    box_only = menv.scene._replace(obj_grids=None, grid_stack=None)
    (b1b_table,), b1b_ids = fused.pack_obj_table(box_only)
    np.testing.assert_array_equal(objs.view(np.int32), b1b_table.view(np.int32))
    np.testing.assert_array_equal(obj_id, b1b_ids)


def test_state_rows_and_sizes(menv):
    """B1c carries B1b's state buffer; its compile-time sizes add K and the
    grid shape, its spec struct is B1b's."""
    assert fused.variant(menv.scene) == "b1c"
    L, D, S, Lo, Do, G, K, X, Y, Z = fused._dims(menv.scene)
    assert (L, D, S, Do, K) == (16, 12, 18, 4, 4)
    assert (X, Y, Z) == tuple(menv.scene.grid_stack.sdf.shape[1:])
    assert fused._rows("b1c", fused._dims(menv.scene)) == fused.state_rows_obj(D, S, Do)
    box_only = menv.scene._replace(obj_grids=None, grid_stack=None)
    np.testing.assert_array_equal(fused.pack_spec_obj(menv.scene), fused.pack_spec_obj(box_only))


def test_build_is_keyed_on_k_and_the_grid_shape(monkeypatch):
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: "nvcc")
    dims = (16, 12, 18, 9, 4, 21, 4, 29, 73, 73)
    cmd = fused.library("b1c", dims).command()
    for flag in ("-DFIS_G=21", "-DFIS_K=4", "-DFIS_GX=29", "-DFIS_GY=73", "-DFIS_GZ=73",
                 "arch=compute_90a,code=sm_90a"):
        assert flag in cmd
    assert cmd[-1] == fused.KERNEL_SOURCE_OBJ
    assert fused.library("b1c", dims).path.endswith(
        "libfused_inner_step_obj_L16_D12_S18_Lo9_Do4_G21_K4_X29_Y73_Z73.so")
    assert fused.library("b1c", dims[:-1] + (72,)).path != fused.library("b1c", dims).path
    # B1b's build names no FIS_K: K = 0 compiles B1b as it was
    assert not any("FIS_K" in c for c in fused.library("b1b", dims[:6]).command())
    sig = fused.library("b1c", dims).signatures
    assert "fis_grid_bytes" in sig and len(sig["fis_launch"][0]) == 15


def _refused(scene, what):
    g, st = scene.obj_grids, scene.grid_stack
    if what == "more_than_32_geoms":
        wide = type(g)(*[torch.cat([x] * 9, dim=1) for x in g])
        return scene._replace(obj_grids=wide), fused.check_scene
    if what == "grid_id_outside_the_stack":
        return (scene._replace(obj_grids=g._replace(grid_id=g.grid_id + 100)),
                fused.pack_obj_table)
    if what == "f64_stack":
        return scene._replace(grid_stack=st._replace(sdf=st.sdf.double())), fused.check_scene
    return scene._replace(obj_grids=g._replace(geom_mask=g.geom_mask * 0.5)), fused.pack_obj_table


@pytest.mark.parametrize("what", ["more_than_32_geoms", "grid_id_outside_the_stack",
                                  "f64_stack", "fractional_geom_mask"])
def test_scenes_kernel_b1c_cannot_run_raise(menv, what):
    scene, fn = _refused(menv.scene, what)
    with pytest.raises(NotImplementedError):
        fn(scene)
