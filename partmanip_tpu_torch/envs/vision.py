"""Vision observation rig shared by the tasks (PyTorch).

Counterpart of ``partmanip_tpu/envs/vision.py``: a hemisphere rig (3 views
of 288×512 for the volumetric modes), SDF-raymarched depth and the derived
observation.  Ported modes:

* ``depth_pc`` — unproject + workspace crop + FPS-1024 → 3072 (kernels B2
  and B3 on the GPU);
* ``depth_tsdf`` — multi-view TSDF fusion of the rendered depth (kernel B2
  on the GPU) → res³;
* ``mesh_tsdf`` — the scene's TSDF sampled analytically from the collision
  primitives at the voxel centres, ``clip(scene_sdf / sdf_trunc, -1, 1)``
  → res³; it renders nothing, so it launches no kernel.

The other modes (``depth_sparse``, ``depth_img``, ``rgb_img``) raise
``NotImplementedError`` (ROADMAP Queue A: remaining vision modes).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops import raymarch, tsdf as tsdf_lib
from ..sim import contact as contact_lib
from ..sim import engine, kinematics
from ..utils import camera

VOL_H, VOL_W = 288, 512

PORTED_MODES = ("depth_pc", "depth_tsdf", "mesh_tsdf")
# ``mesh_tsdf`` queries the grid in about N // GRID_CHUNK chunks of points
# (the JAX package's count), so that its [E, chunk, G] temporaries stay
# bounded: at 16 envs × 50³ points × 25 boxes one f32 temporary of the
# whole grid would be 200 MB
GRID_CHUNK = 16384


def check_mode(mode: str) -> None:
    """Raise for a vision observation mode that is not ported yet."""
    if mode not in PORTED_MODES:
        raise NotImplementedError(
            f"obs_mode {mode!r} is not ported yet; the port renders "
            f"{', '.join(PORTED_MODES)} (ROADMAP Queue A: remaining vision "
            f"modes)")


class VisionRig:
    def __init__(self, cam_cfg: dict, tsdf_cfg: dict, learn_input_mode: str,
                 im_scale: int = 1, device="cpu"):
        """im_scale > 1 shrinks the volumetric render (tests); ``device``
        holds the voxel centres ``mesh_tsdf`` queries (the env's)."""
        check_mode(learn_input_mode)
        self.mode = learn_input_mode
        self.num_view = 3
        self.im_h, self.im_w = VOL_H // im_scale, VOL_W // im_scale
        self.poses = camera.gen_camera_poses(
            cam_cfg["look_at"], cam_cfg["radius"], num_views=self.num_view)
        self.intrinsic = camera.camera_intrinsics(self.im_w, self.im_h)
        self.tsdf_spec = tsdf_lib.make_tsdf_spec(
            self.poses, self.intrinsic, self.im_h, self.im_w,
            size=tsdf_cfg["size"], resolution=tsdf_cfg["resolution"],
            origin=tsdf_cfg["origin"])
        # the volume's voxel centres [res³, 3], queried by mesh_tsdf
        self.grid_points = torch.as_tensor(self.tsdf_spec.world_points, device=device)
        self.sdf_trunc = self.tsdf_spec.sdf_trunc
        self.coarse_to_fine = bool(cam_cfg.get("coarse_to_fine", True))
        # per-tile cone culling, as the JAX package's TPU kernel renders (no
        # YAML key: the JAX package has none; its CPU renderer does not cull)
        self.cull = True


def scene_prims(env, sim: engine.SceneState) -> raymarch.ScenePrims:
    """Assemble the analytic primitive set of the current scene state: the
    robot's collision spheres and the object's boxes (grasp_cube's free
    cube, or a cabinet's box geoms).  On mesh-handle cabinets the handle
    bars are mesh geoms, which this set leaves out, as the JAX package
    does: every vision mode sees the box geoms only."""
    E = sim.robot.qpos.shape[0]
    fk_r = kinematics.forward_kinematics(env.scene.robot, sim.robot)
    centers = contact_lib.sphere_positions(env.scene.robot, fk_r,
                                           env.scene.spheres, E)
    radius = env.scene.spheres.radius[None].expand(centers.shape[:2])
    if env.scene.obj_tree is not None:
        fk_o = kinematics.forward_kinematics(env.scene.obj_tree, sim.obj)
        bp, bq = engine.obj_box_world(env.scene.obj_tree, env.scene.obj_boxes,
                                      fk_o, E)
        half = env.scene.obj_boxes.half_extents.expand(bp.shape[:2] + (3,))
        mask = env.scene.obj_boxes.geom_mask.expand(bp.shape[:2])
    else:
        fb = env.scene.free_body
        bp = sim.body.pos[:, None, :]
        bq = sim.body.quat[:, None, :]
        half = fb.half_extents.reshape(-1, 3).expand(E, 3)[:, None]
        mask = torch.ones((E, 1), device=bp.device)
    return raymarch.ScenePrims(
        sphere_center=centers, sphere_radius=radius,
        box_pos=bp, box_quat=bq, box_half=half, box_mask=mask, ground=True)


def render_depth(rig: VisionRig, prims: raymarch.ScenePrims) -> torch.Tensor:
    """The rig's depth images [E, V, H, W] (coarse-to-fine and culled as
    the rig says)."""
    return raymarch.render_depth(prims, rig.poses, rig.intrinsic, rig.im_h,
                                 rig.im_w, coarse_to_fine=rig.coarse_to_fine,
                                 cull=rig.cull)


def mesh_tsdf(rig: VisionRig, prims: raymarch.ScenePrims) -> torch.Tensor:
    """The scene's truncated SDF at the rig's voxel centres, [E, res³]:
    ``clip(scene_sdf / sdf_trunc, -1, 1)``, the grid queried chunk by
    chunk."""
    E = prims.sphere_center.shape[0]
    chunks = rig.grid_points.chunk(max(1, rig.grid_points.shape[0] // GRID_CHUNK))
    d = torch.cat([raymarch.scene_sdf(prims, c[None].expand(E, -1, -1))
                   for c in chunks], dim=1)
    return torch.clamp(d / rig.sdf_trunc, -1.0, 1.0)


def render_obs(env, rig: VisionRig, sim: engine.SceneState) -> Dict:
    """The configured vision observation, flattened (≙ the shapes of
    ``cfg/tasks/*.yaml`` obs_mode)."""
    prims = scene_prims(env, sim)
    E = prims.sphere_center.shape[0]
    if rig.mode == "mesh_tsdf":
        return {rig.mode: mesh_tsdf(rig, prims)}
    depth = render_depth(rig, prims)
    if rig.mode == "depth_tsdf":
        return {rig.mode: tsdf_lib.integrate(rig.tsdf_spec, depth).reshape(E, -1)}
    return {rig.mode: tsdf_lib.depth_to_pointcloud(
        rig.tsdf_spec, depth, k=1024).reshape(E, -1)}
