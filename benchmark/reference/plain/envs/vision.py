"""Vision observation rig shared by the tasks (PyTorch).

Counterpart of ``partmanip_tpu/envs/vision.py``: a hemisphere rig (3 views
of 288×512 for the volumetric modes, 1 view of 72×128 for the image modes),
SDF-raymarched depth (kernel B2 on the GPU, coarse to fine and culled as
the rig says) and the derived observation modes, all ported:

* ``depth_tsdf`` — multi-view TSDF fusion of the rendered depth → res³;
* ``depth_pc`` — unproject + workspace crop + FPS-1024 (kernel B3 on the
  GPU) → 3072;
* ``depth_sparse`` — the fused volume's near-surface voxels, FPS-1024 of
  their integer coordinates (B3) with the TSDF value at each → [1024, 4]
  → 4096;
* ``depth_img`` — the single view's raw depth, 72×128 → 9216;
* ``rgb_img`` — Lambertian-shaded per-segment albedo at the depth image's
  hit points (``raymarch.render_rgb``, plain PyTorch), channel-first
  [3, 72, 128] → 27648;
* ``mesh_tsdf`` — the scene's TSDF sampled analytically from the collision
  primitives at the voxel centres, ``clip(scene_sdf / sdf_trunc, -1, 1)``
  → res³; it renders nothing, so it launches no kernel.

Another mode raises ``NotImplementedError`` at its first observation, as
in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops import raymarch, tsdf as tsdf_lib
from ..sim import contact as contact_lib
from ..sim import engine, kinematics
from ..utils import camera

IMG_H, IMG_W = 288 // 4, 512 // 4
VOL_H, VOL_W = 288, 512
# ``mesh_tsdf`` queries the grid in about N // GRID_CHUNK chunks of points
# (the JAX package's count), so that its [E, chunk, G] temporaries stay
# bounded: at 16 envs × 50³ points × 25 boxes one f32 temporary of the
# whole grid would be 200 MB
GRID_CHUNK = 16384


class VisionRig:
    def __init__(self, cam_cfg: dict, tsdf_cfg: dict, learn_input_mode: str,
                 im_scale: int = 1, device="cpu"):
        """im_scale > 1 shrinks the volumetric render (tests; the image
        modes keep their 72×128); ``device`` holds the voxel centres
        ``mesh_tsdf`` queries (the env's)."""
        self.mode = learn_input_mode
        if "img" in learn_input_mode:
            self.num_view = 1
            self.im_h, self.im_w = IMG_H, IMG_W
        else:
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


