"""open_drawer task: grasp a cabinet handle and pull the drawer ≥50 % open
(PyTorch).

Counterpart of ``partmanip_tpu/envs/open_drawer.py`` for the state
observation modes:

* GAPartNet-layout asset dirs (procedurally generated if absent,
  :mod:`assets`) are parsed and padded to rectangular [n_objs, L/D/G] spec
  arrays, then gathered per env (``env_id % n_objs``);
* handle-bbox forward kinematics each step:
  ``bbox = (bbox_init + q·axis_dir) Rᵀ + t``;
* the part-aware reward: reach-into-bbox tests on the three handle axes,
  grip-alignment dot products, close reward, grasp-gated joint-opening
  reward capped at ``SUC_PROP = 0.5``, multiplicative rotation shaping
  ``rew += |rew|·rot``, +2 on success;
* success = grasped ∧ joint ≥ 50 % open, with the persistent per-object
  success bitmap (``task_state``, logged as ``success_objnum``);
* obs (53) = tip body row (13) + handle mid (3) + out/short/long units (9) +
  lengths (3) + qpos_norm (12) + qvel (12) + drawer qpos (1);
* random reset ±0.05 m xyz, yaw quat (sin a, cos a) with a ∈ ±π/12.

Every cabinet joint is simulated; only the per-env target dof feeds
reward/obs.  ``asset.mesh_handle`` swaps the handle bars' collision boxes
for mesh geoms, baked to SDF grids on the env's device (cached next to the
meshes) and collided by the engine's grid branch (kernel B1c).  Of the
vision observation modes, ``depth_pc``, ``depth_sparse``, ``depth_tsdf``
and ``mesh_tsdf`` are ported (:mod:`vision`: the rig is built by
``_init_vision``, the observation added by ``_vision_obs`` after every
reset and step); ``open_drawer.yaml`` gives no size for ``depth_img`` or
``rgb_img``, so those raise ``ValueError`` naming the key (the JAX
package's DAgger fails at ``env.num_obs[mode]``).  ``scene_pose`` gives
the per-step part poses that evaluation capture dumps.
"""

from __future__ import annotations

import math
import random as pyrandom
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import rotations as rot
from ..ops import sdf as sdf_ops
from ..sim import builder, contact as contact_lib
from ..sim import engine, franka, kinematics
from ..sim.types import BoxGeoms, GridGeoms, SimParams, TreeState, to_device
from . import assets, base, control, vision
from .base import STATE_OBS_MODES, EnvState, resolve_device

SUC_PROP = 0.5
OBJ_DEFAULT_ROOT = np.array([-0.6, 0, 0.5, 0, 0, 1, 0], np.float32)
RESET_T_RANGE = 0.05
RESET_R_RANGE = math.pi / 12


class OpenDrawerEnv:
    """Batched open_drawer environment.  The object holds the static specs
    (as tensors on ``device``); step/reset are functions of an explicit
    :class:`EnvState` whose ``task_state`` is the per-object success bitmap."""

    def __init__(self, cfg: dict, sim_params: SimParams, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.env_ids = np.arange(cfg["num_envs"])
        self.num_envs = len(self.env_ids)
        self.max_episode_length = cfg["maxEpisodeLength"]
        self.explore_step = cfg["explore_step"]
        self.control_freq_inv = cfg["controlFrequencyInv"]
        self.random_reset = cfg["random_reset"]
        self.learn_input_mode = cfg.get("learn_input_mode", "normal_state")
        self.add_proprio_obs = cfg.get("add_proprio_obs", False)
        self.obj_scale = cfg["asset"].get("obj_scale", 0.5)
        if self.learn_input_mode not in STATE_OBS_MODES:
            vision.obs_size(cfg, self.learn_input_mode, self.add_proprio_obs)
        rcfg = cfg["robot"]
        mobile = "mobile" in rcfg["assetFile"]
        self.built = franka.build_franka(mobile=mobile)
        spheres = franka.franka_collision_spheres(self.built)
        bi = franka.franka_body_indices(self.built)
        self.ctrl = control.FrankaControlConfig(
            drive_mode=rcfg["driveMode"], mobile=mobile, dt=sim_params.dt,
            num_dofs=int(self.built.spec.dof_mask.sum()),
            lefttip_idx=bi["lefttip"], righttip_idx=bi["righttip"],
            root_quat=tuple(rcfg["root"][3:7]))
        self.num_actions = self.ctrl.num_actions
        self.num_dofs = self.ctrl.num_dofs

        # ---- objects: scan split dir, shuffle (global ``random``, as the
        # JAX package does), load padded ----
        split = cfg["asset"]["splits"]
        n_obj = cfg["asset"].get("num_objects", 16)
        dirs = assets.ensure_drawer_assets(
            cfg["asset"]["assetRoot"], split, n_obj,
            mesh_handle=cfg["asset"].get("mesh_handle", False))
        pyrandom.shuffle(dirs)
        parsed = [assets.parse_urdf(f"{d}/mobility_new.urdf") for d in dirs]
        max_links = max(len(p.links) for p in parsed)
        max_dofs = max(max(len(p.dof_names), 1) for p in parsed)
        max_boxes = max(len(p.boxes) for p in parsed)
        objs = [assets.load_drawer_object(
            d, self.obj_scale, pad_links=max_links, pad_dofs=max_dofs,
            max_boxes=max_boxes, device=self.device) for d in dirs]
        self.objs = objs
        self.num_objects = len(objs)

        E = self.num_envs
        obj_ids = self.env_ids % self.num_objects
        self.obj_lstid = obj_ids

        obj_spec = builder.stack_trees([o.built.spec for o in objs])
        obj_spec_env = type(obj_spec)(*[np.asarray(a)[obj_ids]
                                        for a in obj_spec])
        # Every object dof gets damping 20 / friction 5 (the reference sets
        # these DOF properties at load time and ignores the URDF values);
        # null in the cfg keeps the URDF values.
        dmp = cfg["asset"].get("objDofDamping", 20.0)
        frc = cfg["asset"].get("objDofFriction", 5.0)
        if dmp is not None:
            obj_spec_env = obj_spec_env._replace(dof_damping=np.full_like(
                obj_spec_env.dof_damping, dmp))
        if frc is not None:
            obj_spec_env = obj_spec_env._replace(dof_friction=np.full_like(
                obj_spec_env.dof_friction, frc))
        boxes = BoxGeoms(
            link_idx=np.stack([o.boxes_link_idx for o in objs])[obj_ids],
            offset_pos=np.stack([o.boxes_pos for o in objs])[obj_ids],
            offset_quat=np.stack([o.boxes_quat for o in objs])[obj_ids],
            half_extents=np.stack([o.boxes_half for o in objs])[obj_ids],
            geom_mask=np.stack([o.boxes_mask for o in objs])[obj_ids],
            friction=np.ones((E, max_boxes), np.float32),
        )

        # mesh-SDF collision geoms (the mesh-handle assets): K geoms per
        # env (padded, masked), their grids stacked once for all objects
        obj_grids = grid_stack = None
        max_K = max(len(o.grids_link_idx) for o in objs)
        if max_K > 0:
            grid_dicts = []
            glink = np.zeros((self.num_objects, max_K), np.int32)
            ggid = np.zeros((self.num_objects, max_K), np.int32)
            gpos = np.zeros((self.num_objects, max_K, 3), np.float32)
            gquat = np.tile(np.array([0, 0, 0, 1], np.float32),
                            (self.num_objects, max_K, 1))
            gmask = np.zeros((self.num_objects, max_K), np.float32)
            for i, o in enumerate(objs):
                for k in range(len(o.grids_link_idx)):
                    glink[i, k] = o.grids_link_idx[k]
                    ggid[i, k] = len(grid_dicts)
                    grid_dicts.append(o.grid_dicts[k])
                    gpos[i, k] = o.grids_pos[k]
                    gquat[i, k] = o.grids_quat[k]
                    gmask[i, k] = 1.0
            trunc = 6.0 * max(g["voxel_size"] for g in grid_dicts)
            grid_stack = sdf_ops.stack_grids(grid_dicts, pad_value=trunc,
                                             device=self.device)
            obj_grids = to_device(GridGeoms(
                link_idx=glink[obj_ids], grid_id=ggid[obj_ids],
                offset_pos=gpos[obj_ids], offset_quat=gquat[obj_ids],
                geom_mask=gmask[obj_ids],
                friction=np.ones((E, max_K), np.float32)), self.device)

        # specs become tensors on the device once, here
        self.spheres = to_device(spheres, self.device)
        self.scene = engine.SceneSpec(
            robot=to_device(self.built.spec, self.device),
            spheres=self.spheres, params=sim_params,
            obj_tree=to_device(obj_spec_env, self.device),
            obj_boxes=to_device(boxes, self.device),
            obj_grids=obj_grids, grid_stack=grid_stack)
        engine.check_supported(self.scene)

        # per-env part annotations
        self.part_bbox_init = np.stack([o.handle_bbox for o in objs])[obj_ids]
        self.part_axis_dir = np.stack([o.axis_dir for o in objs])[obj_ids]
        self.target_dof = np.stack(
            [np.int32(o.target_dof) for o in objs])[obj_ids]
        self.joint_lower = np.stack(
            [np.float32(o.joint_lower) for o in objs])[obj_ids]
        self.joint_upper = np.stack(
            [np.float32(o.joint_upper) for o in objs])[obj_ids]

        self.default_dof = np.asarray(rcfg["dof"], np.float32)
        self.default_root = np.asarray(rcfg["root"], np.float32)
        self.num_obs = dict(cfg["obs_mode"])
        self._init_vision(cfg)

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)
        self._default_dof_t = dev(self.default_dof)
        self._default_root_pos_t = dev(self.default_root[:3])
        self._default_root_quat_t = dev(
            self.default_root[3:7] / np.linalg.norm(self.default_root[3:7]))
        self._obj_default_pos_t = dev(OBJ_DEFAULT_ROOT[:3])
        self._obj_default_quat_t = dev(OBJ_DEFAULT_ROOT[3:7])
        self._bbox_init_t = dev(self.part_bbox_init)
        self._axis_dir_t = dev(self.part_axis_dir)
        self._target_dof_t = dev(self.target_dof, torch.int64)
        self._joint_lower_t = dev(self.joint_lower)
        self._joint_upper_t = dev(self.joint_upper)
        self._obj_ids_t = dev(obj_ids, torch.int64)

    def _init_vision(self, cfg):
        """Vision rig + flattened obs size of a vision learn mode
        (:func:`vision.obs_size`; open_drawer's proprio_state is 0)."""
        mode = self.learn_input_mode
        self.vision_rig = None
        if mode in STATE_OBS_MODES:
            return
        self.vision_rig = vision.VisionRig(
            cfg["cam"], cfg["obs_mode"]["tsdf"], mode,
            im_scale=cfg.get("im_scale", 1), device=self.device)
        self.num_obs[mode] = vision.obs_size(cfg, mode, self.add_proprio_obs)

    def _vision_obs(self, state: EnvState, obs: Dict):
        if self.vision_rig is None:
            return obs
        obs.update(vision.render_obs(self, self.vision_rig, state.sim))
        if self.add_proprio_obs and "proprio_state" in obs:
            m = self.learn_input_mode
            obs[m] = torch.cat([obs[m], obs["proprio_state"]], dim=-1)
        return obs

    # ------------------------------------------------------------------
    # state init / reset
    # ------------------------------------------------------------------

    def _default_sim(self, E: int) -> engine.SceneState:
        d = self.device
        D_obj = self.scene.obj_tree.dof_mask.shape[-1]
        robot = TreeState(
            qpos=self._default_dof_t.repeat(E, 1),
            qvel=torch.zeros((E, self.default_dof.shape[0]), device=d),
            root_pos=self._default_root_pos_t.repeat(E, 1),
            root_quat=self._default_root_quat_t.repeat(E, 1))
        obj = TreeState(
            qpos=self.scene.obj_tree.dof_lower.expand(E, D_obj) * 1.0,
            qvel=torch.zeros((E, D_obj), device=d),
            root_pos=self._obj_default_pos_t.repeat(E, 1),
            root_quat=self._obj_default_quat_t.repeat(E, 1))
        anchors = contact_lib.init_anchors(E, self.spheres.link_idx.shape[0], d)
        return engine.SceneState(robot=robot, obj=obj, anchors=anchors)

    def _random_obj_root(self, rng: torch.Generator, E: int, draws=None):
        """Cabinet root: default ± 0.05 m per axis, yaw quat (0,0,sin a,cos a)
        composed onto the default rotation, a ∈ ±π/12.  ``draws=(dxyz
        [E, 3], a [E])`` replaces the generator's draws (tests feed both
        packages the same numbers)."""
        d = self.device
        pos = self._obj_default_pos_t.repeat(E, 1)
        quat0 = self._obj_default_quat_t.expand(E, 4)
        if not self.random_reset:
            return pos, quat0.clone()
        if draws is None:
            rand = lambda *shape: torch.rand((E, *shape), generator=rng, device=d)
            dxyz = (rand(3) * 2.0 - 1.0) * RESET_T_RANGE
            a = (rand() * 2.0 - 1.0) * RESET_R_RANGE
        else:
            dxyz, a = (torch.as_tensor(x, dtype=torch.float32, device=d)
                       for x in draws)
        zero = torch.zeros_like(a)
        dq = torch.stack([zero, zero, torch.sin(a), torch.cos(a)], dim=-1)
        return pos + dxyz, rot.quat_mul(quat0, dq)

    def _reset_sim_fn(self, sim: engine.SceneState, mask, rng, draws=None):
        """Partial reset: robot and cabinet joints to defaults, randomized
        cabinet root, zero velocities, anchors released."""
        E = mask.shape[0]
        fresh = self._default_sim(E)
        pos, quat = self._random_obj_root(rng, E, draws)
        fresh = fresh._replace(obj=fresh.obj._replace(root_pos=pos,
                                                      root_quat=quat))
        return base.mask_where(mask, fresh, sim)

    # ------------------------------------------------------------------
    # observation / reward
    # ------------------------------------------------------------------

    def _robot_view(self, sim: engine.SceneState):
        fk = kinematics.forward_kinematics(self.scene.robot, sim.robot)
        return control.robot_view(self.ctrl, self.scene.robot, fk, sim.robot), fk

    def _target_qpos(self, sim: engine.SceneState):
        """The target drawer joint position per env [E]."""
        return torch.gather(sim.obj.qpos, 1, self._target_dof_t[:, None])[:, 0]

    def _part_bbox(self, sim: engine.SceneState):
        """Handle bbox in the world [E, 8, 3]."""
        q = self._target_qpos(sim)
        objc = (self._bbox_init_t
                + q[:, None, None] * self._axis_dir_t[:, None, :])
        R = rot.quat_to_mat(sim.obj.root_quat)            # [E, 3, 3]
        return (torch.einsum("eca,eba->ecb", objc, R)
                + sim.obj.root_pos[:, None, :])

    @staticmethod
    def _handle_axes(part_bbox):
        out = part_bbox[:, 0] - part_bbox[:, 4]
        long = part_bbox[:, 1] - part_bbox[:, 0]
        short = part_bbox[:, 3] - part_bbox[:, 0]
        mid = (part_bbox[:, 0] + part_bbox[:, 6]) / 2
        ol = torch.linalg.norm(out, dim=-1)
        ll = torch.linalg.norm(long, dim=-1)
        sl = torch.linalg.norm(short, dim=-1)
        return (out / ol[:, None], long / ll[:, None], short / sl[:, None],
                mid, ol, ll, sl)

    def _observations(self, state: EnvState):
        view, _ = self._robot_view(state.sim)
        part_bbox = self._part_bbox(state.sim)
        out, long, short, mid, ol, ll, sl = self._handle_axes(part_bbox)
        q_target = self._target_qpos(state.sim)
        D = self.num_dofs
        normal = torch.cat([
            view.tip_state,                       # 13
            mid,                                  # 3
            out, short, long,                     # 9
            ol[:, None], ll[:, None], sl[:, None],  # 3
            view.qpos_normalized[:, :D],          # 12
            view.qvel[:, :D],                     # 12
            q_target[:, None],                    # 1  → 53
        ], dim=-1)
        return {"normal_state": normal}, view, part_bbox

    def _reward(self, state: EnvState, view, part_bbox, actions):
        out, long, short, mid, ol, ll, sl = self._handle_axes(part_bbox)

        tip = view.tip_state
        d = tip[:, :3] - mid
        dist = torch.linalg.norm(d, dim=-1)
        is_reached_out = torch.abs(torch.sum(d * out, -1)) < ol / 2
        short_l = torch.sum((view.ltip_state[:, :3] - mid) * short, -1)
        short_r = torch.sum((view.rtip_state[:, :3] - mid) * short, -1)
        is_reached_short = (short_l * short_r) < 0
        is_reached_long = torch.abs(torch.sum(d * long, -1)) < ll / 2
        is_reached = is_reached_out & is_reached_short & is_reached_long
        reaching = -dist + 0.1 * (is_reached_out.float()
                                  + is_reached_short.float()
                                  + is_reached_long.float())

        hq = tip[:, 3:7]
        grip_dir = rot.quat_axis(hq, 2)
        sep_dir = rot.quat_axis(hq, 1)
        down_dir = rot.quat_axis(hq, 0)
        dot1 = torch.sum(-grip_dir * out, -1)
        dot2 = torch.maximum(torch.sum(sep_dir * short, -1),
                             torch.sum(-sep_dir * short, -1))
        dot3 = torch.maximum(torch.sum(down_dir * long, -1),
                             torch.sum(-down_dir * long, -1))
        rot_reward = dot1 + dot2 + dot3 - 3.0

        gl = view.gripper_length
        close_reward = (0.1 - gl) * is_reached + 0.1 * (gl - 0.1) * (~is_reached)

        grasp_success = (is_reached & (gl < sl + 0.01) & (rot_reward > -0.2))

        q = self._target_qpos(state.sim)
        lower, upper = self._joint_lower_t, self._joint_upper_t
        open_frac = (q - lower) / upper
        joint_state_reward = grasp_success * (
            0.1 + torch.clamp(open_frac, max=SUC_PROP))
        is_open = grasp_success & (open_frac > 0.1)
        is_open_notgrasp = open_frac > 0.1

        rew = (reaching + 0.5 * rot_reward + 5.0 * close_reward
               + 5.0 * joint_state_reward)
        rew = rew + torch.abs(rew) * rot_reward   # multiplicative shaping

        success = grasp_success & ((q - lower) >= SUC_PROP * upper)
        # per-object bitmap: an object is solved once any env holding it
        # succeeds
        hits = torch.zeros(self.num_objects, dtype=torch.int32, device=self.device).index_add_(
            0, self._obj_ids_t, success.to(torch.int32))
        succ_objid = state.task_state | (hits > 0)
        rew = rew + 2.0 * success

        extras = {
            "is_open": is_open,
            "is_open_notgrasp": is_open_notgrasp,
            "reaching_reward": reaching,
            "close_reward": close_reward,
            "rot_reward": rot_reward,
            "is_reached": is_reached,
            "joint_state_reward": joint_state_reward,
            "raw_reward": rew,
            "is_grasped": grasp_success.float(),
            "success_objnum": succ_objid,
            "step_id": state.progress.float(),
            "open_frac": open_frac,
        }
        return rew, success, succ_objid, extras

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def step(self, state: EnvState, actions, train: bool = True,
             force_reset=None):
        """One env step. Returns (state', obs_dict, rew, reset, extras)."""
        E = self.num_envs
        view, _ = self._robot_view(state.sim)
        targets = control.compute_targets(self.ctrl, self.scene.robot, view,
                                          actions)
        default_targets = self._default_dof_t.repeat(E, 1)
        task_state = state.task_state
        state, final_targets, pre_extras = base.pre_physics(
            state, targets, default_targets, self._reset_sim_fn,
            self.explore_step, self.max_episode_length, train,
            force_reset=force_reset)

        sim = base.run_physics(self.scene, state.sim, final_targets,
                               self.control_freq_inv)
        state = state._replace(sim=sim, progress=state.progress + 1,
                               task_state=task_state)

        obs, view, part_bbox = self._observations(state)
        obs = self._vision_obs(state, obs)
        rew, success, succ_objid, extras = self._reward(
            state, view, part_bbox, actions)
        extras.update(pre_extras)
        state = state._replace(rew_buf=rew, success=success,
                               task_state=succ_objid)
        return state, obs, rew, state.reset_buf, extras
