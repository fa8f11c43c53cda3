"""grasp_cube task: pick up a 5 cm cube and hold it at (0, 0, 0.2) (PyTorch).

Counterpart of ``partmanip_tpu/envs/grasp_cube.py`` for the state
observation modes:

* obs (37) = range-normalized tip pose (7) + normalized obj pos (3) +
  symmetry-canonicalized 9D obj rotation (9) + normalized qpos (9) +
  raw qvel (9);
* reward = reach + 0.5·rot + 5·close + 20·reach-goal (+3·success);
* success: obj within 0.025 m of (0, 0, 0.2) while the gripper is at the obj;
* random reset: xy ± 0.15, random yaw.

Every vision observation mode is ported (:mod:`vision`): ``depth_img``
(9216) and ``rgb_img`` (27648), one 72×128 view; ``depth_pc`` (3072) and
``depth_sparse`` (4096), three 288×512 views; ``mesh_tsdf`` and
``depth_tsdf`` with grasp_cube's own ``tsdf`` block (size 0.5 m at res 50,
res³); + the 25 proprio dims with ``add_proprio_obs``.  The sizes are the
YAML's, as in the JAX package.  With a state learn mode ``num_obs`` stays
as the YAML says (37): the JAX package's ``_init_vision`` adds the proprio
dims to it, though its observation concatenates none (ROADMAP Queue C).
``scene_pose`` gives the per-step part poses that evaluation capture
dumps (``algos/ppo._eval_capture``); ``save_video`` needs nothing of the
env (the frames are rendered by the runner).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import rotations as rot
from ..parallel import mesh as mesh_lib
from ..sim import contact as contact_lib
from ..sim import engine, franka, kinematics
from ..sim.types import (FreeBodySpec, FreeBodyState, SimParams, TreeState,
                         to_device)
from . import base, control, vision
from .base import STATE_OBS_MODES, EnvState, resolve_device

RESET_RANGE = 0.15
GOAL_THRESH = 0.025
SUCCESS_POS = (0.0, 0.0, 0.2)
CUBE_HALF = 0.025           # obj z0 0.025 ⇒ 5 cm cube
CUBE_DENSITY = 1000.0


class GraspCubeEnv:
    """Batched grasp_cube environment.  The object holds the static specs
    (as tensors on ``device``); step/reset are functions of an explicit
    :class:`EnvState`."""

    def __init__(self, cfg: dict, sim_params: SimParams, device="cuda", mesh=None):
        """``mesh`` (``parallel/mesh.py``): the env holds this rank's share
        of the ``num_envs`` envs."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.num_envs = len(mesh_lib.env_ids(mesh, cfg["num_envs"]))
        self.max_episode_length = cfg["maxEpisodeLength"]
        self.explore_step = cfg["explore_step"]
        self.control_freq_inv = cfg["controlFrequencyInv"]
        self.random_reset = cfg["random_reset"]
        self.learn_input_mode = cfg.get("learn_input_mode", "normal_state")
        self.add_proprio_obs = cfg.get("add_proprio_obs", False)
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

        m = CUBE_DENSITY * (2 * CUBE_HALF) ** 3
        cube = FreeBodySpec(
            mass=np.full(1, m, np.float32),
            inertia=(np.eye(3, dtype=np.float32)
                     * (m * (2 * CUBE_HALF) ** 2 / 6))[None],
            half_extents=np.full((1, 3), CUBE_HALF, np.float32),
            gravity_scale=np.ones(1, np.float32),
            friction=np.ones(1, np.float32),
        )
        # specs become tensors on the device once, here
        self.spheres = to_device(spheres, self.device)
        self.scene = engine.SceneSpec(
            robot=to_device(self.built.spec, self.device),
            spheres=self.spheres, params=sim_params,
            free_body=to_device(cube, self.device))
        engine.check_supported(self.scene)

        self.default_dof = np.asarray(rcfg["dof"], np.float32)
        self.default_root = np.asarray(rcfg["root"], np.float32)
        self.obj_default_root = np.array([0, 0, CUBE_HALF, 0, 0, 0, 1],
                                         np.float32)
        # pose normalization limits
        self.pose_lower = np.array(
            [-RESET_RANGE, -RESET_RANGE, 0.0, -1, -1, -1, -1], np.float32)
        self.pose_upper = np.array(
            [RESET_RANGE, RESET_RANGE, 0.4, 1, 1, 1, 1], np.float32)

        self.num_dofs = self.ctrl.num_dofs
        self.num_obs = dict(cfg["obs_mode"])
        self._init_vision(cfg)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device)
        self._default_dof_t = dev(self.default_dof)
        self._default_root_pos_t = dev(self.default_root[:3])
        self._default_root_quat_t = dev(
            self.default_root[3:7] / np.linalg.norm(self.default_root[3:7]))
        self._obj_default_pos_t = dev(self.obj_default_root[:3])
        self._obj_default_quat_t = dev(self.obj_default_root[3:7])
        self._pose_lower_t = dev(self.pose_lower)
        self._pose_upper_t = dev(self.pose_upper)
        self._goal_t = dev(SUCCESS_POS)

    def _init_vision(self, cfg):
        """Vision rig + flattened obs size of a vision learn mode
        (:func:`vision.obs_size`)."""
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
        if self.add_proprio_obs:
            m = self.learn_input_mode
            obs[m] = torch.cat([obs[m], obs["proprio_state"]], dim=-1)
        return obs

    # ------------------------------------------------------------------
    # state init / reset
    # ------------------------------------------------------------------

    def make_generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def _default_sim(self, E: int) -> engine.SceneState:
        d = self.device
        robot = TreeState(
            qpos=self._default_dof_t.repeat(E, 1),
            qvel=torch.zeros((E, self.default_dof.shape[0]), device=d),
            root_pos=self._default_root_pos_t.repeat(E, 1),
            root_quat=self._default_root_quat_t.repeat(E, 1))
        body = FreeBodyState(
            pos=self._obj_default_pos_t.repeat(E, 1),
            quat=self._obj_default_quat_t.repeat(E, 1),
            linvel=torch.zeros((E, 3), device=d),
            angvel=torch.zeros((E, 3), device=d))
        anchors = contact_lib.init_anchors(E, self.spheres.link_idx.shape[0], d)
        return engine.SceneState(robot=robot, body=body, anchors=anchors)

    def _random_obj_root(self, rng: torch.Generator, E: int, draws=None):
        """Randomized cube pose: xy ± reset_range, yaw via quat
        (0,0,sin a,cos a), a ∈ [−π, π].  ``draws=(dxy [E, 2], a [E])`` replaces
        the generator's draws (tests feed both packages the same numbers)."""
        d = self.device
        pos = self._obj_default_pos_t.repeat(E, 1)
        if self.random_reset:
            if draws is None:
                rand = lambda *shape: mesh_lib.shard_draw(
                    self.mesh, E, lambda n: torch.rand((n, *shape), generator=rng, device=d))
                dxy = (rand(2) * 2.0 - 1.0) * RESET_RANGE
                a = (rand() * 2.0 - 1.0) * math.pi
            else:
                dxy, a = (torch.as_tensor(x, dtype=torch.float32, device=d)
                          for x in draws)
            pos = torch.cat([pos[:, :2] + dxy, pos[:, 2:]], dim=1)
            zero = torch.zeros_like(a)
            quat = torch.stack([zero, zero, torch.sin(a), torch.cos(a)], dim=-1)
        else:
            quat = self._obj_default_quat_t.repeat(E, 1)
        return pos, quat

    def _reset_sim_fn(self, sim: engine.SceneState, mask, rng, draws=None):
        """Partial reset: robot dofs and both roots to defaults, randomized
        cube pose, zero velocities."""
        E = mask.shape[0]
        fresh = self._default_sim(E)
        pos, quat = self._random_obj_root(rng, E, draws)
        fresh = fresh._replace(body=fresh.body._replace(pos=pos, quat=quat))
        return base.mask_where(mask, fresh, sim)

    def init_state(self, rng: torch.Generator, draws=None) -> EnvState:
        E = self.num_envs
        st = base.init_env_state(self._default_sim(E), E, rng)
        sim = self._reset_sim_fn(
            st.sim, torch.ones(E, dtype=torch.bool, device=self.device), rng,
            draws)
        return st._replace(sim=sim)

    def reset(self, state: EnvState, draws=None) -> Tuple[EnvState, Dict]:
        """Full reset of all envs + one settling step."""
        E = self.num_envs
        sim = self._reset_sim_fn(
            state.sim, torch.ones(E, dtype=torch.bool, device=self.device),
            state.rng, draws)
        targets = self._default_dof_t.repeat(E, 1)
        sim = base.run_physics(self.scene, sim, targets, 1, self.mesh)
        state = base.init_env_state(sim, E, state.rng)
        obs, _ = self._observations(state)
        return state, self._vision_obs(state, obs)

    def scene_pose(self, state: EnvState):
        """The 11 posed robot links and the cube (:func:`base.scene_pose`):
        ``rot [E, 12, 3, 3]``, ``pos [E, 12, 3]``."""
        return base.scene_pose(self.scene, self.built.link_index, state.sim,
                               state.sim.body.quat, state.sim.body.pos)

    # ------------------------------------------------------------------
    # observation / reward
    # ------------------------------------------------------------------

    def _robot_view(self, sim: engine.SceneState):
        fk = kinematics.forward_kinematics(self.scene.robot, sim.robot)
        return control.robot_view(self.ctrl, self.scene.robot, fk, sim.robot), fk

    def _observations(self, state: EnvState):
        view, fk = self._robot_view(state.sim)
        E = self.num_envs
        lo, up = self._pose_lower_t, self._pose_upper_t
        D = self.num_dofs

        tip_pose = 2.0 * (view.tip_state[:, :7] - lo) / (up - lo) - 1.0
        obj_pos13 = state.sim.body.pos
        obj_pos = 2.0 * (obj_pos13 - lo[:3]) / (up[:3] - lo[:3]) - 1.0
        obj_rot9 = rot.deambiguity_rotation(state.sim.body.quat).reshape(E, 9)
        qn = view.qpos_normalized[:, :D]
        qv = view.qvel[:, :D]
        normal = torch.cat([tip_pose, obj_pos, obj_rot9, qn, qv], -1)
        obs = {"normal_state": normal}
        if self.add_proprio_obs:
            obs["proprio_state"] = torch.cat([tip_pose, qn, qv], -1)
        return obs, view

    def _reward(self, state: EnvState, view, actions):
        obj_pos = state.sim.body.pos
        tip = view.tip_state
        tcp_to_obj = torch.linalg.norm(tip[:, :3] - obj_pos, dim=-1)
        is_reached = tcp_to_obj < 0.02
        reaching = -tcp_to_obj

        gl = view.gripper_length
        close_reward = (0.1 - gl) * is_reached + 0.1 * (gl - 0.1) * (~is_reached)

        obj_rot = rot.deambiguity_rotation(state.sim.body.quat)
        hand_rot = rot.quat_to_mat(tip[:, 3:7])
        down = -hand_rot[:, -1, -1]
        parallel1 = torch.sum(
            torch.abs(hand_rot[:, :, 0] * obj_rot[:, :, 0])
            + torch.abs(hand_rot[:, :, 1] * obj_rot[:, :, 1]), dim=-1)
        parallel2 = torch.sum(
            torch.abs(hand_rot[:, :, 0] * obj_rot[:, :, 1])
            + torch.abs(hand_rot[:, :, 1] * obj_rot[:, :, 0]), dim=-1)
        rot_reward = down + torch.maximum(parallel1, parallel2) - 3.0

        obj_to_goal = torch.linalg.norm(obj_pos - self._goal_t[None], dim=-1)
        reaching_goal = torch.clamp(0.2 - obj_to_goal, min=0.0) * is_reached

        rew = reaching + 0.5 * rot_reward + 5.0 * close_reward + 20.0 * reaching_goal
        success = (obj_to_goal <= GOAL_THRESH) & is_reached
        rew = rew + 3.0 * success

        extras = {
            "reaching_reward": reaching,
            "close_reward": close_reward,
            "rot_reward": rot_reward,
            "is_reached": is_reached,
            "reaching_goal_reward": reaching_goal,
            "obj_movement": torch.linalg.norm(
                obj_pos - self._obj_default_pos_t, dim=-1),
            "raw_reward": rew,
            "obj_height": obj_pos[:, 2],
            "obj_up_flag": obj_pos[:, 2] > 0.1,
            "step_id": state.progress.float(),
        }
        return rew, success, extras

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
        state, final_targets, pre_extras = base.pre_physics(
            state, targets, default_targets, self._reset_sim_fn,
            self.explore_step, self.max_episode_length, train,
            force_reset=force_reset, mesh=self.mesh)

        sim = base.run_physics(self.scene, state.sim, final_targets,
                               self.control_freq_inv, self.mesh)
        state = state._replace(sim=sim, progress=state.progress + 1)

        obs, view = self._observations(state)
        obs = self._vision_obs(state, obs)
        rew, success, extras = self._reward(state, view, actions)
        extras.update(pre_extras)
        state = state._replace(rew_buf=rew, success=success)
        return state, obs, rew, state.reset_buf, extras
