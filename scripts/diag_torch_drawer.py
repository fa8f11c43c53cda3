"""Scripted grasp-and-pull diagnostic for open_drawer (PyTorch).

Counterpart of ``scripts/diag_drawer.py``: drives the ik control mode with a
hand-written state machine (pre-grasp in front of the handle -> approach ->
close -> pull along the opening axis).  If it cannot reach open_frac ~1,
the ceiling is physics / control (drive strength, anchor stiction); if it
can, the expert's plateau is an RL / asset-difficulty issue.  Every physics
step runs kernel B1b on the card.

Run: python scripts/diag_torch_drawer.py [--envs 4] [--steps 220]
     [--probe [--probe_orn]] [--fric F] [--damp D] [--device cpu]
"""
import argparse
import os
import random as pyrandom
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


@torch.no_grad()
def main(argv=None):
    """Returns (final success [E], final open fraction [E]); with
    ``--probe``, the tip motion of each leg."""
    import partmanip_tpu_torch.ops.rotations as rot
    from partmanip_tpu_torch.config import process_cfgs
    from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv

    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=220)
    ap.add_argument("--asset_root", default="assets")
    ap.add_argument("--probe", action="store_true",
                    help="open-loop tracking probe: command pure-axis tip "
                         "deltas (no orientation servo) and report achieved "
                         "vs commanded motion per 20-step leg")
    ap.add_argument("--probe_orn", action="store_true",
                    help="probe legs also command the grasp orientation")
    ap.add_argument("--fric", type=float, default=None,
                    help="override ALL object joint friction (the env "
                         "fixes 5.0 for every drawer dof)")
    ap.add_argument("--damp", type=float, default=None,
                    help="override ALL object joint damping (the env: 20)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    pyrandom.seed(0)          # the env's cabinet shuffle
    np.random.seed(0)
    cfg, sim_params = process_cfgs([
        "--taskcfg", "open_drawer", "--algocfg", "ppo",
        "--algo.num_envs", str(args.envs),
        "--task.asset.assetRoot", args.asset_root])
    tcfg = cfg["task"]
    tcfg["random_reset"] = False
    env = OpenDrawerEnv(tcfg, sim_params, device=args.device)
    dev = env.device
    if args.fric is not None or args.damp is not None:
        ot = env.scene.obj_tree
        if args.fric is not None:
            ot = ot._replace(dof_friction=torch.full_like(ot.dof_friction, args.fric))
        if args.damp is not None:
            ot = ot._replace(dof_damping=torch.full_like(ot.dof_damping, args.damp))
        env.scene = env.scene._replace(obj_tree=ot)
        print(f"override obj dof friction={args.fric} damping={args.damp}")

    state = env.init_state(env.make_generator(0))
    state, obs = env.reset(state)

    def views(state):
        view, _ = env._robot_view(state.sim)
        return view

    E = args.envs
    bbox = np.asarray(env.part_bbox_init)            # [E, 8, 3] local
    ext = bbox.max(axis=1) - bbox.min(axis=1)        # [E, 3]
    bar_vertical = ext[:, 2] > ext[:, 1]
    tgt_dof = np.asarray(env.target_dof)
    upper = np.asarray(env.joint_upper)
    axis_local = torch.as_tensor(np.asarray(env.part_axis_dir, np.float32), device=dev)

    def handle_world(sim):
        # handle centre and opening direction in the world frame, through
        # the env's own FK (_part_bbox applies the root pose)
        pb = env._part_bbox(sim)
        mid = 0.5 * (pb.min(dim=1).values + pb.max(dim=1).values)
        R = rot.quat_to_mat(sim.obj.root_quat)
        ax = torch.einsum("eab,eb->ea", R, axis_local)
        return mid.cpu().numpy(), ax.cpu().numpy().astype(np.float64)

    # grasp orientation (the reward's alignment terms): hand z (approach)
    # = world -x; hand y (finger separation) along the bar's short axis:
    # world z for a horizontal bar, world y for a vertical one
    q_h = rot.mat_to_quat(torch.tensor(
        [[0, 0, -1], [-1, 0, 0], [0, 1, 0]], dtype=torch.float32)[None])[0].numpy()
    q_v = rot.mat_to_quat(torch.tensor(
        [[0, 0, -1], [0, 1, 0], [1, 0, 0]], dtype=torch.float32)[None])[0].numpy()
    grasp_q = np.where(bar_vertical[:, None], q_v[None], q_h[None]).astype(np.float32)
    grasp_q_t = torch.as_tensor(grasp_q, device=dev)

    # mobile franka: actions are [base(3), dpos(3), dorn(3), grip]
    off = 3 if env.ctrl.mobile else 0

    def arm_speed(view):
        qv = view.qvel.cpu().numpy()
        return np.abs(qv[:, 3:-2] if off else qv[:, :-2]).max(axis=1)

    def step(state, act):
        return env.step(state, torch.as_tensor(act, device=dev), train=False)

    if args.probe:
        # six 20-step legs (+x -x +y -y +z -z), each a saturated pure-axis
        # delta of 0.005 m a step: perfect tracking moves the tip 0.1 m
        legs = [(0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1)]
        moves = []
        for ax, sgn in legs:
            start = views(state).tip_pos.cpu().numpy()
            for t in range(20):
                view = views(state)
                act = np.zeros((E, env.num_actions), np.float32)
                act[:, off + ax] = sgn
                if args.probe_orn:
                    oerr = rot.orientation_error(grasp_q_t, view.tip_state[:, 3:7])
                    act[:, off + 3:off + 6] = np.clip(oerr.cpu().numpy() / 0.005, -1, 1)
                state, obs, rew, reset, extras = step(state, act)
            view = views(state)
            moved = view.tip_pos.cpu().numpy() - start
            want = np.zeros(3)
            want[ax] = sgn * 20 * 0.005
            moves.append(moved)
            print(f"leg axis={'xyz'[ax]}{'+' if sgn > 0 else '-'} "
                  f"want={np.round(want, 3).tolist()} "
                  f"moved0={np.round(moved[0], 3).tolist()} "
                  f"moved1={np.round(moved[1], 3).tolist()} "
                  f"arm_spd={np.round(arm_speed(view), 2).tolist()}")
        return moves

    print("handle ext (out,long,short ~ x,?,?):", np.round(ext, 3).tolist())
    print("bar_vertical:", bar_vertical.tolist(),
          "travel:", np.round(upper, 3).tolist())

    phase = np.zeros(E, np.int32)  # 0 pre, 1 approach, 2 close, 3 pull
    close_timer = np.zeros(E, np.int32)
    appr_timer = np.zeros(E, np.int32)
    of = np.zeros(E)
    for t in range(args.steps):
        view = views(state)
        tip = view.tip_pos.cpu().numpy()
        gl = view.gripper_length.cpu().numpy()
        q = state.sim.obj.qpos.cpu().numpy()[np.arange(E), tgt_dof]
        handle, axis_dir = handle_world(state.sim)
        oerr = rot.orientation_error(grasp_q_t, view.tip_state[:, 3:7]).cpu().numpy()

        act = np.zeros((E, env.num_actions), np.float32)
        for e in range(E):
            if phase[e] == 0:
                tgt = handle[e] + 0.12 * axis_dir[e]
                if np.linalg.norm(tip[e] - tgt) < 0.015:
                    phase[e] = 1
            elif phase[e] == 1:
                tgt = handle[e]
                appr_timer[e] += 1
                # close when centred, or when jammed close enough that a
                # squeeze would still catch the bar
                if (np.linalg.norm(tip[e] - tgt) < 0.008
                        or (appr_timer[e] > 60
                            and np.linalg.norm(tip[e] - tgt) < 0.025)):
                    phase[e] = 2
            elif phase[e] == 2:
                tgt = handle[e]
                close_timer[e] += 1
                if close_timer[e] > 40:
                    phase[e] = 3
            else:
                tgt = handle[e] + 0.08 * axis_dir[e]  # keep leading the pull
            err = tgt - tip[e]
            act[e, off:off + 3] = np.clip(err / 0.005, -1, 1)
            if off:
                # walk the mobile base toward the work too: the commanded
                # action is the world-frame delta, split between base and
                # arm by the controller
                act[e, :3] = np.clip(err / 0.005, -1, 1)
            act[e, off + 3:off + 6] = np.clip(oerr[e] / 0.005, -1, 1)
            act[e, off + 6] = 1.0 if phase[e] < 2 else -1.0
        state, obs, rew, reset, extras = step(state, act)
        if t % 20 == 0 or t == args.steps - 1:
            d = np.linalg.norm(tip - handle, axis=-1)
            of = q / np.maximum(upper, 1e-6)
            base = view.qpos.cpu().numpy()[:, :3] if off else np.zeros((E, 3))
            print(f"t={t:3d} phase={phase.tolist()} "
                  f"tip_to_handle={np.round(d, 4).tolist()} "
                  f"gl={np.round(gl, 4).tolist()} "
                  f"open_frac={np.round(of, 3).tolist()} "
                  f"arm_spd={np.round(arm_speed(view), 2).tolist()} "
                  f"base={np.round(base, 3).tolist()} "
                  f"grasped={extras['is_grasped'].cpu().numpy().tolist()} "
                  f"succ={state.success.cpu().numpy().tolist()}")
            print(f"      tip0={np.round(tip[0], 3).tolist()} "
                  f"handle0={np.round(handle[0], 3).tolist()} "
                  f"axis0={np.round(axis_dir[0], 2).tolist()} "
                  f"tip1={np.round(tip[1], 3).tolist()} "
                  f"handle1={np.round(handle[1], 3).tolist()}")
    succ = state.success.cpu().numpy()
    print("final success:", succ.tolist())
    return succ, of


if __name__ == "__main__":
    main()
