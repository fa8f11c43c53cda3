"""Scripted grasp-and-lift diagnostic for grasp_cube (PyTorch).

Counterpart of ``scripts/diag_cube.py``: drives the ik control mode with a
hand-written state machine (reach above the cube -> straddle descend ->
pinch -> lift to (0, 0, 0.2)).  If it cannot succeed, the problem is
physics / control; if it can, it is observation / reward / RL.  Every
physics step runs kernel B1a on the card.

Run: python scripts/diag_torch_cube.py [--envs 4] [--random] [--steps 200]
     [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


@torch.no_grad()
def run_scripted_grasp(env, state, steps: int = 200, verbose: bool = True):
    """Drive the reach / straddle / pinch / lift state machine of
    ``scripts/diag_cube.py``.  Returns (ever_succeeded [E] bool, final
    EnvState)."""
    import partmanip_tpu_torch.ops.rotations as rot
    dev = env.device
    E = state.progress.shape[0]
    phase = np.zeros(E, np.int32)  # 0 hover, 1 descend, 2 close, 3 lift
    close_timer = np.zeros(E, np.int32)
    grasp_pt = np.zeros((E, 3), np.float32)
    ever_succ = np.zeros(E, bool)
    # the lowest finger-pad sphere centres sit 7.5 mm below the tip
    # midpoint; the pads straddle the cube with 15 mm clearance a side
    STRADDLE_DZ = +0.0025
    # hold the reset orientation: hand down, fingers opening along y
    gq = torch.tensor([[0.0, 1.0, 0.0, 0.0]], device=dev)

    for t in range(steps):
        view, _ = env._robot_view(state.sim)
        tip = view.tip_pos.cpu().numpy()
        tipq = view.tip_state[:, 3:7]
        gl = view.gripper_length.cpu().numpy()
        objp = state.sim.body.pos.cpu().numpy()

        act = np.zeros((E, env.num_actions), np.float32)
        oerr = rot.orientation_error(gq, tipq).cpu().numpy()
        for e in range(E):
            if phase[e] == 0:
                tgt = objp[e] + np.array([0, 0, 0.10])
                if np.linalg.norm(tip[e] - tgt) < 0.015:
                    phase[e] = 1
            elif phase[e] == 1:
                tgt = objp[e] + np.array([0, 0, STRADDLE_DZ])
                xy_err = np.linalg.norm(tip[e][:2] - objp[e][:2])
                if xy_err < 0.008 and tip[e][2] - tgt[2] < 0.01:
                    phase[e] = 2
                    grasp_pt[e] = tgt
            elif phase[e] == 2:
                # hold still while pinching; once settled, re-centre once on
                # the cube's height
                if close_timer[e] == 20:
                    grasp_pt[e][2] = objp[e][2] + STRADDLE_DZ
                tgt = grasp_pt[e]
                close_timer[e] += 1
                if close_timer[e] > 30:
                    phase[e] = 3
            else:
                tgt = np.array([0, 0, 0.2075])
            err = tgt - tip[e]
            act[e, :3] = np.clip(err / 0.005, -1, 1)
            if phase[e] in (1, 2):
                act[e, 2] = np.clip(act[e, 2], -0.5, 0.5)
            elif phase[e] == 3:
                act[e, 2] = np.clip(act[e, 2], -0.8, 0.8)
            act[e, 3:6] = np.clip(oerr[e] / 0.005, -1, 1)
            act[e, 6] = 1.0 if phase[e] < 2 else -0.4
        state, obs, rew, reset, extras = env.step(
            state, torch.as_tensor(act, device=dev), train=False)
        succ = state.success.cpu().numpy()
        ever_succ |= succ
        if verbose and (t % 20 == 0 or t == steps - 1):
            d = np.linalg.norm(tip - objp, axis=-1)
            print(f"t={t:3d} phase={phase.tolist()} "
                  f"tcp_to_obj={np.round(d, 4).tolist()} "
                  f"gl={np.round(gl, 4).tolist()} "
                  f"objz={np.round(objp[:, 2], 4).tolist()} "
                  f"reached={extras['is_reached'].cpu().numpy().tolist()} "
                  f"succ={succ.tolist()}")
    return ever_succ, state


def main(argv=None):
    """Returns (ever_succeeded [E], final cube positions [E, 3])."""
    from partmanip_tpu_torch.config import process_cfgs
    from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv

    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4)
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, sim_params = process_cfgs([
        "--taskcfg", "grasp_cube", "--algocfg", "ppo",
        "--algo.num_envs", str(args.envs)])
    tcfg = cfg["task"]
    tcfg["random_reset"] = bool(args.random)
    env = GraspCubeEnv(tcfg, sim_params, device=args.device)
    state = env.init_state(env.make_generator(0))
    state, _ = env.reset(state)

    succ, state = run_scripted_grasp(env, state, args.steps)
    final = state.sim.body.pos.cpu().numpy()
    print("ever success:", succ.tolist())
    print("final obj pos:", np.round(final, 4).tolist())
    return succ, final


if __name__ == "__main__":
    main()
