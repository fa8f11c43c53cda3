"""Contact-energy poke test for the grasp_cube scene (PyTorch).

Counterpart of ``scripts/poke_cube.py``: drives the tip down beside the cube
then laterally through its position at policy speed (saturated 5 mm/step
actions) and reports how far the cube is displaced and how high it bounces.
A 125 g cube pushed at ~0.3 m/s by a finger should slide a few cm and stay
on the ground.  Every physics step runs kernel B1a on the card.

Run: python scripts/poke_torch_cube.py [--envs 1] [--steps 160] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


@torch.no_grad()
def main(argv=None):
    """Returns (max xy displacement, max z) of env 0's cube."""
    import partmanip_tpu_torch.ops.rotations as rot
    from partmanip_tpu_torch.config import process_cfgs
    from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv

    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, sim_params = process_cfgs([
        "--taskcfg", "grasp_cube", "--algocfg", "ppo",
        "--algo.num_envs", str(args.envs)])
    tcfg = cfg["task"]
    tcfg["random_reset"] = False          # cube at (0, 0, 0.025)
    env = GraspCubeEnv(tcfg, sim_params, device=args.device)
    dev = env.device
    state = env.init_state(env.make_generator(0))
    state, obs = env.reset(state)

    E = args.envs
    gq = torch.tensor([[-0.5, 0.5, 0.5, -0.5]], device=dev)
    max_disp = 0.0
    max_z = 0.0
    for t in range(args.steps):
        view, _ = env._robot_view(state.sim)
        tip = view.tip_pos.cpu().numpy()
        tipq = view.tip_state[:, 3:7]
        objp = state.sim.body.pos.cpu().numpy()
        objv = state.sim.body.linvel.cpu().numpy()

        # 0: hover above a point 5.5 cm beside the cube; 1: descend to
        # fingertip height beside it; 2: sweep through the cube position
        if t < 70:
            tgt = np.array([0.0, -0.055, 0.14], np.float32)
        elif t < 110:
            tgt = np.array([0.0, -0.055, 0.055], np.float32)
        else:
            tgt = np.array([0.0, 0.10, 0.055], np.float32)

        act = np.zeros((E, env.num_actions), np.float32)
        oerr = rot.orientation_error(gq, tipq).cpu().numpy()
        for e in range(E):
            err = tgt - tip[e]
            act[e, :3] = np.clip(err / 0.005, -1, 1)
            act[e, 3:6] = np.clip(oerr[e] / 0.005, -1, 1)
            act[e, 6] = -1.0   # fingers closed: poke with a fingertip
        state, obs, rew, reset, extras = env.step(
            state, torch.as_tensor(act, device=dev), train=False)

        disp = float(np.linalg.norm(objp[0, :2]))
        max_disp = max(max_disp, disp)
        max_z = max(max_z, float(objp[0, 2]))
        if t % 10 == 0 or 58 <= t <= 100:
            print(f"t={t:3d} tip={np.round(tip[0], 3).tolist()} "
                  f"obj={np.round(objp[0], 4).tolist()} "
                  f"|objv|={float(np.linalg.norm(objv[0])):.3f}")
    print(f"RESULT max_xy_disp={max_disp:.4f} m  max_z={max_z:.4f} m "
          f"(rest z 0.025; PhysX-like expectation: disp < ~0.08, z < ~0.035)")
    return max_disp, max_z


if __name__ == "__main__":
    main()
