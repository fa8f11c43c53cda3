"""Controller calibration harness (PyTorch).

Counterpart of ``tools/tune_pid.py``: drives the mobile Franka alone on the
ground (no object: the scene kernel B1d runs on the card) with ik-mode
actions and reports achieved- vs commanded tip / base / gripper deltas over
``control_freq_inv`` physics steps, the check of the PD gain table and the
0.005 action scale against the simulator.  Its expected readings are
``docs/CALIBRATION.md``'s.

Usage:
    python tune_pid_torch.py [--envs 10] [--steps 20]   # random commands
    python tune_pid_torch.py --envs 4 --const            # steady state

Runs on the GPU; ``--device cpu`` runs the plain PyTorch path on the CPU.
Prints the same lines as the JAX tool.
"""

import argparse

import numpy as np
import torch

# the tune-pid start configuration of the mobile Franka (12 dofs)
Q0 = np.array([0, 0, 0, -0.2724, -0.1511, 0.2898, -2.3792, -2.8973,
               2.4690, 2.3973, 0.04, 0.04], np.float32)


def build(envs: int, device):
    """(scene, start state, control config) of the calibration scene: the
    mobile Franka and its collision spheres, ``coriolis=False``,
    ``inner_substeps=2``, as the JAX tool builds them."""
    from partmanip_tpu_torch.envs import control
    from partmanip_tpu_torch.sim import engine, franka
    from partmanip_tpu_torch.sim.types import SimParams, TreeState, to_device
    built = franka.build_franka(mobile=True)
    spheres = franka.franka_collision_spheres(built)
    bi = franka.franka_body_indices(built)
    params = SimParams(coriolis=False, inner_substeps=2)
    scene = engine.SceneSpec(robot=to_device(built.spec, device),
                             spheres=to_device(spheres, device), params=params)
    state = engine.SceneState(robot=TreeState(
        qpos=torch.as_tensor(Q0, device=device).repeat(envs, 1),
        qvel=torch.zeros((envs, 12), device=device),
        root_pos=torch.zeros((envs, 3), device=device),
        root_quat=torch.tensor([0.0, 0, 0, 1], device=device).repeat(envs, 1)))
    cfg = control.FrankaControlConfig(
        drive_mode="ik", mobile=True, dt=params.dt, num_dofs=12,
        lefttip_idx=bi["lefttip"], righttip_idx=bi["righttip"])
    return scene, state, cfg


@torch.no_grad()
def step(scene, cfg, state, action, cfi):
    """One control step: targets from the ik action, ``cfi`` physics steps;
    returns (state', view before, view after)."""
    from partmanip_tpu_torch.envs import control
    from partmanip_tpu_torch.sim import engine, kinematics
    fk = kinematics.forward_kinematics(scene.robot, state.robot)
    view = control.robot_view(cfg, scene.robot, fk, state.robot)
    tgt = control.compute_targets(cfg, scene.robot, view, action)
    new = state
    for _ in range(cfi):
        new = engine.physics_step(scene, new, tgt)
    fk2 = kinematics.forward_kinematics(scene.robot, new.robot)
    view2 = control.robot_view(cfg, scene.robot, fk2, new.robot)
    return new, view, view2


def steady_state(scene, cfg, state, cfi):
    """One channel at a time (base x = a0, tip x = a3, gripper = a9, the
    gripper commanded closed from fully open), 10 control steps of a
    constant unit command each; per channel the mean achieved delta of
    steps 4-10, its ratio to the commanded delta and the first step's."""
    E = state.robot.qpos.shape[0]
    dev = state.robot.qpos.device
    chans = {"base_x": (0, 1.0, 0.005), "tip_x": (3, 1.0, 0.005),
             "grip": (9, -1.0, -2 * scene.params.dt / 5)}
    out = {}
    for name, (ci, sign, scale) in chans.items():
        st = state
        a = torch.zeros((E, 10), device=dev)
        a[:, ci] = sign
        deltas = []
        for _ in range(10):
            st, v0, v1 = step(scene, cfg, st, a, cfi)
            if name == "base_x":
                d = (v1.qpos[:, 0] - v0.qpos[:, 0]).mean()
            elif name == "tip_x":
                d = (v1.tip_pos[:, 0] - v0.tip_pos[:, 0]).mean()
            else:
                d = (v1.gripper_length - v0.gripper_length).mean()
            deltas.append(float(d))
        ss = float(np.mean(deltas[3:]))
        out[name] = {"commanded": scale, "achieved": ss, "ratio": ss / scale,
                     "first_step": deltas[0]}
        print(f"{name}: commanded {scale:+.5f}/ctrl-step, "
              f"achieved {ss:+.5f} (ratio {ss / scale:.3f}), "
              f"first-step {deltas[0]:+.5f}")
    return out


def transients(scene, cfg, state, cfi, steps):
    """Random ik commands (numpy seed 0): per step the mean relative error of
    the achieved tip / base / gripper delta against the commanded one."""
    E = state.robot.qpos.shape[0]
    dev = state.robot.qpos.device
    rng = np.random.RandomState(0)
    errs = {"tip": [], "base": [], "grip": []}
    n = lambda x: np.linalg.norm(x, axis=-1)
    cpu = lambda x: x.cpu().numpy()
    for i in range(steps):
        a_np = rng.uniform(-1, 1, (E, 10)).astype(np.float32)
        state, v0, v1 = step(scene, cfg, state, torch.as_tensor(a_np, device=dev), cfi)
        tip0, tip1 = cpu(v0.tip_pos), cpu(v1.tip_pos)
        base0, base1 = cpu(v0.qpos[:, :3]), cpu(v1.qpos[:, :3])
        grip0, grip1 = cpu(v0.gripper_length), cpu(v1.gripper_length)
        tgt_tip = tip0 + a_np[:, 3:6] * 0.005
        tgt_base = base0 + a_np[:, :3] * 0.005            # identity root
        tgt_grip = grip0 + 2 * a_np[:, -1] * scene.params.dt / 5
        errs["tip"].append(np.mean(n(tip1 - tgt_tip)
                                   / np.maximum(n(tgt_tip - tip0), 1e-9)))
        errs["base"].append(np.mean(n(base1 - tgt_base)
                                    / np.maximum(n(tgt_base - base0), 1e-9)))
        errs["grip"].append(np.mean(np.abs(grip1 - tgt_grip)
                                    / np.maximum(np.abs(tgt_grip - grip0), 1e-9)))
        print(f"step {i}: rel-err tip={errs['tip'][-1]:.3f} "
              f"base={errs['base'][-1]:.3f} grip={errs['grip'][-1]:.3f}")
    print("\nmean relative error (achieved vs commanded delta):")
    for k, v in errs.items():
        print(f"  {k}: {np.mean(v):.3f}")
    return {k: float(np.mean(v)) for k, v in errs.items()}


def main(argv=None):
    """Run the harness; returns the steady-state table (``--const``) or
    the mean relative errors."""
    from partmanip_tpu_torch.envs.base import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cfi", type=int, default=2)
    ap.add_argument("--const", action="store_true",
                    help="steady-state mode: hold one constant unit command "
                         "per channel and report achieved delta per control "
                         "step vs commanded (tracking-bandwidth view; the "
                         "default random mode measures transients)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    scene, state, cfg = build(args.envs, device)
    if args.const:
        return steady_state(scene, cfg, state, args.cfi)
    return transients(scene, cfg, state, args.cfi, args.steps)


if __name__ == "__main__":
    main()
