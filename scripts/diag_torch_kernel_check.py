"""Take apart a ``chip_smoke.py`` ``kernel_check`` case env by env: where
kernel B1b / B1c and its plain version differ, and whether the plain
version itself is continuous there.

For the path's committed cases (the 40-step expert rollout and the
hand-made contact states, 2048 envs) it compares one inner step of the
kernel with the plain version on the card, the plain version on the card
with the plain version on the CPU (the same function, other rounding), and
reports per field how many envs exceed the ``TOL`` table and the worst envs.
At each of the worst envs it probes the plain version's continuity: one
inner step from the state with the robot's joint positions moved by
``delta`` (1e-6 and 1e-7 rad), whose output moves in proportion to delta
where the step is smooth and by a fixed jump where a test flips (effort
saturation, stick / slip, a grid cell or partner change), and lists the
contact tests the move flips: (sphere, box) and (sphere, grid) pairs that
start or stop touching, and grid queries that change trilinear cell.
Prints one JSON line per case.

    python3 scripts/diag_torch_kernel_check.py [--kernel b1c]
"""
import argparse
import json
import os
import shutil
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from partmanip_tpu_torch.sim import engine, fused  # noqa: E402
from partmanip_tpu_torch.utils import convert  # noqa: E402


def fields(st):
    return {"qpos": st.robot.qpos, "qvel": st.robot.qvel, "obj_qpos": st.obj.qpos,
            "obj_qvel": st.obj.qvel, "anchor_point": st.anchors.point}


def per_env(a, b):
    """{field: max abs difference per env [E]} (on the CPU)."""
    fa, fb = fields(a), fields(b)
    return {k: (fa[k].cpu() - fb[k].cpu()).abs().reshape(fa[k].shape[0], -1).max(1).values
            for k in fa}


def contact_decisions(env, sim, e):
    """Env e's discrete contact tests: touching (sphere, box) pairs, and for
    mesh-SDF geoms the touching (sphere, grid) pairs and each live query's
    trilinear cell (as ops/sdf.grid_query_grad indexes it)."""
    from partmanip_tpu_torch.ops import rotations as rot
    from partmanip_tpu_torch.sim import contact, kinematics
    from partmanip_tpu_torch.utils import contact_states
    out = {"box_touch": contact_states.sphere_box_depths(env, sim)[e] < 0}
    gg = env.scene.obj_grids
    if gg is None:
        return out
    depth, active, _ = contact_states._grid_queries(env, sim)
    out["grid_touch"] = active[e] & (depth[e] < 0)
    E, K = sim.robot.qpos.shape[0], gg.link_idx.shape[-1]
    fk = kinematics.forward_kinematics(env.scene.robot, sim.robot)
    centers = contact.sphere_positions(env.scene.robot, fk, env.spheres, E)[e]
    fk_o = kinematics.forward_kinematics(env.scene.obj_tree, sim.obj)
    link = gg.link_idx.expand(E, K)[e]
    gp, gq = rot.transform_compose(fk_o.link_pos[e, link], fk_o.link_quat[e, link],
                                   gg.offset_pos.expand(E, K, 3)[e],
                                   gg.offset_quat.expand(E, K, 4)[e])
    p_loc = rot.quat_rotate_inverse(gq[None].expand(centers.shape[0], K, 4),
                                    centers[:, None] - gp[None])
    st, gid = env.scene.grid_stack, gg.grid_id.expand(E, K)[e].long()
    cell = ((p_loc - st.bbox_min[gid][None]) / st.voxel_size[gid][None, :, None]).floor()
    out["grid_cell"] = torch.where(active[e][..., None], cell, torch.full_like(cell, -1))
    return out


def flipped(a, b):
    """The (sphere, geom) pairs whose contact tests differ between two
    ``contact_decisions``."""
    return {k: torch.nonzero((a[k] != b[k]).reshape(a[k].shape[0], a[k].shape[1], -1)
                             .any(-1)).tolist() for k in a}


def to_cpu(sim):
    return convert.scene_state_from_numpy(convert.scene_state_to_numpy(sim))


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kernel", default="b1c", choices=["b1b", "b1c"])
    ap.add_argument("--worst", type=int, default=4)
    args = ap.parse_args()
    print(chip_smoke.nvidia_smi_line(), flush=True)
    path = next(p for p in chip_smoke.PATHS if p.kernel == args.kernel)
    if path.kernel == "b1c":
        shutil.rmtree(chip_smoke.MESH_ASSETS, ignore_errors=True)
    env, cfg = chip_smoke.make_env(path, chip_smoke.NUM_ENVS)
    cpu_env, _ = chip_smoke.make_env(path, chip_smoke.NUM_ENVS, device="cpu")
    cases = chip_smoke.check_cases(path, env, cfg)
    tol = chip_smoke.TOL
    for name, (sim, targets) in cases.items():
        ker = fused.fused_inner_steps(env.scene, sim, targets, 1)
        ref = engine.plain_physics_step(env.scene, sim, targets, n_steps=1)
        sim_c, tg_c = to_cpu(sim), targets.cpu()
        ref_c = engine.plain_physics_step(cpu_env.scene, sim_c, tg_c, n_steps=1)
        diffs = {"kernel_vs_plain": per_env(ker, ref), "plain_card_vs_cpu": per_env(ref, ref_c),
                 "kernel_vs_plain_cpu": per_env(ker, ref_c)}
        report = {k: {f: {"max": float(e.max()), "envs_over_tol": int((e > tol[f]).sum())}
                      for f, e in d.items()} for k, d in diffs.items()}
        kd = diffs["kernel_vs_plain"]
        score = torch.stack([kd[f] / tol[f] for f in kd]).max(0).values
        worst = torch.argsort(score, descending=True)[:args.worst].tolist()
        probes = {}
        for e in worst:
            row = {"kernel_vs_plain": {f: float(kd[f][e]) for f in kd},
                   "plain_card_vs_cpu": {f: float(diffs["plain_card_vs_cpu"][f][e]) for f in kd},
                   "anchor_ids": [ker.anchors.body[e].tolist(), ref.anchors.body[e].tolist()]}
            here = contact_decisions(env, sim, e)
            for delta in (1e-6, 1e-7):
                moved = sim._replace(robot=sim.robot._replace(qpos=sim.robot.qpos + delta))
                out = engine.plain_physics_step(env.scene, moved, targets, n_steps=1)
                d = per_env(out, ref)
                row[f"plain_moved_{delta:g}"] = {f: float(d[f][e]) for f in d}
                row[f"kernel_vs_plain_moved_{delta:g}"] = {
                    f: float(v[e]) for f, v in per_env(ker, out).items()}
                row[f"tests_flipped_by_{delta:g}"] = flipped(here, contact_decisions(env, moved, e))
            qv_err = (ker.robot.qvel[e] - ref.robot.qvel[e]).abs()
            row["qvel_err_by_dof"] = qv_err.tolist()
            probes[str(e)] = row
        print(json.dumps({"case": name, "kernel": args.kernel, "num_envs": env.num_envs,
                          "tolerances": tol, "report": report, "worst_envs": probes}), flush=True)


if __name__ == "__main__":
    main()
