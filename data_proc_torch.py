"""Data-processing utilities (PyTorch).

Counterpart of ``tools/data_proc.py``, with the same subcommands:

* ``obj2urdf``       — wrap a mesh in a single-link URDF;
* ``check_pose``     — validate logged scene-pose dumps (``--save_pose``):
                       rotations orthonormal, parts inside a sane workspace;
* ``armmask``        — re-render robot segmentation masks for logged
                       episodes with ``ops/raymarch.render_depth_seg`` (a
                       plain march, as the JAX package's, on the GPU unless
                       ``--device cpu``);
* ``filter_success`` — keep only successful episodes in a demo tree;
* ``genbox``         — write a box OBJ.

Usage: python data_proc_torch.py <subcommand> [options]
"""

import argparse
import os
import shutil
from os.path import join as pjoin

import numpy as np


def cmd_obj2urdf(args):
    mesh = os.path.abspath(args.mesh)
    out = args.out or os.path.splitext(mesh)[0] + ".urdf"
    name = os.path.splitext(os.path.basename(mesh))[0]
    rel = os.path.relpath(mesh, os.path.dirname(out))
    with open(out, "w") as f:
        f.write(f"""<?xml version="1.0"?>
<robot name="{name}">
  <link name="{name}">
    <inertial>
      <mass value="{args.mass}"/>
      <inertia ixx="1e-4" iyy="1e-4" izz="1e-4" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <visual><geometry><mesh filename="{rel}" scale="{args.scale} {args.scale} {args.scale}"/></geometry></visual>
    <collision><geometry><mesh filename="{rel}" scale="{args.scale} {args.scale} {args.scale}"/></geometry></collision>
  </link>
</robot>
""")
    print(f"wrote {out}")
    return out


def _dumps(d):
    """The ``.npy`` files of a dump directory, sorted by name (as the JAX
    tool takes them)."""
    return sorted(f for f in os.listdir(d) if f.endswith(".npy"))


def cmd_check_pose(args):
    files = _dumps(args.dir)
    assert files, f"no .npy dumps in {args.dir}"
    for fn in files[:args.limit]:
        d = np.load(pjoin(args.dir, fn), allow_pickle=True).item()
        rot, pos = np.asarray(d["rot"]), np.asarray(d["pos"])
        # orthonormality of every part rotation
        err = np.abs(np.einsum("emab,emcb->emac", rot, rot) - np.eye(3)).max()
        # all parts inside a sane workspace bubble
        r = np.linalg.norm(pos, axis=-1).max()
        print(f"{fn}: parts={pos.shape[1]} ortho_err={err:.2e} max|pos|={r:.3f}")
        assert err < 1e-3, "non-orthonormal rotation in dump"
        assert r < 5.0, "part pose far outside the workspace"
    print("pose dumps OK")


def armmask_prims(pos, device):
    """Each dumped part of one env (``pos`` [M, 3]) as a 6 cm sphere at its
    origin, no box and no ground: enough for silhouette masks of the arm."""
    import torch
    from partmanip_tpu_torch.ops import raymarch
    M = pos.shape[0]
    return raymarch.ScenePrims(
        sphere_center=torch.as_tensor(np.asarray(pos, np.float32), device=device)[None],
        sphere_radius=torch.full((1, M), 0.06, device=device),
        box_pos=torch.zeros((1, 1, 3), device=device),
        box_quat=torch.tensor([[[0.0, 0, 0, 1]]], device=device),
        box_half=torch.zeros((1, 1, 3), device=device),
        box_mask=torch.zeros((1, 1), device=device),
        ground=False)


def cmd_armmask(args):
    import torch
    from partmanip_tpu_torch.envs.base import resolve_device
    from partmanip_tpu_torch.ops import raymarch
    from partmanip_tpu_torch.utils import camera
    device = resolve_device(args.device)
    files = _dumps(args.dir)
    poses = camera.gen_camera_poses([0, 0, 0.2], radius=1.0, num_views=1)
    intr = camera.camera_intrinsics(args.width, args.height)
    os.makedirs(args.out, exist_ok=True)
    for fn in files[:args.limit]:
        d = np.load(pjoin(args.dir, fn), allow_pickle=True).item()
        prims = armmask_prims(np.asarray(d["pos"])[args.env], device)
        with torch.no_grad():
            _, seg = raymarch.render_depth_seg(prims, poses, intr, args.height, args.width)
        mask = (seg[0, 0].cpu().numpy() == 1).astype(np.uint8) * 255
        np.save(pjoin(args.out, fn.replace(".npy", "_mask.npy")), mask)
    print(f"masks → {args.out}")


def cmd_filter_success(args):
    kept = dropped = 0
    for scene in sorted(os.listdir(args.dir)):
        sd = pjoin(args.dir, scene)
        steps = sorted(os.listdir(sd))
        last = np.load(pjoin(sd, steps[-1]), allow_pickle=True).item()
        succ = np.asarray(last.get("success", last.get("obj_up_flag", 0)))
        ok = bool(np.all(succ)) if succ.ndim else bool(succ)
        if not ok:
            if args.apply:
                shutil.rmtree(sd)
            dropped += 1
        else:
            kept += 1
    print(f"kept {kept}, dropped {dropped}"
          + ("" if args.apply else " (dry run; pass --apply)"))
    return kept, dropped


def cmd_genbox(args):
    from partmanip_tpu_torch.envs.assets import _write_cube_obj
    _write_cube_obj(args.out, args.half)
    print(f"wrote {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("obj2urdf")
    p.add_argument("mesh")
    p.add_argument("--out")
    p.add_argument("--mass", type=float, default=0.1)
    p.add_argument("--scale", type=float, default=1.0)
    p.set_defaults(fn=cmd_obj2urdf)

    p = sub.add_parser("check_pose")
    p.add_argument("dir")
    p.add_argument("--limit", type=int, default=10)
    p.set_defaults(fn=cmd_check_pose)

    p = sub.add_parser("armmask")
    p.add_argument("dir")
    p.add_argument("--out", default="./armmasks")
    p.add_argument("--env", type=int, default=0)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=180)
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_armmask)

    p = sub.add_parser("filter_success")
    p.add_argument("dir")
    p.add_argument("--apply", action="store_true")
    p.set_defaults(fn=cmd_filter_success)

    p = sub.add_parser("genbox")
    p.add_argument("--out", default="box.obj")
    p.add_argument("--half", type=float, default=0.025)
    p.set_defaults(fn=cmd_genbox)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
