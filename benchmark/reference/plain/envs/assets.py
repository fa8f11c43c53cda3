"""Asset pipeline: URDF parsing + procedural GAPartNet-style cabinets.

Counterpart of ``partmanip_tpu/envs/assets.py`` (numpy only).  Cabinet
assets are laid out as ``objs/drawer/{split}/{assetid-linkname-handlename-
jointname-*}/`` with a ``mobility_new.urdf`` and a ``bbox_info.json``
carrying the handle's 8-corner bbox and the joint axis.  This module both

* **parses** that layout (URDF with box/mesh collision geoms + bbox_info) and
* **generates** procedural cabinet variants in the same layout.

The generator writes the same bytes as the JAX package's, under the same
version stamp and ``.generated`` marker, so both packages share one cache
under ``<assetRoot>/objs/drawer/<split>`` without wiping each other's.
Mesh collision geoms are baked to SDF grids (:func:`mesh_sdf_cached`,
cached next to the mesh) and collided by the engine's grid branch (kernel
B1c on the GPU).

bbox corner convention: ``out = b0−b4``, ``long = b1−b0``, ``short = b3−b0``,
``mid = (b0+b6)/2`` — corners in ±(out, long, short) binary order, front
face first.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import xml.etree.ElementTree as ET
from os.path import join as pjoin
from typing import List, Optional, Tuple

import numpy as np

from ..sim.builder import BuiltTree, LinkDef, _rpy_to_quat, build_tree
from ..sim.types import JOINT_FIXED, JOINT_PRISMATIC, JOINT_REVOLUTE


@dataclasses.dataclass
class BoxDef:
    link: str
    size: Tuple[float, float, float]       # full extents
    origin_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    origin_rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    friction: float = 1.0


@dataclasses.dataclass
class MeshDef:
    """A mesh collision geom (real GAPartNet assets; collided via baked SDF
    grids, ≙ PhysX SDF-mode ``<sdf resolution>`` collision)."""

    link: str
    filename: str                          # resolved absolute path
    origin_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    origin_rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    friction: float = 1.0


def load_obj_mesh(path: str):
    """Minimal wavefront .obj reader → (vertices [V, 3], faces [F, 3]).
    Polygon faces are fan-triangulated; v/vt/vn indices resolved to v."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def mesh_sdf_cached(path: str, scale: np.ndarray, voxel_size: float = None,
                    device="cpu"):
    """Baked SDF grid of a (scaled) mesh, cached next to it as .npy under
    the JAX package's file name and dict layout ({'sdf', 'bbox_min',
    'voxel_size'}), so either package reads the other's bake.  A missing
    cache is baked on ``device``."""
    from ..ops import sdf as sdf_ops
    scale = np.asarray(scale, np.float32).reshape(-1)
    if scale.size == 1:
        scale = np.repeat(scale, 3)
    verts, faces = load_obj_mesh(path)
    verts = verts * scale[None]
    extent = float((verts.max(0) - verts.min(0)).max())
    if voxel_size is None:
        voxel_size = float(np.clip(extent / 48.0, 0.003, 0.02))
    tag = f".sdf_s{scale[0]:g}_{scale[1]:g}_{scale[2]:g}_v{voxel_size:g}.npy"
    cache = path + tag
    if os.path.exists(cache):
        return np.load(cache, allow_pickle=True).item()
    grid = sdf_ops.bake_mesh_sdf(verts, faces, voxel_size=voxel_size,
                                 trunc=6.0 * voxel_size, device=device)
    np.save(cache, grid)
    return grid


# ---------------------------------------------------------------------------
# Procedural cabinet generation
# ---------------------------------------------------------------------------

def _handle_bbox_corners(center, out_h, long_h, short_h):
    """8 corners in the GAPartNet order described in the module docstring."""
    c = np.asarray(center, np.float64)
    O, L, S = (np.asarray(v, np.float64) for v in (out_h, long_h, short_h))
    signs = [(+1, -1, -1), (+1, +1, -1), (+1, +1, +1), (+1, -1, +1),
             (-1, -1, -1), (-1, +1, -1), (-1, +1, +1), (-1, -1, +1)]
    return np.stack([c + so * O + sl * L + ss * S for so, sl, ss in signs])


def generate_drawer_asset(out_dir: str, split: str, idx: int,
                          mesh_handle: bool = False) -> str:
    """Write one procedural cabinet with a prismatic target drawer.

    Deterministic per (split, idx).  ``valInter`` draws from a shifted size /
    handle distribution (cross-category generalization split); ``valIntra``
    uses the train distribution with held-out seeds.

    ``mesh_handle`` emits the handle bars as **mesh** collision geoms
    (.obj files referenced from the URDF) instead of boxes — the layout of
    real GAPartNet assets, collided via baked SDF grids.

    Returns the created asset directory path.
    """
    import zlib
    base = "valInter" if split == "valInter" else "train"
    seed = zlib.crc32(f"{base}-{idx}".encode()) % (2 ** 31)
    rng = np.random.RandomState(seed + (10_000 if split == "valIntra" else 0))

    if split == "valInter":
        W = rng.uniform(1.0, 1.4)     # cabinet width  (y, local)
        H = rng.uniform(1.1, 1.5)     # height (z)
        Dp = rng.uniform(0.7, 0.9)    # depth (x)
        handle_vertical = rng.rand() < 0.5
    else:
        # train/valIntra distribution widened toward the valInter family
        # (cross-category generalization needs train-side diversity)
        W = rng.uniform(0.7, 1.25)
        H = rng.uniform(0.8, 1.3)
        Dp = rng.uniform(0.5, 0.8)
        handle_vertical = rng.rand() < 0.35

    t = 0.04                          # panel thickness
    n_drawers = rng.randint(2, 4) if split == "valInter" \
        else rng.randint(2, 5)
    target = rng.randint(0, n_drawers)
    slot_h = (H - t * (n_drawers + 1)) / n_drawers
    z0_off = -H / 2.0  # origin at the vertical center (GAPartNet convention)

    # Local frame: front face at x = -Dp/2 (cabinet faces its −x; the task
    # root quat (0,0,1,0) then turns the front toward the +x world robot,
    # cfg/tasks/open_drawer.yaml robot root [0.4,0,0, 0,0,1,0]).
    front_x = -Dp / 2.0
    links: List[dict] = []
    boxes: List[BoxDef] = []
    mesh_geoms: List[tuple] = []   # (link, filename, full size, origin)
    links.append({"name": "base_link", "parent": None, "joint": None})
    # frame: bottom, top, left, right, back
    for nm, size, pos in [
        ("bottom", (Dp, W, t), (0, 0, z0_off + t / 2)),
        ("top", (Dp, W, t), (0, 0, z0_off + H - t / 2)),
        ("left", (Dp, t, H), (0, -(W - t) / 2, z0_off + H / 2)),
        ("right", (Dp, t, H), (0, (W - t) / 2, z0_off + H / 2)),
        ("back", (t, W, H), ((Dp - t) / 2, 0, z0_off + H / 2)),
    ]:
        boxes.append(BoxDef("base_link", size, pos))

    drawer_w = W - 2 * t
    bbox_info = {"link_name": [], "bbox_world": [], "axis_xyz_world": [],
                 "axis_dir_world": []}
    handle_name = None
    link_name = None
    joint_name = None

    for d in range(n_drawers):
        z0 = z0_off + t + d * (slot_h + t)
        zc = z0 + slot_h / 2
        nm = f"link_{d}"
        jn = f"joint_{d}"
        is_target = d == target
        travel = Dp * rng.uniform(0.55, 0.75)
        links.append({
            "name": nm, "parent": "base_link",
            # EVERY drawer joint is simulated (the reference sets DOF props
            # for all object dofs, open_drawer.py:162-167; only the target
            # dof feeds reward/obs)
            "joint": {
                "name": jn,
                "type": "prismatic",
                "axis": (-1.0, 0.0, 0.0),
                "origin": (0.0, 0.0, 0.0),
                "lower": 0.0, "upper": travel,
                # per-asset joint property randomization (≙ varied
                # real-asset dynamics; train-side domain randomization)
                "damping": float(rng.uniform(12.0, 28.0)),
                "friction": float(rng.uniform(3.0, 8.0)),
            },
        })
        # drawer front panel
        boxes.append(BoxDef(nm, (t, drawer_w, slot_h),
                            (front_x + t / 2, 0, zc)))
        # shallow tray behind the panel (mass + believable geometry)
        boxes.append(BoxDef(nm, (Dp * 0.6, drawer_w * 0.9, t),
                            (front_x + Dp * 0.35, 0, z0 + t)))

        # handle: a bar standing off the front panel
        if split == "valInter":
            hl = rng.uniform(0.12, 0.22)        # half length of the bar
            hs = rng.uniform(0.012, 0.02)       # half thickness
            gap = rng.uniform(0.035, 0.05)      # standoff from panel
        else:
            hl = rng.uniform(0.10, 0.25)
            hs = rng.uniform(0.010, 0.022)
            gap = rng.uniform(0.030, 0.055)
        ho = 0.014                              # half depth of the bar (out)
        hx = front_x - gap - ho                 # bar center x
        hnm = f"handle_{d}"
        links.append({
            "name": hnm, "parent": nm,
            "joint": {"name": f"handle_joint_{d}", "type": "fixed",
                      "axis": (0, 0, 1), "origin": (0, 0, 0),
                      "lower": 0, "upper": 0, "damping": 0, "friction": 0},
        })
        if handle_vertical:
            hsize = (2 * ho, 2 * hs, 2 * hl)
            long_h = np.array([0, 0, hl])
            short_h = np.array([0, hs, 0])
        else:
            hsize = (2 * ho, 2 * hl, 2 * hs)
            long_h = np.array([0, hl, 0])
            short_h = np.array([0, 0, hs])
        if mesh_handle:
            mesh_geoms.append((hnm, f"handle_{d}.obj", hsize, (hx, 0, zc)))
        else:
            boxes.append(BoxDef(hnm, hsize, (hx, 0, zc)))
        # stand-off posts connecting bar to panel
        post = (gap, 0.02, 0.02)
        for sgn in (-1, 1):
            off = sgn * (hl - 0.02) * (long_h / np.linalg.norm(long_h))
            boxes.append(BoxDef(hnm, post,
                                (front_x - gap / 2, off[1], zc + off[2])))

        out_h = np.array([-ho, 0, 0])  # out = local −x (toward the front)
        corners = _handle_bbox_corners((hx, 0, zc), out_h, long_h, short_h)
        bbox_info["link_name"].extend([nm, hnm])
        bbox_info["bbox_world"].extend([
            _handle_bbox_corners(
                (front_x + t / 2, 0, zc), np.array([-t / 2, 0, 0]),
                np.array([0, drawer_w / 2, 0]), np.array([0, 0, slot_h / 2]),
            ).tolist(),
            corners.tolist(),
        ])
        axis_xyz = [0.0, 0.0, zc]
        axis_dir = [-1.0, 0.0, 0.0]
        bbox_info["axis_xyz_world"].extend([axis_xyz, axis_xyz])
        bbox_info["axis_dir_world"].extend([axis_dir, axis_dir])
        if is_target:
            link_name, handle_name, joint_name = nm, hnm, jn

    asset_id = f"{split}{idx:04d}"
    dirname = f"{asset_id}-{link_name}-{handle_name}-{joint_name}-0"
    asset_dir = pjoin(out_dir, dirname)
    os.makedirs(asset_dir, exist_ok=True)
    with open(pjoin(out_dir, ".genver"), "w") as f:
        f.write(str(DRAWER_GEN_VERSION))
    # marker: lets ensure_drawer_assets distinguish generator output from
    # user-provided (real GAPartNet) asset dirs on version-bump wipes
    with open(pjoin(asset_dir, ".generated"), "w") as f:
        f.write("1")
    for _, fn, size, _ in mesh_geoms:
        _write_box_obj(pjoin(asset_dir, fn), size)
    _write_urdf(pjoin(asset_dir, "mobility_new.urdf"), links, boxes,
                mesh_geoms)
    with open(pjoin(asset_dir, "bbox_info.json"), "w") as f:
        json.dump(bbox_info, f)
    return asset_dir


def _write_box_obj(path: str, size):
    """An axis-aligned box as a triangulated wavefront .obj."""
    hx, hy, hz = np.asarray(size, np.float64) / 2.0
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    # faces (1-indexed) with outward orientation per axis pair
    quads = [(1, 2, 4, 3), (5, 7, 8, 6),   # -x, +x
             (1, 5, 6, 2), (3, 4, 8, 7),   # -y, +y
             (1, 3, 7, 5), (2, 6, 8, 4)]   # -z, +z
    with open(path, "w") as f:
        for p in v:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for a, b, c, d in quads:
            f.write(f"f {a} {b} {c}\nf {a} {c} {d}\n")


def _write_urdf(path: str, links: List[dict], boxes: List[BoxDef],
                mesh_geoms: List[tuple] = ()):
    robot = ET.Element("robot", name="cabinet")
    by_link = {}
    for b in boxes:
        by_link.setdefault(b.link, []).append(b)
    mesh_by_link = {}
    for m in mesh_geoms:
        mesh_by_link.setdefault(m[0], []).append(m)
    for l in links:
        le = ET.SubElement(robot, "link", name=l["name"])
        for b in by_link.get(l["name"], []):
            col = ET.SubElement(le, "collision")
            ET.SubElement(col, "origin",
                          xyz=" ".join(map(str, b.origin_pos)),
                          rpy=" ".join(map(str, b.origin_rpy)))
            geo = ET.SubElement(col, "geometry")
            ET.SubElement(geo, "box", size=" ".join(map(str, b.size)))
        for _, fn, size, origin in mesh_by_link.get(l["name"], []):
            col = ET.SubElement(le, "collision")
            ET.SubElement(col, "origin", xyz=" ".join(map(str, origin)),
                          rpy="0 0 0")
            geo = ET.SubElement(col, "geometry")
            ET.SubElement(geo, "mesh", filename=fn)
        # box-derived inertial (density 400 kg/m³, thin furniture panels)
        vol = sum(np.prod(b.size) for b in by_link.get(l["name"], []))
        vol += sum(np.prod(m[2]) for m in mesh_by_link.get(l["name"], []))
        vol = vol or 1e-6
        inertial = ET.SubElement(le, "inertial")
        ET.SubElement(inertial, "mass", value=str(400.0 * vol))
    for l in links:
        j = l.get("joint")
        if j is None:
            continue
        je = ET.SubElement(robot, "joint", name=j["name"], type=j["type"])
        ET.SubElement(je, "parent", link=l["parent"])
        ET.SubElement(je, "child", link=l["name"])
        ET.SubElement(je, "origin", xyz=" ".join(map(str, j["origin"])),
                      rpy="0 0 0")
        ET.SubElement(je, "axis", xyz=" ".join(map(str, j["axis"])))
        if j["type"] != "fixed":
            ET.SubElement(je, "limit", lower=str(j["lower"]),
                          upper=str(j["upper"]), effort="100", velocity="2.0")
            ET.SubElement(je, "dynamics", damping=str(j["damping"]),
                          friction=str(j["friction"]))
    ET.indent(ET.ElementTree(robot))
    ET.ElementTree(robot).write(path)


# Bump whenever generate_drawer_asset output changes: stale cached splits
# (repo assets/ or test /tmp roots) are wiped and regenerated.
DRAWER_GEN_VERSION = 3


def ensure_drawer_assets(asset_root: str, split: str, n: int,
                         mesh_handle: bool = False) -> List[str]:
    """Generate procedural assets if the split folder is missing/short/stale;
    return the sorted asset dir list (≙ the reference's folder scan,
    ``open_drawer.py:35-36``).  ``mesh_handle`` emits handle bars as mesh
    collision geoms; mesh and box variants live in separate split dirs."""
    if mesh_handle:
        split = split + "_mesh"
    split_dir = pjoin(asset_root, "objs", "drawer", split)
    os.makedirs(split_dir, exist_ok=True)
    return _ensure_split(split_dir, split, n, mesh_handle)


def _ensure_split(split_dir: str, split: str, n: int, mesh_handle: bool) -> List[str]:
    """The generation behind :func:`ensure_drawer_assets`."""
    ver_file = pjoin(split_dir, ".genver")
    try:
        with open(ver_file) as f:
            ver = int(f.read().strip())
    except (OSError, ValueError):
        ver = 0
    if ver != DRAWER_GEN_VERSION:
        import shutil
        for d in os.listdir(split_dir):
            p = pjoin(split_dir, d)
            # Only wipe directories this generator created (stamped with a
            # .generated marker) — a user-pointed asset root laid out like
            # the reference's objs/drawer/<split>/<id> must never be
            # deleted just because it predates the version stamp.
            if os.path.isdir(p):
                generated = (os.path.exists(pjoin(p, ".generated"))
                             # pre-marker caches: the generator's dirname
                             # pattern <split><idx:04d>-link-handle-joint-0
                             or re.match(r"^(train|valIntra|valInter)\d{4}-",
                                         d))
                if generated:
                    shutil.rmtree(p)
                else:
                    import warnings
                    warnings.warn(
                        f"asset dir {p} has no .generated marker; leaving "
                        "it in place (not produced by this generator)")
        with open(ver_file, "w") as f:
            f.write(str(DRAWER_GEN_VERSION))
    existing = sorted(d for d in os.listdir(split_dir)
                      if os.path.isdir(pjoin(split_dir, d)))
    if len(existing) < n:
        base_split = split[:-5] if split.endswith("_mesh") else split
        for i in range(len(existing), n):
            generate_drawer_asset(split_dir, base_split, i,
                                  mesh_handle=mesh_handle)
        existing = sorted(d for d in os.listdir(split_dir)
                          if os.path.isdir(pjoin(split_dir, d)))
    return [pjoin(split_dir, d) for d in existing]


# ---------------------------------------------------------------------------
# URDF parsing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParsedObject:
    links: List[LinkDef]
    boxes: List[BoxDef]          # collision boxes with resolved link names
    dof_names: List[str]
    meshes: List[MeshDef] = dataclasses.field(default_factory=list)


_JT = {"prismatic": JOINT_PRISMATIC, "revolute": JOINT_REVOLUTE,
       "continuous": JOINT_REVOLUTE, "fixed": JOINT_FIXED}


def parse_urdf(path: str) -> ParsedObject:
    """Parse a URDF into LinkDefs + box collision geoms.

    Supports box geometries natively; mesh geoms are approximated by their
    AABB if an ``aabb`` attribute hint is present, else skipped (grid-SDF
    collision for meshes is handled by ``ops/sdf.py`` separately).
    """
    tree = ET.parse(path)
    root = tree.getroot()

    def fvec(s, default):
        return tuple(float(x) for x in s.split()) if s else default

    link_elems = {l.get("name"): l for l in root.findall("link")}
    joints = root.findall("joint")
    parent_of = {}
    joint_of = {}
    for j in joints:
        child = j.find("child").get("link")
        parent_of[child] = j.find("parent").get("link")
        joint_of[child] = j

    # root link: the one that is never a child
    roots = [n for n in link_elems if n not in parent_of]
    assert len(roots) == 1, f"URDF must have exactly one root, got {roots}"

    # order links topologically (parents first)
    ordered = [roots[0]]
    remaining = set(link_elems) - {roots[0]}
    while remaining:
        progressed = [n for n in remaining if parent_of[n] in ordered]
        assert progressed, "URDF kinematic loop detected"
        for n in sorted(progressed):
            ordered.append(n)
            remaining.discard(n)

    links: List[LinkDef] = []
    boxes: List[BoxDef] = []
    meshes: List[MeshDef] = []
    dof_names: List[str] = []
    for name in ordered:
        le = link_elems[name]
        mass = 0.0
        com = (0.0, 0.0, 0.0)
        inertia = (1e-4, 1e-4, 1e-4)
        inert = le.find("inertial")
        if inert is not None:
            me = inert.find("mass")
            mass = float(me.get("value")) if me is not None else 0.0
            oe = inert.find("origin")
            if oe is not None:
                com = fvec(oe.get("xyz"), com)
            ie = inert.find("inertia")
            if ie is not None:
                inertia = (float(ie.get("ixx", 1e-4)),
                           float(ie.get("iyy", 1e-4)),
                           float(ie.get("izz", 1e-4)))
        link_boxes = []
        link_meshes = []
        for col in le.findall("collision"):
            oe = col.find("origin")
            pos = fvec(oe.get("xyz") if oe is not None else None, (0, 0, 0))
            rpy = fvec(oe.get("rpy") if oe is not None else None, (0, 0, 0))
            box = col.find("geometry/box")
            if box is not None:
                size = fvec(box.get("size"), (0.1, 0.1, 0.1))
                link_boxes.append(BoxDef(name, size, pos, rpy))
                continue
            mesh = col.find("geometry/mesh")
            if mesh is not None:
                fn = mesh.get("filename") or ""
                fn = fn.replace("package://", "")
                if not os.path.isabs(fn):
                    fn = pjoin(os.path.dirname(os.path.abspath(path)), fn)
                mscale = fvec(mesh.get("scale"), (1.0, 1.0, 1.0))
                link_meshes.append(MeshDef(name, fn, pos, rpy, mscale))
        boxes.extend(link_boxes)
        meshes.extend(link_meshes)
        if mass == 0.0 and link_boxes:
            vol = sum(np.prod(b.size) for b in link_boxes)
            mass = 400.0 * vol
        elif mass == 0.0 and link_meshes:
            # shell-density estimate from the mesh AABB volume (matching the
            # box heuristic; real URDFs normally carry inertials)
            try:
                v, _ = load_obj_mesh(link_meshes[0].filename)
                ext = (v.max(0) - v.min(0)) * np.asarray(
                    link_meshes[0].scale)
                mass = 400.0 * float(np.prod(np.abs(ext)))
                inertia = (max(mass / 12 * (ext[1] ** 2 + ext[2] ** 2), 1e-5),
                           max(mass / 12 * (ext[0] ** 2 + ext[2] ** 2), 1e-5),
                           max(mass / 12 * (ext[0] ** 2 + ext[1] ** 2), 1e-5))
            except (OSError, ValueError):
                pass
        if inert is None or inert.find("inertia") is None:
            # box-shell inertia estimate from the largest collision box
            if link_boxes:
                big = max(link_boxes, key=lambda b: np.prod(b.size))
                sx, sy, sz = big.size
                inertia = (mass / 12 * (sy * sy + sz * sz),
                           mass / 12 * (sx * sx + sz * sz),
                           mass / 12 * (sx * sx + sy * sy))
                com = big.origin_pos

        j = joint_of.get(name)
        if j is None:
            links.append(LinkDef(name, mass=mass, com=com, inertia=inertia))
            continue
        jt = _JT.get(j.get("type"), JOINT_FIXED)
        oe = j.find("origin")
        axis_e = j.find("axis")
        lim = j.find("limit")
        dyn = j.find("dynamics")
        ld = LinkDef(
            name, parent=parent_of[name], joint_type=jt,
            origin_pos=fvec(oe.get("xyz") if oe is not None else None, (0, 0, 0)),
            origin_rpy=fvec(oe.get("rpy") if oe is not None else None, (0, 0, 0)),
            axis=fvec(axis_e.get("xyz") if axis_e is not None else None, (0, 0, 1)),
            lower=float(lim.get("lower", 0)) if lim is not None else 0.0,
            upper=float(lim.get("upper", 0)) if lim is not None else 0.0,
            effort=float(lim.get("effort", 1e9)) if lim is not None else 1e9,
            vel_limit=float(lim.get("velocity", 1e9)) if lim is not None else 1e9,
            damping=float(dyn.get("damping", 0)) if dyn is not None else 0.0,
            friction=float(dyn.get("friction", 0)) if dyn is not None else 0.0,
            mass=mass, com=com, inertia=inertia,
            joint_name=j.get("name"),
        )
        links.append(ld)
        if jt != JOINT_FIXED:
            dof_names.append(j.get("name"))
    return ParsedObject(links=links, boxes=boxes, dof_names=dof_names,
                        meshes=meshes)


# ---------------------------------------------------------------------------
# Loading drawer objects into padded TreeSpecs + BoxGeoms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DrawerObject:
    built: BuiltTree
    boxes_link_idx: np.ndarray     # [G]
    boxes_pos: np.ndarray          # [G, 3]
    boxes_quat: np.ndarray         # [G, 4]
    boxes_half: np.ndarray         # [G, 3]
    boxes_mask: np.ndarray         # [G]
    target_dof: int
    target_link: int               # index of the target drawer link
    target_handle: int             # index of the handle link
    handle_bbox: np.ndarray        # [8, 3] at rest, object frame (scaled)
    axis_xyz: np.ndarray           # [3]
    axis_dir: np.ndarray           # [3]
    joint_lower: float
    joint_upper: float
    num_dofs: int
    num_links: int
    # baked mesh-SDF collision geoms (empty lists for box-only assets)
    grids_link_idx: List[int] = dataclasses.field(default_factory=list)
    grids_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    grids_quat: List[np.ndarray] = dataclasses.field(default_factory=list)
    grid_dicts: List[dict] = dataclasses.field(default_factory=list)


def load_drawer_object(asset_dir: str, obj_scale: float,
                       pad_links: int, pad_dofs: int,
                       max_boxes: int,
                       dof_armature: float = 0.005,
                       device="cpu") -> DrawerObject:
    """Parse one GAPartNet-layout asset dir into padded spec arrays
    (≙ ``open_drawer.preload_all_obj``, ``open_drawer.py:98-140``).

    The dir name encodes ``assetid-linkname-handlename-jointname-*``
    (``open_drawer.py:103``); ``obj_scale`` scales geometry and prismatic
    limits (``open_drawer.py:79``, ``set_actor_scale`` at ``:159``).
    Mesh geoms missing a cached bake are baked on ``device``.
    """
    name = os.path.basename(asset_dir.rstrip("/"))
    parts = name.split("-")
    _, link_name, handle_name, joint_name = parts[-5:-1]

    parsed = parse_urdf(pjoin(asset_dir, "mobility_new.urdf"))
    with open(pjoin(asset_dir, "bbox_info.json"), "rb") as f:
        bbox_info = json.load(f)

    s = obj_scale
    links = []
    for l in parsed.links:
        ll = dataclasses.replace(
            l,
            origin_pos=tuple(np.asarray(l.origin_pos) * s),
            com=tuple(np.asarray(l.com) * s),
            inertia=tuple(np.asarray(l.inertia) * s * s),
            lower=l.lower * (s if l.joint_type == JOINT_PRISMATIC else 1.0),
            upper=l.upper * (s if l.joint_type == JOINT_PRISMATIC else 1.0),
            damping=l.damping, friction=l.friction,
            armature=dof_armature if l.joint_type != JOINT_FIXED else 0.0,
        )
        links.append(ll)
    built = build_tree(links, pad_links=pad_links, pad_dofs=pad_dofs)
    # objects are undriven (DOF_MODE_NONE, open_drawer.py:166) and
    # gravity-disabled (open_drawer.py:118)
    built.spec = built.spec._replace(
        gravity_scale=np.zeros(1, np.float32))

    G = max_boxes
    bl = np.zeros(G, np.int32)
    bp = np.zeros((G, 3), np.float32)
    bq = np.tile(np.array([0, 0, 0, 1], np.float32), (G, 1))
    bh = np.zeros((G, 3), np.float32)
    bm = np.zeros(G, np.float32)
    for gi, b in enumerate(parsed.boxes[:G]):
        bl[gi] = built.link_index[b.link]
        bp[gi] = np.asarray(b.origin_pos) * s
        bq[gi] = _rpy_to_quat(b.origin_rpy)
        bh[gi] = np.asarray(b.size) * s / 2.0
        bm[gi] = 1.0

    # mesh collision geoms → baked SDF grids (real GAPartNet assets; the
    # engine collides robot spheres against these via trilinear queries)
    g_link, g_pos, g_quat, g_dicts = [], [], [], []
    for m in parsed.meshes:
        try:
            grid = mesh_sdf_cached(m.filename,
                                   np.asarray(m.scale, np.float32) * s,
                                   device=device)
        except (OSError, ValueError) as e:
            print(f"WARNING: skipping mesh geom {m.filename}: {e}")
            continue
        g_link.append(built.link_index[m.link])
        g_pos.append(np.asarray(m.origin_pos, np.float32) * s)
        g_quat.append(_rpy_to_quat(m.origin_rpy).astype(np.float32))
        g_dicts.append(grid)

    li = bbox_info["link_name"].index(link_name)
    hi = bbox_info["link_name"].index(handle_name)
    handle_bbox = np.asarray(bbox_info["bbox_world"][hi], np.float32) * s
    d = built.dof_index[joint_name]
    return DrawerObject(
        built=built,
        boxes_link_idx=bl, boxes_pos=bp, boxes_quat=bq, boxes_half=bh,
        boxes_mask=bm,
        grids_link_idx=g_link, grids_pos=g_pos, grids_quat=g_quat,
        grid_dicts=g_dicts,
        target_dof=d,
        target_link=built.link_index[link_name],
        target_handle=built.link_index[handle_name],
        handle_bbox=handle_bbox,
        axis_xyz=np.asarray(bbox_info["axis_xyz_world"][li], np.float32),
        axis_dir=np.asarray(bbox_info["axis_dir_world"][li], np.float32),
        joint_lower=float(built.spec.dof_lower[0, d]),
        joint_upper=float(built.spec.dof_upper[0, d]),
        num_dofs=len(parsed.dof_names),
        num_links=len(parsed.links),
    )
