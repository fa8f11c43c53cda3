"""Config system: three-file YAML merge + auto-generated dotted CLI flags.

Counterpart of ``partmanip_tpu/config.py``, reading the port's own copy of
the YAMLs under ``partmanip_tpu_torch/cfg/``: ``cfg/base.yaml`` +
``cfg/tasks/<task>.yaml`` + ``cfg/algos/<algo>.yaml`` merge into one dict;
every key is mirrored as a dotted argparse flag (bool flags flip their YAML
default, types frozen by the YAML value, lists take nargs); and the same
cross-section key copying wires task↔algo settings.

Only the configs of the ported slices are shipped (``tasks/grasp_cube``,
``tasks/open_drawer``, ``algos/ppo``, ``algos/dagger``); asking for another
one (``algos/bc``) raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from collections import abc
from os.path import join as pjoin

import yaml

from .sim.types import SimParams

CFG_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cfg")


def _flag_specs(tree: dict, prefix: str = ""):
    """Yield ``(dotted_name, argparse_kwargs)`` for every leaf of the config
    tree.  CLI contract: bool leaves
    become bare switches that INVERT the YAML default; numeric/str leaves
    are typed by the YAML value; list leaves take one-or-more values typed
    by their first element; dicts recurse with a dot separator."""
    for key, val in tree.items():
        dotted = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flag_specs(val, dotted + ".")
        elif isinstance(val, bool):
            yield dotted, {"default": None,
                           "action": "store_true" if not val else "store_false"}
        elif isinstance(val, (int, float)):
            yield dotted, {"type": type(val)}
        elif val is None or isinstance(val, str):
            yield dotted, {}
        elif isinstance(val, abc.Iterable):
            seq = list(val)
            yield dotted, {"type": type(seq[0]) if seq else str, "nargs": "+"}
        else:
            print(f"[config] no CLI flag generated for {dotted!r}: "
                  f"un-flaggable leaf type {type(val).__name__}")


def add_args(parser: ArgumentParser, cfg: dict, prefix: str = "") -> ArgumentParser:
    """Mirror every config key as a dotted CLI flag."""
    for dotted, kwargs in _flag_specs(cfg, prefix):
        parser.add_argument("--" + dotted, **kwargs)
    return parser


def parse_sim_params(cfg: dict) -> SimParams:
    """Build integrator params from the ``sim`` block."""
    sim = cfg.get("sim", {})
    return SimParams(
        dt=float(sim.get("dt", 1.0 / 60.0)),
        substeps=int(sim.get("substeps", 4)),
        inner_substeps=int(sim.get("inner_substeps", 4)),
        gravity=float(sim.get("gravity", -9.81)),
        contact_kn=float(sim.get("contact_kn", 2.0e4)),
        contact_damping_ratio=float(sim.get("contact_damping_ratio", 1.0)),
        contact_kt=float(sim.get("contact_kt", 1.0e3)),
        contact_offset=float(sim.get("contact_offset", 0.005)),
        coriolis=bool(sim.get("coriolis", False)),
        use_fused=bool(sim.get("use_fused", True)),
    )


def process_cfgs(argv=None, cfg_root: str = None):
    """Load + merge + CLI-override configs.

    Returns (cfg, sim_params).
    """
    cfg_root = cfg_root or CFG_ROOT
    partial = ArgumentParser(description="partmanip_tpu_torch", add_help=False)
    partial.add_argument("--taskcfg", default="grasp_cube")
    partial.add_argument("--algocfg", default="ppo")
    pargs, others = partial.parse_known_args(argv)
    for kind, name in (("tasks", pargs.taskcfg), ("algos", pargs.algocfg)):
        if not os.path.exists(pjoin(cfg_root, kind, f"{name}.yaml")):
            raise NotImplementedError(
                f"config {kind}/{name}.yaml does not exist in the port (it has "
                f"the JAX package's ppo, dagger and bc; ROADMAP Queue A)")

    with open(pjoin(cfg_root, "base.yaml")) as f:
        cfg = yaml.safe_load(f)
    with open(pjoin(cfg_root, "tasks", f"{pargs.taskcfg}.yaml")) as f:
        cfg["task"] = yaml.safe_load(f)
    with open(pjoin(cfg_root, "algos", f"{pargs.algocfg}.yaml")) as f:
        cfg["algo"] = yaml.safe_load(f)

    parser = ArgumentParser(description="partmanip_tpu_torch")
    add_args(parser, cfg)
    args = vars(parser.parse_args(others))

    for k, v in args.items():
        if v is None:
            continue
        node = cfg
        parts = k.split(".")
        for kk in parts[:-1]:
            node = node[kk]
        node[parts[-1]] = v

    # task-level sim overrides (e.g. open_drawer has no free body and can
    # integrate at h = dt/substeps with the fully implicit contact path)
    if isinstance(cfg["task"].get("sim"), dict):
        merged = dict(cfg.get("sim", {}))
        merged.update(cfg["task"]["sim"])
        cfg["sim"] = merged
    sim_params = parse_sim_params(cfg)

    # cross-copy keys between sections
    for k in ["headless", "save_video"]:
        cfg["task"][k] = cfg.get(k, False)
    for k in ["resume", "test_only", "save_pose", "save_video", "pretrain"]:
        cfg["algo"][k] = cfg.get(k)
    cfg["algo"]["model"]["clipAction"] = cfg["task"]["clipActions"]
    cfg["algo"]["succ_value"] = cfg["task"]["succ_value"]
    cfg["task"]["num_envs"] = cfg["algo"]["num_envs"]
    cfg["task"]["learn_input_mode"] = cfg["algo"]["obs_mode"]
    cfg["task"]["add_proprio_obs"] = cfg["algo"]["add_proprio_obs"]
    cfg["algo"]["parallel"] = cfg.get("parallel") or {}
    cfg["algo_name"] = cfg["algo"]["algo"]
    cfg["task_name"] = cfg["task"]["task"]

    return cfg, sim_params
