"""Make ``tests/golden_torch/vision_depth_pc.npz``: reference values of the
JAX package for the port's vision parity tests, which are too slow to
compute in each test run (jitting the JAX env's ``depth_pc`` reset and step
takes about 40 s on an 8-core CPU).

    JAX_PLATFORMS=cpu python tests/golden_torch/make_vision_golden.py

The configuration, cabinet placements, actions and student weights come
from ``tests/_torch_vision.py``, which the tests read too.  Saved:

* ``depth_pc``, ``normal_state`` — the env's observations after its reset
  and after each of ``N_STEPS`` steps, [N_STEPS + 1, E, ...];
* ``depth`` — the exact-march depth images of those states [.., E, 3, H, W];
* ``sim/<part>/<field>`` — those scene states;
* ``metric/<name>`` — the metrics of one ``DAgger._eval_round`` of the
  numpy-drawn PointNet student (``EVAL_T`` steps).
"""

import os
import random
import sys
import tempfile

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_default_matmul_precision", "highest")   # as tests/conftest.py

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import _torch_vision as tv                                      # noqa: E402
from partmanip_tpu import config                                # noqa: E402
from partmanip_tpu.algos.dagger import DAgger                   # noqa: E402
from partmanip_tpu.envs import vision                           # noqa: E402
from partmanip_tpu.envs.open_drawer import OpenDrawerEnv        # noqa: E402
from partmanip_tpu.models.actor_critic import ACParams          # noqa: E402
from partmanip_tpu.ops import raymarch                          # noqa: E402
from partmanip_tpu.ops import rotations as rot                  # noqa: E402


class _Logger:
    save_ckpt_dir = tempfile.mkdtemp()

    def info(self, record, iteration):
        pass


def make_env(asset_root):
    cfg, sp = config.process_cfgs(tv.flags(asset_root))
    tv.small_cfg(cfg)
    random.seed(tv.OBJ_SEED)
    env = OpenDrawerEnv(cfg["task"], sp)
    dxyz, yaw = tv.draws()

    def injected_root(rng, n):
        base = jnp.tile(jnp.asarray([-0.6, 0.0, 0.5]), (n, 1))
        a = jnp.asarray(yaw)
        dq = jnp.stack([jnp.zeros(n), jnp.zeros(n), jnp.sin(a), jnp.cos(a)], -1)
        q0 = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0, 0.0]), (n, 4))
        return base + jnp.asarray(dxyz), rot.quat_mul(q0, dq)
    env._random_obj_root = injected_root
    return env, cfg


def main():
    out = {}
    with tempfile.TemporaryDirectory() as root:
        env, cfg = make_env(root)
        rig = env.vision_rig
        render = jax.jit(lambda sim: raymarch.render_depth(
            vision.scene_prims(env, sim), rig.poses, rig.intrinsic, rig.im_h,
            rig.im_w, coarse_to_fine=False))
        state = env.init_state(jax.random.PRNGKey(0))
        state, obs = jax.jit(env.reset)(state)
        step = jax.jit(lambda s, a: env.step(s, a, train=False))
        trace = []
        for t in range(tv.N_STEPS + 1):
            if t:
                state, obs, *_ = step(state, jnp.asarray(tv.actions(env.num_actions)[t - 1]))
            trace.append((np.asarray(obs["depth_pc"]), np.asarray(obs["normal_state"]),
                          np.asarray(render(state.sim)), state.sim))
        out["depth_pc"] = np.stack([t[0] for t in trace])
        out["normal_state"] = np.stack([t[1] for t in trace])
        out["depth"] = np.stack([t[2] for t in trace])
        for part in ("robot", "obj", "anchors"):
            for k in getattr(state.sim, part)._fields:
                out[f"sim/{part}/{k}"] = np.stack(
                    [np.asarray(getattr(getattr(t[3], part), k)) for t in trace])

        acfg = dict(cfg["algo"], teacher=tv.TEACHER, test_only=True)
        dag = DAgger(env, acfg, _Logger())
        ts, es = dag.init_state(seed=0)
        tree = tv.student_tree(env.num_actions)
        ts = ts._replace(student=ACParams(
            actor=jax.tree.map(jnp.asarray, tree["actor"]),
            critic=jax.tree.map(jnp.asarray, tree["critic"]),
            log_std=jnp.asarray(tree["log_std"])))
        es, metrics = dag._jit_eval_round(ts, es)
        for k, v in metrics.items():
            out[f"metric/{k}"] = np.float32(v)
    np.savez_compressed(tv.GOLDEN, **out)
    print("wrote", tv.GOLDEN, {k: v.shape for k, v in out.items() if v.ndim})


if __name__ == "__main__":
    main()
