"""Make ``tests/golden_torch/dagger_collect_depth_img.npz``: one
``DAgger._collect`` of the JAX package on a tiny grasp_cube env with a
depth_img depthResNet student (2 envs, 2 steps, one 72×128 view through
the exact unculled XLA renderer), the reference of
``tests/test_torch_dagger_image.py::test_collect_matches_the_jax_collect``
(jitting the JAX env's reset and the collection takes about a minute on
an 8-core CPU, too slow for each test run).

    JAX_PLATFORMS=cpu python tests/golden_torch/make_image_dagger_golden.py

The configuration, cube placements, weights and starting buffer come from
``tests/_torch_dagger.py`` and ``tests/_torch_image.py``, which the test
reads too.  Saved:

* ``obs0`` — the depth_img (+ proprio) observation after the reset [E, O];
* ``noise`` — the exploration noise the collection draws, derived from the
  train state's key as ``_collect`` splits it [N_STEPS, E, A];
* ``stu_in`` / ``tea_in`` — the buffer before, ``stu_out`` (bf16 values as
  f32) / ``tea_out`` / ``write_idx`` / ``size`` after the collection;
* ``progress``, ``obs_last`` — the env's progress and the observation after
  the last step;
* ``info/<key>`` — the collected infos [N_STEPS, ...].
"""

import os
import sys
import tempfile

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_default_matmul_precision", "highest")   # as tests/conftest.py

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import _torch_dagger as td                                      # noqa: E402
import _torch_image as ti                                       # noqa: E402
from partmanip_tpu import config                                # noqa: E402
from partmanip_tpu.algos.dagger import DAgger, DaggerBuffer     # noqa: E402
from partmanip_tpu.envs.grasp_cube import GraspCubeEnv          # noqa: E402
from partmanip_tpu.models.actor_critic import ACParams          # noqa: E402


class _Logger:
    save_ckpt_dir = tempfile.mkdtemp()

    def info(self, record, iteration):
        pass


def make_env():
    cfg, sp = config.process_cfgs(list(ti.FLAGS))
    cfg["task"]["cam"]["coarse_to_fine"] = False
    env = GraspCubeEnv(cfg["task"], sp)
    dxy, yaw = td.cube_draws()

    def injected_root(rng, n):
        base = jnp.tile(jnp.asarray(env.obj_default_root[:3]), (n, 1))
        a = jnp.asarray(yaw)
        return (base.at[:, :2].add(jnp.asarray(dxy)),
                jnp.stack([jnp.zeros(n), jnp.zeros(n), jnp.sin(a), jnp.cos(a)], -1))
    env._random_obj_root = injected_root
    return env, cfg


def main():
    env, cfg = make_env()
    O, A = env.num_obs["depth_img"], env.num_actions
    O_TEA = env.num_obs["normal_state"]
    with tempfile.TemporaryDirectory() as tmp:
        acfg = dict(cfg["algo"], teacher=td.write_teacher(os.path.join(tmp, "t.ckpt"), O_TEA, A),
                    model=ti.model_cfg(), test_only=False)
        dag = DAgger(env, acfg, _Logger())
    state = env.init_state(jax.random.PRNGKey(0))
    state, obs = jax.jit(env.reset)(state)
    tree = ti.student_tree("depthResNet", O, A, ti.PROPRIO)
    params = ACParams(**jax.tree.map(jnp.asarray, tree))
    stu_in, tea_in = ti.start_buffer(O, O_TEA)
    ts, _ = dag.init_state(0)
    ts = ts._replace(
        student=params, opt=dag.tx.init(params),
        buffer=DaggerBuffer(stu_obs=jnp.asarray(stu_in).astype(jnp.bfloat16),
                            tea_obs=jnp.asarray(tea_in),
                            write_idx=jnp.int32(ti.START_WRITE),
                            size=jnp.int32(ti.START_SIZE)),
        stu_obs=obs["depth_img"], tea_obs=obs["normal_state"],
        rng=jax.random.PRNGKey(5), pending_force=jnp.zeros(ti.E, bool))
    # the noise of each step, split from the key as _collect splits it
    rng, noise = ts.rng, []
    for _ in range(ti.N_STEPS):
        rng, k = jax.random.split(rng)
        noise.append(np.asarray(jax.random.normal(k, (ti.E, A))))
    ts2, state2, infos = jax.jit(dag._collect)(ts, state)
    buf = ts2.buffer
    out = {"obs0": np.asarray(obs["depth_img"]), "tea0": np.asarray(obs["normal_state"]),
           "noise": np.stack(noise), "stu_in": stu_in, "tea_in": tea_in,
           "stu_out": np.asarray(buf.stu_obs.astype(jnp.float32)),
           "tea_out": np.asarray(buf.tea_obs),
           "write_idx": np.asarray(buf.write_idx), "size": np.asarray(buf.size),
           "progress": np.asarray(state2.progress), "obs_last": np.asarray(ts2.stu_obs)}
    out.update({f"info/{k}": np.asarray(v) for k, v in infos.items()})
    np.savez_compressed(ti.GOLDEN, **out)
    print("wrote", ti.GOLDEN, {k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
