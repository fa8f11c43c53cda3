"""A frozen copy of the plain PyTorch path of ``partmanip_tpu_torch``
(its config, YAMLs, envs, simulator, renderer, FPS, TSDF helpers and
checkpoint reader), taken when the benchmark was defined and patched so
that every device runs the plain versions: ``sim/engine.physics_step``
loops over ``_inner_step``, ``ops/raymarch.render_depth`` marches with
``march_plain`` and ``ops/fps.farthest_point_sampling`` runs the plain
loop.  No CUDA kernel of the port is built or loaded from here.

The benchmark's reference steps this copy from the program's captured
states and compares what the program produced; later changes to the
program do not move it.  It imports nothing of the program."""
