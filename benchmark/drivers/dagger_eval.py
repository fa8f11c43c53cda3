"""Traffic kind ``dagger_eval``: deterministic evaluation rounds of a
seeded point-cloud student, as ``DAgger.eval`` makes them
(``_eval_round`` then ``fetch_scalars``, one round a call), started until
``--seconds`` have passed; the window ends with the last round.  A step's
cost does not depend on the student's skill: every step renders, samples
and steps the physics alike.

Set-up builds the runner, initialises it from the seed, loads the
benchmark's seeded student and warms every shape with ``warm_steps`` steps
of the round's own calls.  The window's env steps drawn from the seed
(``check_ranges`` in the first ``check_rounds`` rounds) leave a copy of
their input and output, their depth images, FPS indices and point cloud,
and of the student's observation and actions before them, for the check;
so does a run of ``rollout`` steps of the first round (its first step
drawn from the seed in ``[lo, hi)``).

Parameters (``workloads/<cell>.json``): ``check_rounds``,
``check_ranges``, ``rollout`` ([lo, hi, steps]), ``warm_steps``,
``profile_from``, ``profile_steps``.
"""

from __future__ import annotations

from harness import capture, counts, program, rounds
from harness import weights as weights_lib


class State:
    pass


def _steps(r, env_state, o, n):
    import torch
    with torch.no_grad():
        for _ in range(n):
            actions = r.student.act(o)
            env_state, obs, *_ = r.env.step(env_state, actions, train=False)
            o = r._select(obs, r.stu_obs_mode)
    return env_state, o


def _reset(r, env_state):
    import torch
    with torch.no_grad():
        env_state, obs = r.env.reset(env_state)
    return env_state, r._select(obs, r.stu_obs_mode)


def setup(run):
    from partmanip_tpu_torch.utils.fetch import fetch_scalars
    st = State()
    st.fetch = fetch_scalars
    st.runner, st.cfg = program.build(run)
    r = st.runner
    st.ts, st.env_state = r.init_state(program.program_seed(run.seed))
    weights_lib.load_into(r.student, weights_lib.pointnet_actor_critic(run.config, run.seed,
                                                                         run.device))
    p = run.cell["params"]
    st.env_state, _ = _steps(r, *_reset(r, st.env_state), int(p["warm_steps"]))
    st.cap = rounds.StepCapture(
        r.env, rounds.sampled_steps(run.seed, int(p["check_rounds"]), r.max_episode_length,
                                    p["check_ranges"]),
        vision=True, rollout=rounds.sampled_run(run.seed, *p["rollout"]))
    st.policy = {}
    act = r.student.act

    def act_capture(obs):
        out = act(obs)
        if st.cap.index in st.cap.wanted:
            st.policy[st.cap.index] = (obs.detach().clone(), out.detach().clone())
        return out

    r.student.act = act_capture
    return st


def _round(st):
    st.env_state, m = st.runner._eval_round(st.ts, st.env_state)
    return rounds.finite(st.fetch(m))


def window(run, st):
    from partmanip_tpu_torch.envs import vision as vision_lib
    r = st.runner
    if run.trace:
        run.spans.wrap(r.env, "step", "env.step")
        run.spans.wrap(vision_lib, "render_obs", "vision.render_obs")
    rounds.eval_window(run, lambda: _round(st))
    run.window["env_steps"] = run.window["units"] * r.max_episode_length * r.num_envs


def before_profile(run, st):
    """A fresh round's first ``profile_from`` steps, unprofiled."""
    r = st.runner
    st.env_state, st.obs = _steps(r, *_reset(r, st.env_state),
                                  int(run.cell["params"]["profile_from"]))
    st.profiled_sim = capture.snapshot(st.env_state.sim)


def profile(run, st):
    """The round's next ``profile_steps`` steps."""
    st.env_state, st.obs = _steps(st.runner, st.env_state, st.obs,
                                  int(run.cell["params"]["profile_steps"]))
    return 1


def end_to_end(run, st):
    return {"eval_env_steps_per_s": run.window["env_steps"] / run.window["seconds"]}


def release(run, st):
    st.cap.remove()
    del st.runner.student.act
    st.max_episode_length = st.runner.max_episode_length
    st.control_freq_inv = st.runner.env.control_freq_inv
    del st.runner, st.ts, st.env_state


def check(run, st, control: bool = False):
    """The numbers compared at the sampled steps: the env step's physics,
    state observation and reward, the depth images, FPS indices and point
    cloud, the sampled run of steps (``envcheck.env_gaps``), and
    the student's actions against the reference's PointNet with the same
    seeded weights.  With ``control`` the reference one precision lower
    takes the program's place (the student's products in TF32, the env's
    in TF32 and its observation and reward in bf16, the depth and points
    rounded to bf16)."""
    from reference import envcheck, nets
    env, ref_cfg, rig = envcheck.build_env(program.flags(run), program.program_seed(run.seed),
                                           run.device, program.REFERENCE_ASSETS)
    mode = ref_cfg["algo"]["obs_mode"]
    c = run.config
    clip = ref_cfg["algo"]["model"]["clipAction"]
    numbers = {"checked_steps": float(len(st.cap.steps)),
               **envcheck.env_gaps(env, rig, mode, st.cap, control)}
    w = weights_lib.pointnet_actor_critic(c, run.seed, run.device)
    for obs, act in st.policy.values():
        with nets.precision("f32"):
            want = nets.activate(nets.pointnet(w, "actor", obs, c["points"], c["proprio"]), clip)
        if control:
            with nets.precision("tf32"):
                act = nets.activate(nets.pointnet(w, "actor", obs, c["points"], c["proprio"],
                                                  "tf32"), clip)
        for k, v in nets.action_gaps(want, act).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    if run.trace:
        _count_work(run, st, env, rig)
    return numbers


def _count_work(run, st, env, rig):
    """A round's least time: per step the student's products, one render
    (B2's counted operations), one FPS (B3's, over the rows' compacted
    points) and ``control_freq_inv`` physics launches (B1b's), all at the
    f32 peak; and one B3 launch's least time."""
    from reference import envcheck
    from reference.plain.ops import tsdf as tsdf_lib
    c = run.config
    if not st.cap.steps:
        return
    cap_out = st.cap.steps[-1][1]
    pts = tsdf_lib.workspace_points(rig.tsdf_spec, cap_out["depth"])
    live = int((pts != 0).any(-1).sum()) + pts.shape[0]       # and each row's one zero point
    B, N, _ = pts.shape
    k = cap_out["fps_idx"].shape[-1]
    b3 = counts.bound_s(counts.fps_operations(k, live), counts.fps_bytes(B, N, k))
    b2 = envcheck.b2_operations(env, rig, st.profiled_sim)
    touching = envcheck.touching(env, st.profiled_sim)
    p = env.scene.params
    physics = counts.inner_step_flops(env, touching) * p.substeps * p.inner_substeps * B
    student = counts.pointnet_flops(c["channels"], c["points"], c["proprio"], c["num_actions"], B)
    per_step = (student + b2 + st.control_freq_inv * physics) / counts.H100_F32_FLOPS + b3["s"]
    run.work.update(b3=b3, b2_operations=b2, touching=touching,
                    least_s_per_unit=st.max_episode_length * per_step)
