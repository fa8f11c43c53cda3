"""Traffic kind ``dagger_train``: DAgger iterations of a seeded point-cloud
student, as ``DAgger.run`` makes them (``_dagger_iteration`` then
``fetch_scalars``), back to back until ``--seconds`` have passed; the
window ends with the last iteration.

Set-up builds the runner (the teacher read from its checkpoint by the
program's reader), initialises it from the seed, loads the benchmark's
seeded student, fills the ring buffer to ``fill_rows`` rows with the
program's own collection (``_collect``), so that every Adam step's rows
all differ, and drives it through ``check_iterations`` iterations of
the window's own call, recording what the check needs: the ring buffer's
valid rows after each collection, each iteration's minibatch indices and
loss and its first Adam step's loss, Adam's first gradient, the
parameters after the last, the env
steps named by ``check_steps`` with their depth images, FPS indices and
point clouds, and the run of env steps named by ``rollout``.  The same runner goes on into the window.

Parameters (``workloads/<cell>.json``): ``fill_rows``,
``check_iterations``, ``check_steps`` (0-based env-step indices counted
from the fill's first step), ``rollout`` ([first step, steps], counted
likewise).
"""

from __future__ import annotations

import time

from harness import counts, judge, program, rounds
from harness import weights as weights_lib
from harness.cli import sync


class State:
    pass


def weights(run):
    return weights_lib.pointnet_actor_critic(run.config, run.seed, run.device)


def _iteration(st):
    r = st.runner
    r.curr_iter += 1
    lr = r._lr_now()
    st.ts, st.env_state, metrics = r._dagger_iteration(st.ts, st.env_state, float(lr))
    log = st.fetch(metrics)
    r.total_envsteps += r.n_steps * r.num_envs
    st.last_log = log
    return rounds.finite(log)


def setup(run):
    from partmanip_tpu_torch.algos import storage
    from partmanip_tpu_torch.utils.fetch import fetch_scalars
    st = State()
    st.fetch = fetch_scalars
    st.runner, st.cfg = program.build(run)
    r = st.runner
    st.ts, st.env_state = r.init_state(program.program_seed(run.seed))
    weights_lib.load_into(r.student, weights(run))

    p = run.cell["params"]
    cap = st.ts.buffer.stu_obs.shape[0]
    per_call = r.n_steps * r.num_envs
    st.cap = rounds.StepCapture(r.env, set(p["check_steps"]), vision=True, rollout=p["rollout"])
    for _ in range(-(-min(int(p["fill_rows"]), cap) // per_call)):
        st.ts, st.env_state, _ = r._collect(st.ts, st.env_state)
    st.iterations, st.first_moment = [], None
    collect = r._collect

    def collect_capture(ts, env_state, noise=None):
        ts, env_state, infos = collect(ts, env_state, noise)
        n = int(ts.buffer.size)
        st.iterations.append({"stu_rows": ts.buffer.stu_obs[:n].clone(),
                              "tea_rows": ts.buffer.tea_obs[:n].clone()})
        return ts, env_state, infos

    indices = storage.buffer_minibatch_indices

    def indices_capture(*a, **k):
        out = indices(*a, **k)
        st.iterations[-1]["indices"] = out.clone()
        return out

    opt = st.ts.opt
    step = opt.step

    def first_step(lr):
        step(lr)
        if st.first_moment is None:
            st.first_moment = {n: (m / (1 - opt.B1)).clone() for n, m in zip(opt.names, opt.mu)}

    st.first_losses = []
    loss_fn = r._loss

    def loss_capture(stu_obs, tea_act):
        loss = loss_fn(stu_obs, tea_act)
        if st.first_moment is None:           # the first Adam step's chunks
            st.first_losses.append(loss.detach())
        return loss

    r._collect = collect_capture
    r._loss = loss_capture
    storage.buffer_minibatch_indices = indices_capture
    opt.step = first_step
    st.losses = []
    try:
        for _ in range(int(p["check_iterations"])):
            _iteration(st)
            st.iterations[-1]["lr"] = float(r._lr_now())
            st.losses.append(st.last_log["Train/dagger_loss"])
    finally:
        del r._collect, r._loss, opt.step
        storage.buffer_minibatch_indices = indices
        st.cap.remove()
    st.params_after = {n: v.detach().clone() for n, v in r.student.named_parameters()}
    st.mb = r.minibatch_sizes(st.ts.buffer.stu_obs.shape[0])
    return st


def window(run, st):
    from partmanip_tpu_torch.envs import vision as vision_lib
    r = st.runner
    if run.trace:
        run.spans.wrap(r, "_collect", "dagger.collect")
        run.spans.wrap(r.env, "step", "env.step")
        run.spans.wrap(vision_lib, "render_obs", "vision.render_obs")
    n = failed = 0
    ends = []
    sync(run.device)
    t0 = time.perf_counter()
    while True:
        if run.trace:
            with run.spans.span("dagger.iteration"):
                ok = _iteration(st)
        else:
            ok = _iteration(st)
        n += 1
        failed += not ok
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= run.seconds:
            break
    run.window.update(seconds=ends[-1], units=n, attempted=n, failed=failed, unit_ends=ends)


def profile(run, st):
    with run.spans.span("dagger.iteration"):
        _iteration(st)
    return 1


def end_to_end(run, st):
    return {"dagger_iteration_s": run.window["seconds"] / run.window["units"]}


def release(run, st):
    st.teacher_path = st.runner.teacher_path
    del st.runner, st.ts, st.env_state


def check(run, st, control: bool = False):
    """The numbers compared: the captured env steps' physics, state
    observation and reward, their depth images, FPS indices and point
    clouds, the captured run of steps (``envcheck.env_gaps``), each
    iteration's loss and the first Adam step's, the first gradient (the gap
    of its norms, and the norm of its difference) and the parameters'
    change by the worst leaf.  With ``control`` the reference one precision lower takes
    the program's place: the student's products in TF32 (its f32), the
    teacher in fp8 (its bf16), the env's products in TF32, the depth and
    points rounded to bf16 (their f32)."""
    from reference import dagger as ref_dagger, envcheck, teacher
    env, ref_cfg, rig = envcheck.build_env(program.flags(run), program.program_seed(run.seed),
                                           run.device, program.REFERENCE_ASSETS)
    numbers = envcheck.env_gaps(env, rig, ref_cfg["algo"]["obs_mode"], st.cap, control)
    a = ref_cfg["algo"]
    mb, chunk, n_chunks = st.mb
    shape = {"points": run.config["points"], "proprio": run.config["proprio"],
             "clip": a["model"]["clipAction"], "n_chunks": n_chunks}
    tea = teacher.load(st.teacher_path, run.device)
    w0 = weights(run)
    ref = ref_dagger.run(w0, tea, st.iterations, shape)
    if control:
        cand = ref_dagger.run(w0, tea, st.iterations, shape, "tf32", "fp8")
        losses, first, after = cand["loss"], cand["first_grad"], cand["params"]
    else:
        losses, first, after = st.losses, st.first_moment, st.params_after
    numbers["loss.dagger"] = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, ref["loss"]))
    first_loss = cand["step_loss"][0] if control else float(sum(st.first_losses)) / len(st.first_losses)
    numbers["loss.first_step"] = abs(first_loss - ref["step_loss"][0]) / max(abs(ref["step_loss"][0]), 1e-30)
    g_ref = judge.leaf_norms(ref["first_grad"])
    numbers["grad.first"] = judge.worst_leaf(judge.leaf_norms(first), g_ref)
    numbers["grad.first_difference"] = judge.worst_leaf_difference(first, ref["first_grad"])
    d_prog = judge.leaf_norms({n: after[n] - w0[n] for n in w0})
    d_ref = judge.leaf_norms({n: ref["params"][n] - w0[n] for n in w0})
    numbers["params.change"] = judge.worst_leaf(d_prog, d_ref, judge.moving_leaves(g_ref))
    if run.trace:
        c = run.config
        rows = 3 * mb * a["n_updates"] * a["n_minibatches"]          # forward + backward
        fl = counts.pointnet_flops(c["channels"], c["points"], c["proprio"], c["num_actions"], rows)
        run.work["least_s_per_unit"] = fl / counts.H100_F32_FLOPS
    return numbers
