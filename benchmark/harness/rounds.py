"""What the traffic kinds share: evaluation rounds back to back, the env
steps and vision observations a check samples from the window (drawn from
the seed), and the capture of one env step."""

from __future__ import annotations

import random
import time

from . import capture
from .cli import sync


def sampled_steps(seed: int, rounds: int, length: int, per_round: list) -> set:
    """Step indices (counted over the window's env steps) the check
    compares: in each of the first ``rounds`` rounds, one step drawn from
    each ``[lo, hi)`` range of ``per_round``, from the seed."""
    rng = random.Random(seed)
    return {r * length + rng.randrange(lo, hi) for r in range(rounds) for lo, hi in per_round}


def sampled_run(seed: int, lo: int, hi: int, steps: int) -> tuple:
    """(first step, steps) of the run of env steps a check follows: its
    first step drawn from ``[lo, hi)`` by the seed."""
    return random.Random(seed + 1).randrange(lo, hi), steps


class StepCapture:
    """Wraps an env's ``step`` (and, for vision cells, the program's
    ``render_depth`` and FPS) so that the env steps whose index is in
    ``wanted`` leave a copy of their input and output (and the depth
    images, FPS indices and point cloud of the observation they make), and
    the ``length`` steps from index ``start`` of ``rollout`` leave the
    first one's input, each one's actions and the last one's output.
    Every other call passes straight through."""

    def __init__(self, env, wanted: set, vision: bool, rollout=None):
        self.env, self.wanted, self.vision = env, set(wanted), vision
        self.index, self.steps, self.active = 0, [], False
        self.span = range(rollout[0], rollout[0] + rollout[1]) if rollout else range(0)
        self.rollout = {"inputs": []}
        self._step = env.step
        self._undo = []
        env.step = self.step
        if vision:
            from partmanip_tpu_torch.envs import vision as vision_lib
            from partmanip_tpu_torch.ops import tsdf as tsdf_lib
            self._hook(vision_lib, "render_depth", "depth", lambda out: out)
            self._hook(tsdf_lib, "farthest_point_sampling", "fps_idx", lambda out: out[1])

    def _hook(self, module, attr, key, pick):
        fn = getattr(module, attr)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if self.active:
                self.current[key] = pick(out).detach().clone()
            return out

        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, fn))

    def step(self, state, actions, train=True, force_reset=None):
        i = self.index
        self.index += 1
        if i in self.span:
            if i == self.span[0]:
                self.rollout["start"] = capture.snapshot(state)
            self.rollout["inputs"].append({"actions": actions.detach().clone(), "train": train,
                                           "force_reset": capture.snapshot(force_reset)})
        if i not in self.wanted:
            out = self._step(state, actions, train=train, force_reset=force_reset)
            self._end(i, out)
            return out
        self.current = {"index": i}
        cap_in = {"state": capture.snapshot(state), "actions": actions.detach().clone(),
                  "train": train, "force_reset": capture.snapshot(force_reset)}
        self.active = True
        try:
            out = self._step(state, actions, train=train, force_reset=force_reset)
        finally:
            self.active = False
        st2, obs, rew, dones, _ = out
        cap_out = {"state": capture.snapshot(st2), "obs": capture.snapshot(obs),
                   "rew": rew.clone(), "dones": dones.clone(), **self.current}
        self.steps.append((cap_in, cap_out))
        self._end(i, out)
        return out

    def _end(self, i, out):
        if len(self.span) and i == self.span[-1]:
            st2, obs, rew, dones, _ = out
            self.rollout["end"] = {"state": capture.snapshot(st2), "obs": capture.snapshot(obs),
                                   "rew": rew.clone(), "dones": dones.clone()}

    def remove(self):
        del self.env.step
        while self._undo:
            self._undo.pop()()


def eval_window(run, round_fn) -> None:
    """Whole rounds (``round_fn()`` → True where its metrics came back
    finite) started until ``run.seconds`` have passed; the window ends with
    the last round."""
    n = failed = 0
    ends = []
    sync(run.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds or n == 0:
        failed += not round_fn()
        n += 1
        ends.append(time.perf_counter() - t0)
    run.window.update(seconds=ends[-1], units=n, attempted=n, failed=failed, unit_ends=ends)


def finite(log: dict) -> bool:
    return all(v == v and abs(v) != float("inf") for v in log.values())
