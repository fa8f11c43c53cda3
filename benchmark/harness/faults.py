"""Faults planted in the program underneath a run, to show that a cell's
check fails them (the benchmark's tests on the CPU; ``control.py
--fault`` on the card at the cell's own size):

- ``unchanged``: a step that returns its state unchanged (a training
  cell's optimizer step; an evaluation cell's physics step);
- ``half``: half of the batch left out, the mean taken over the rest (a
  training cell's loss over half the minibatch's rows; an evaluation
  cell's physics over half the envs, the others left as they were);
- ``altered``: an answer altered where it is produced (the state
  observation, shifted by 1e-3).

The one-chip cells have no exchange between chips to leave out."""

from __future__ import annotations

from contextlib import ExitStack, contextmanager

FAULTS = ("unchanged", "half", "altered")


def _patch(stack: ExitStack, owner, attr, value):
    old = getattr(owner, attr)
    setattr(owner, attr, value)
    stack.callback(setattr, owner, attr, old)


@contextmanager
def planted(driver_kind: str, fault: str):
    """Plant ``fault`` in the program for a cell of traffic kind
    ``driver_kind`` while the context is open."""
    import torch
    from partmanip_tpu_torch.algos import dagger, ppo
    from partmanip_tpu_torch.envs import base, open_drawer
    train = driver_kind.endswith("_train")
    with ExitStack() as stack:
        if fault == "unchanged" and train:
            _patch(stack, ppo.Adam, "step", lambda self, lr: None)
        elif fault == "unchanged":
            _patch(stack, base, "run_physics", lambda scene, sim, *a, **k: sim)
        elif fault == "half" and driver_kind == "dagger_train":
            loss = dagger.DAgger._loss
            _patch(stack, dagger.DAgger, "_loss", lambda self, s, t: loss(
                self, s[: max(1, s.shape[0] // 2)], t[: max(1, t.shape[0] // 2)]))
        elif fault == "half":
            step = base.run_physics

            def half_physics(scene, sim, *a, **k):
                new = step(scene, sim, *a, **k)
                E = sim.robot.qpos.shape[0]
                keep = torch.arange(E, device=sim.robot.qpos.device) < E // 2
                return base.mask_where(keep, new, sim)
            _patch(stack, base, "run_physics", half_physics)
        elif fault == "altered":
            obs = open_drawer.OpenDrawerEnv._observations

            def shifted(self, state):
                o, view, bbox = obs(self, state)
                return {k: v + 1e-3 for k, v in o.items()}, view, bbox
            _patch(stack, open_drawer.OpenDrawerEnv, "_observations", shifted)
        else:
            raise ValueError(f"fault {fault!r} (have {FAULTS})")
        yield
