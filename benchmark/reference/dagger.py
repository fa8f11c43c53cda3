"""The reference's DAgger update (``algos/dagger._dagger_iteration`` after
its collection): ``n_updates × n_minibatches`` Adam steps (optax's adam, no
clip) on the mean squared gap between the teacher's and the student's
activated actions, each step's gradient the mean over its chunks, in plain
PyTorch on a parameter dict.

It follows the program's first iterations from the benchmark's seeded
student.  Each iteration takes the ring buffer's valid rows as the
program's collection left them (the student's point clouds in bf16 and
the teacher's state observations: outputs of the program's env, judged
on their own by ``envcheck``) and the program's minibatch indices (draws
of its generator); the teacher's labels are the reference's own, from the
checkpoint file.  While the buffer holds fewer than 16 rows an iteration
leaves the student as it was (its optimizer state advances), as the
program's does."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import nets, teacher

MIN_UPDATE_ROWS = 16      # below this many buffer rows an iteration trains nothing


def student_act(p, x, shape: dict, prec: str):
    return nets.activate(nets.pointnet(p, "actor", x, shape["points"], shape["proprio"], prec),
                         shape["clip"])


def run(weights: Dict[str, torch.Tensor], tea: tuple, iterations: List[dict], shape: dict,
        prec: str = "f32", teacher_prec: str = "f32") -> dict:
    """Follow ``iterations`` from ``weights``; ``tea`` is (teacher params,
    its RMS).  Returns each iteration's mean loss, each Adam step's loss,
    the first gradient and the parameters after the last iteration."""
    p = {k: v.detach().clone().float() for k, v in weights.items()}
    names = list(p)
    opt = nets.Adam(p, names, None)
    out = {"loss": [], "step_loss": []}
    for it in iterations:
        before = dict(p)
        stu, tea_obs = it["stu_rows"].float(), it["tea_rows"]
        labels = teacher.act(tea[0], tea[1], tea_obs, shape["clip"], teacher_prec)
        losses = []
        with nets.precision(prec):
            for idx in it["indices"]:
                chunks = idx.reshape(shape["n_chunks"], -1)
                leaves = {n: p[n].detach().requires_grad_(True) for n in names}
                q = {**p, **leaves}
                total, lsum = None, 0.0
                for c in chunks:
                    loss = ((labels[c] - student_act(q, stu[c], shape, prec)) ** 2).mean()
                    g = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
                    g = [torch.zeros_like(leaves[n]) if x is None else x for n, x in zip(names, g)]
                    total = g if total is None else [a + b for a, b in zip(total, g)]
                    lsum += float(loss.detach())
                opt.step({n: t / len(chunks) for n, t in zip(names, total)}, it["lr"])
                losses.append(lsum / len(chunks))
                out["step_loss"].append(losses[-1])
        out["loss"].append(sum(losses) / len(losses))
        if stu.shape[0] < MIN_UPDATE_ROWS:       # the student keeps its parameters;
            p.update(before)                      # Adam's state has advanced
    out["first_grad"] = opt.first_grad
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out
