"""Env-axis data parallelism over ranks (PyTorch).

Counterpart of ``partmanip_tpu/parallel/mesh.py``, where GSPMD shards the
sim state and the rollouts over a device mesh's ``env`` axis, replicates
parameters, optimizer states, the observation RMS and the PRNG keys, and
inserts the gradient psum.  Here each rank is one process
(``torch.distributed``: NCCL with rank r on ``cuda:r``, or gloo), and the
same split is written out:

* the env of rank r holds global envs ``[r·E/N, (r+1)·E/N)`` only (its
  cabinets, its random draws: :func:`shard_draw`), and its physics runs on
  those rows (:func:`shard_physics_step`, the counterpart of the JAX
  module's shard_map'd kernel: the kernel sees the rank's rows and nothing
  else);
* what the JAX module replicates (:data:`REPLICATED_FIELDS`) is computed
  alike on every rank from the same seeds and from all-reduced values;
* every mean, variance, max and count over envs or rows is all-reduced
  (:func:`all_sum`, :func:`all_max`, :func:`mean`), and each loss is a sum
  over the rank's rows of the global minibatch divided by the global
  minibatch size, its gradients summed over the ranks
  (:func:`all_sum_grads`) before the optimizer step.

So an N-rank iteration computes what the one-process iteration computes, up
to the order of its sums.  :func:`launch` starts the ranks (one process
each, ``tcp://localhost:<free port>``) and returns each rank's result;
``train_torch.py --parallel.num_devices N`` goes through it.  The backend
is the caller's choice; nothing falls back to another.
"""

from __future__ import annotations

import datetime
import queue
import socket
import traceback
from typing import Callable, NamedTuple, Optional, Sequence

import torch

# the axis the ranks split (the JAX module's mesh axis)
ENV_AXIS = "env"

# The env extras that every rank holds whole and alike, being reductions
# over the envs of all ranks: the success rate at reset and the per-object
# success bitmap.  (What the JAX module's list also names, the parameters,
# optimizer states, RMS and generators, every rank holds alike by
# construction: same seeds, all-reduced inputs.)
REPLICATED_FIELDS = frozenset({"succ_rate", "success_objnum"})

# Physics steps run on a rank's env shard (an env with a mesh steps
# through shard_physics_step), the counterpart of the JAX module's count of
# shard_map'd traces.
SHARD_DISPATCH_COUNT = 0


class Mesh(NamedTuple):
    """This process's place among the ranks, which split ENV_AXIS."""
    rank: int
    size: int
    backend: str             # "nccl" or "gloo"
    device: torch.device     # where this rank's env and networks live


_ACTIVE_MESH: list = []


def activate(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the env, the trainer and the physics step of
    this process shard over (None: no sharding)."""
    _ACTIVE_MESH.clear()
    if mesh is not None:
        _ACTIVE_MESH.append(mesh)


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def make_mesh(num_devices: int, rank: int, backend: str, init_method: str,
              device: str = "cuda", timeout_s: float = 1800.0) -> Mesh:
    """Join the process group of ``num_devices`` ranks as ``rank``, on
    ``device``: ``cuda`` means ``cuda:rank``; ``cpu`` and an explicit
    ``cuda:k`` are every rank's."""
    import torch.distributed as dist
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the ranks run on the GPU unless "
                               "device 'cpu' is passed")
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("NCCL ranks need CUDA devices; use gloo on the CPU")
    dist.init_process_group(backend, init_method=init_method, world_size=num_devices,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(rank=rank, size=num_devices, backend=backend, device=dev)


def close(mesh: Optional[Mesh]) -> None:
    import torch.distributed as dist
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the env axis
# ----------------------------------------------------------------------

def env_ids(mesh: Optional[Mesh], num_envs: int):
    """The global env ids of this rank: ``range(r·E/N, (r+1)·E/N)``."""
    if mesh is None:
        return range(num_envs)
    if num_envs % mesh.size:
        raise ValueError(f"num_envs {num_envs} is not a multiple of the "
                         f"{mesh.size} ranks")
    n = num_envs // mesh.size
    return range(mesh.rank * n, (mesh.rank + 1) * n)


def shard_draw(mesh: Optional[Mesh], num_local: int, draw: Callable[[int], torch.Tensor]):
    """``draw(n)`` makes an ``[n, ...]`` random tensor from a generator that
    every rank holds alike: drawn at the global env count, this rank's rows
    kept, so that each env gets the numbers it gets in one process."""
    if mesh is None:
        return draw(num_local)
    lo = mesh.rank * num_local
    return draw(num_local * mesh.size)[lo:lo + num_local]


def shard_physics_step(mesh: Mesh, scene, state, pos_targets):
    """One physics step of this rank's envs: the scene and the state hold
    the rank's rows only, so the fused kernel runs on them as they are."""
    global SHARD_DISPATCH_COUNT
    from ..sim import engine
    SHARD_DISPATCH_COUNT += 1
    return engine.physics_step(scene, state, pos_targets)


# ----------------------------------------------------------------------
# collectives: every rank calls them in the same order
# ----------------------------------------------------------------------

def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    """``t`` reduced over the ranks (a new tensor on ``t``'s device).  NCCL
    reduces the CUDA tensor where it lies.  Under gloo a CUDA tensor is
    staged through the host: gloo reduces host memory (its own CUDA path
    copies there too), and a host copy works whatever CUDA support the
    gloo build has, also with several ranks on one card."""
    import torch.distributed as dist
    if mesh.backend == "gloo" and t.is_cuda:
        out = t.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(out, op=op)
        return out.to(t.device)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=op)
    return out


def all_sum(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (``t`` itself without a mesh)."""
    if mesh is None:
        return t
    import torch.distributed as dist
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


def all_max(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    if mesh is None:
        return t
    import torch.distributed as dist
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


def mean(mesh: Optional[Mesh], x: torch.Tensor, n: int) -> torch.Tensor:
    """The mean of ``x``'s elements over all ranks, ``n`` of them in all
    (``x.mean()`` without a mesh)."""
    if mesh is None:
        return x.mean()
    return all_sum(mesh, x.sum()) / n


def std(mesh: Optional[Mesh], x: torch.Tensor, m: torch.Tensor, n: int) -> torch.Tensor:
    """The population standard deviation of ``x``'s elements over all
    ranks about their mean ``m`` (``x.std(correction=0)`` without a
    mesh)."""
    if mesh is None:
        return x.std(correction=0)
    return torch.sqrt(all_sum(mesh, ((x - m) ** 2).sum()) / n)


def all_sum_grads(mesh: Optional[Mesh], params: Sequence[torch.Tensor],
                  extra: torch.Tensor = None):
    """Sum the parameters' ``.grad`` over the ranks in place (one
    all-reduce of their concatenation; a parameter without a gradient
    counts as zeros) and, with ``extra``, return its sum too."""
    if mesh is None:
        return extra
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + ([] if extra is None else [extra.detach().reshape(-1)]))
    flat = all_sum(mesh, flat)
    at = 0
    for p, g in zip(params, grads):
        p.grad = flat[at:at + g.numel()].view_as(p).clone()
        at += g.numel()
    return None if extra is None else flat[at:].reshape(extra.shape)


# ----------------------------------------------------------------------
# starting the ranks
# ----------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, num_devices, backend, device, init_method, args, results):
    mesh = make_mesh(num_devices, rank, backend, init_method, device)
    activate(mesh)
    try:
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        activate(None)
        close(mesh)


def launch(fn: Callable, num_devices: int, backend: str, device: str = "cuda",
           args: tuple = (), timeout_s: float = 3600.0) -> list:
    """Run ``fn(*args)`` on ``num_devices`` ranks, one new process each
    (``spawn``), rank r with :func:`make_mesh`'s group joined and its mesh
    active; returns their results in rank order (``fn`` and its result
    must pickle).  When a rank fails, the others are stopped and the
    failure is raised here with the rank's traceback.  Every process is
    joined before this returns."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, num_devices, backend, device, init_method, args, results))
             for r in range(num_devices)]
    for p in procs:
        p.start()
    got, failure = {}, None
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
    try:
        while len(got) < num_devices and failure is None:
            try:
                rank, ok, out = results.get(timeout=1.0)
                if ok:
                    got[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead:
                failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
            elif datetime.datetime.now() > deadline:
                failure = f"the ranks did not finish within {timeout_s} s"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(num_devices)]
