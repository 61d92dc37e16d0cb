"""Device mesh and batch sharding for scenario batches over several cards
and processes.

Counterpart of ``cheeta_mpc_tpu/parallel/mesh.py``. The scaling axis is
the scenario batch: thousands of MPC instances (gait x terrain x command
grids) solved at once, split over the devices so that each holds
batch/n_devices solves. A solve needs no communication between devices;
collectives carry only the metric reductions.

What differs from the JAX package: a :class:`Mesh` is the list of this
process's devices (``torch.cuda.device_count()`` cards by default) plus its
place in a ``torch.distributed`` process group, where JAX has one global
``jax.sharding.Mesh``. Sharding is explicit: :func:`shard_batch` cuts the
leading axis into one slice per device, :func:`sharded_batch_solver` runs
each slice on its device with that device's own solver (a CUDA graph per
device for the solvers the port's entry points build) and gathers the
results; :func:`host_local_batch_to_global` is an ``all_gather`` over the
processes and :func:`aggregate_fleet_health` one ``all_reduce`` SUM and one
MAX, after each process has reduced its rows. ``torch.distributed`` takes
the place of ``jax.distributed``: gloo on the CPU, nccl on the cards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cheeta_mpc_tpu_torch.core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's devices along one batch axis, and its place among
    the processes that share the batch. ``distributed`` says that the
    collectives of this module run over the process group (a mesh of
    :func:`make_global_mesh` after :func:`initialize_distributed`, a group
    of one process included)."""

    devices: tuple
    process_count: int = 1
    process_index: int = 0
    distributed: bool = False


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    card of this process, ``torch.cuda.device_count()``; without a card
    the default raises). ``devices`` may name the CPU, once per stand-in
    device."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> int:
    """Join the process group (``torch.distributed.init_process_group``):
    the processes meet at ``coordinator_address`` (``host:port``, a TCP
    store), after which the collectives of this module span them. The
    backend is nccl where a card is present and gloo elsewhere, unless
    given. Returns the process index.

    No-op (returns 0) when called without arguments, so callers can use it
    unconditionally in a single-process setting."""
    if coordinator_address is None and num_processes is None:
        return 0
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def _process_device() -> torch.device:
    """The device a collective of this process runs on."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_global_mesh() -> Mesh:
    """1-D mesh over the processes of the group (after
    :func:`initialize_distributed`), each process with its device: its
    current card under nccl, the CPU under gloo. Without a process group
    it is this process alone."""
    if not dist.is_initialized():
        return Mesh((_process_device(),))
    return Mesh((_process_device(),), dist.get_world_size(),
                dist.get_rank(), distributed=True)


def _map(fn, tree):
    """``fn`` on every array leaf (tensor or numpy array) of a nest of
    tuples, NamedTuples, lists, dicts and dataclasses."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_make"):
        return tree._make(_map(fn, v) for v in tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _leaves(tree) -> list:
    out: list = []
    _map(out.append, tree)
    return out


def shard_batch(mesh: Mesh, tree) -> list:
    """One copy of ``tree`` per device of ``mesh``, each holding its slice
    of the leading (batch) axis of every array, on its device. The batch
    must divide evenly over the devices."""
    n = len(mesh.devices)
    sizes = {int(a.shape[0]) for a in _leaves(tree)}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"batch: leading dims {sorted(sizes)} do not "
                         f"split evenly over {n} device(s)")
    per = next(iter(sizes)) // n
    return [_map(lambda a, i=i, d=d: torch.as_tensor(
        a[i * per:(i + 1) * per]).to(d), tree)
        for i, d in enumerate(mesh.devices)]


def _concat(parts: list, device):
    """Leaves of per-device results -> one result, concatenated on the
    leading axis on ``device``."""
    flat = [_leaves(p) for p in parts]
    joined = iter([torch.cat([f[j].to(device) for f in flat])
                   for j in range(len(flat[0]))])
    return _map(lambda _: next(joined), parts[0])


def sharded_batch_solver(build: Callable, mesh: Mesh) -> Callable:
    """A batch solver over ``mesh``: ``build(device)`` returns the solver of
    one device (for example ``lambda d: build_convex_mpc(cfg, ipm,
    device=d)``, one CUDA graph per signature on its card), built once per
    device here. The returned function takes leading-batch-axis arguments
    (batch divisible by the number of devices), solves each device's slice
    on that device, the launches of all devices issued before any result
    is waited for, and returns the results concatenated on the first
    device of the mesh."""
    solvers = [build(d) for d in mesh.devices]

    def fn(*args):
        shards = shard_batch(mesh, tuple(args))
        outs = [solve(*shard) for solve, shard in zip(solvers, shards)]
        return _concat(outs, mesh.devices[0])

    return fn


def host_local_batch_to_global(mesh: Mesh, tree):
    """Assemble the global batch from every process's local rows (each
    process supplies batch/process_count rows, in process order): one
    ``all_gather`` per array, on the process's device. The multi-host feed
    path: observations produced where they arise, solved and read
    globally. Without a process group the local batch is the global one."""
    if not mesh.distributed:
        return tree
    dev = mesh.devices[0]

    def gather(a):
        t = torch.as_tensor(a).to(dev).contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.process_count)]
        dist.all_gather(parts, t)
        return torch.cat(parts)

    return _map(gather, tree)


class FleetHealth(NamedTuple):
    """Solver health of the whole fleet, one record for all processes:
    counts and moments of the batch's solver outcomes (the multi-device
    analogue of the per-solve health surface the reference prints per
    robot, MultipleShootingSolver.cpp:190-191 and the HPIPM status / NaN
    guard of HpipmInterface.cpp:303-328)."""

    n_solves: torch.Tensor  # total batch elements over all processes
    n_converged: torch.Tensor  # convergence code STEPSIZE/METRICS/PRIMAL
    n_nonfinite: torch.Tensor  # failed elements (NaN/Inf merit)
    mu_mean: torch.Tensor  # mean final IPM complementarity (finite merit)
    mu_max: torch.Tensor  # worst complementarity anywhere
    merit_mean: torch.Tensor  # mean merit (fleet objective health)


def aggregate_fleet_health(mesh: Mesh, qp_mu, convergence,
                           merit) -> FleetHealth:
    """Reduce per-element solver health over the whole fleet.

    Args are batch-leading arrays (the ``ScpResult`` / ``CentroidalSolution``
    fields of this process's rows). Each process reduces its rows to five
    sums and a max first, then one ``all_reduce`` SUM and one MAX join the
    processes, so the traffic is O(1) per process whatever the batch.
    Elements with a non-finite merit are counted, not thrown, and left out
    of the moments. Returns 0-d tensors on the mesh's first device, which
    carries the collectives (int32 counts, float64 moments)."""
    from cheeta_mpc_tpu_torch.solvers.scp import (CONV_METRICS, CONV_PRIMAL,
                                                  CONV_STEPSIZE)
    dev = mesh.devices[0]
    mu, conv, mer = (torch.as_tensor(a).to(dev)
                     for a in (qp_mu, convergence, merit))
    mu, mer = mu.double(), mer.double()
    finite = torch.isfinite(mer)
    conv_ok = ((conv == CONV_STEPSIZE) | (conv == CONV_METRICS)
               | (conv == CONV_PRIMAL))
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    sums = torch.stack([
        torch.full((), mu.shape[0], dtype=torch.float64, device=dev),
        conv_ok.double().sum(), (~finite).double().sum(),
        torch.where(finite, mu, zero).sum(),
        torch.where(finite, mer, zero).sum()])
    mu_max = torch.where(finite, mu, zero).amax()
    if mesh.distributed:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(mu_max, op=dist.ReduceOp.MAX)
    n, n_conv, n_bad, mu_sum, mer_sum = sums.unbind()
    denom = torch.clamp(n - n_bad, min=1.0)
    return FleetHealth(n_solves=n.to(torch.int32),
                       n_converged=n_conv.to(torch.int32),
                       n_nonfinite=n_bad.to(torch.int32),
                       mu_mean=mu_sum / denom, mu_max=mu_max,
                       merit_mean=mer_sum / denom)
