"""Process groups, ranks and the collectives of the multi-device layer.

The JAX package has no counterpart: there GSPMD and ``shard_map`` insert the
collectives into one program over a device mesh. The port runs one process
a rank instead, ``torch.distributed`` between them:

- :func:`init` joins a process group through a ``FileStore`` (no network
  address is needed): NCCL on CUDA, one card a rank; gloo on the CPU. Two
  ranks can share one card only through gloo, asked for with
  ``backend="gloo"``; the collectives then stage CUDA tensors through host
  memory. NCCL failing never turns into gloo, and a world larger than the
  card count raises.
- :class:`Grid` is the 2-D rank grid ``(data, model)``, the counterpart of
  ``make_mesh`` (``pathnet_tpu/parallel/mesh.py:39-47``): rank ``r`` sits at
  ``(r // model, r % model)``, as JAX lays its devices out, with one process
  group for each row and column.
- :func:`spawn` runs a function on ``world`` ranks, each its own Python
  process, returns each rank's result, and raises when a rank fails or the
  timeout passes, after killing every process it started.
- The collectives: :func:`all_reduce`, :func:`all_gather`,
  :func:`reduce_scatter` (each tiled along dim 0, with an autograd function
  where a gradient flows through it) and :func:`ring_step`, one
  ``batch_isend_irecv`` step of a ring.

A rank's process runs :func:`rank_main` on the task file :func:`spawn`
writes.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..device import resolve_device

BACKENDS = ("nccl", "gloo")
GROUP_TIMEOUT_S = 1800.0   # a collective's wait, when spawn has no deadline
PACKAGE_ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the grid as this rank sees it: its process group (None
    when the axis has one rank), its size, this rank's place on it, and
    whether CUDA tensors are staged through host memory (gloo on a card)."""

    group: Any
    size: int
    index: int
    staged: bool = False

    def peer(self, offset: int) -> int:
        """The global rank ``offset`` places along the axis (mod its size)."""
        return dist.get_global_rank(self.group, (self.index + offset) % self.size)


# the axis of one process, on which every collective returns its input
SINGLE = Axis(None, 1, 0)


@dataclasses.dataclass
class Grid:
    """This rank's place in the ``(data, model)`` grid of a process group."""

    rank: int
    world: int
    data: int
    model: int
    device: torch.device
    backend: str
    data_axis: Axis
    model_axis: Axis

    @property
    def staged(self) -> bool:
        return self.data_axis.staged


def grid_shape(world: int, data_axis: Optional[int] = None, model_axis: int = 1):
    """``(data, model)`` for ``world`` ranks, as ``make_mesh`` sizes its mesh:
    all data-parallel by default."""
    data = data_axis or world // model_axis
    if data < 1 or model_axis < 1 or data * model_axis != world:
        raise ValueError(f"a {data} x {model_axis} grid does not hold {world} ranks")
    return data, model_axis


def check_world(world: int, device: torch.device, backend: str) -> None:
    """Raise for a world this device and backend cannot hold."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if world < 1:
        raise ValueError(f"world={world}")
    if device.type == "cpu" and backend != "gloo":
        raise ValueError("ranks on the CPU need backend='gloo'")
    if device.type == "cuda" and backend == "nccl":
        count = torch.cuda.device_count()
        if world > count:
            raise RuntimeError(
                f"{world} NCCL ranks need {world} CUDA devices, and {count} "
                f"{'is' if count == 1 else 'are'} visible: NCCL takes one card a rank "
                "(two ranks share a card only with backend='gloo')")


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init(rank: int, world: int, store_path: str,
         device: Optional[Union[str, torch.device]] = None, backend: Optional[str] = None,
         data_axis: Optional[int] = None, model_axis: int = 1,
         timeout_s: float = 300.0) -> Grid:
    """Join the process group of ``world`` ranks as ``rank`` through the
    ``FileStore`` at ``store_path`` and return this rank's :class:`Grid`.

    ``device=None`` means CUDA. Under NCCL rank ``r`` takes card ``r``; under
    gloo every rank takes ``device`` (on a card: staged through the host,
    which this prints)."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    check_world(world, dev, backend)
    data, model = grid_shape(world, data_axis, model_axis)
    staged = False
    if dev.type == "cuda":
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        else:
            dev = torch.device("cuda", 0 if dev.index is None else dev.index)
            staged = True
            print(f"rank {rank}: gloo on {dev}, CUDA tensors staged through host memory",
                  flush=True)
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return _grid(rank, world, data, model, dev, backend, staged)


def regrid(grid: Grid, data_axis: Optional[int] = None, model_axis: int = 1) -> Grid:
    """The same ranks laid out as another ``data x model`` grid (every rank
    calls it alike: it creates the new shape's groups)."""
    data, model = grid_shape(grid.world, data_axis, model_axis)
    return _grid(grid.rank, grid.world, data, model, grid.device, grid.backend, grid.staged)


def _grid(rank, world, data, model, dev, backend, staged) -> Grid:
    # every rank creates every group, in one order
    rows = [list(range(d * model, (d + 1) * model)) for d in range(data)]
    cols = [list(range(m, world, model)) for m in range(model)]
    groups = {tuple(ranks): _group(ranks, world) for ranks in cols + rows}
    di, mi = rank // model, rank % model
    return Grid(rank=rank, world=world, data=data, model=model, device=dev, backend=backend,
                data_axis=Axis(groups[tuple(cols[mi])], data, di, staged),
                model_axis=Axis(groups[tuple(rows[di])], model, mi, staged))


def _group(ranks: List[int], world: int):
    """The process group of ``ranks``: None for one rank, the default group
    for all of them, else a new group (which every rank must create)."""
    if len(ranks) == 1:
        return None
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- collectives

def _host(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    return t.cpu() if axis.staged and t.is_cuda else t


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``t`` over the axis, in place; returns ``t``."""
    if axis.size == 1:
        return t
    h = _host(t, axis)
    dist.all_reduce(h, group=axis.group)
    if h is not t:
        t.copy_(h)
    return t


def _all_gather(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    if axis.size == 1:
        return t.clone()
    h = _host(t.contiguous(), axis)
    parts = [torch.empty_like(h) for _ in range(axis.size)]
    dist.all_gather(parts, h, group=axis.group)
    return torch.cat(parts).to(t.device)


def _reduce_scatter(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    if axis.size == 1:
        return t.clone()
    if t.shape[0] % axis.size:
        raise ValueError(f"reduce_scatter: {t.shape[0]} rows over {axis.size} ranks")
    k = t.shape[0] // axis.size
    if axis.staged or not t.is_cuda:
        # gloo: a sum over the axis, then this rank's rows
        h = _host(t, axis).clone()
        dist.all_reduce(h, group=axis.group)
        return h[axis.index * k:(axis.index + 1) * k].to(t.device)
    out = torch.empty((k, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=axis.group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _all_gather(t, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.axis), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _reduce_scatter(t, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.axis), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return all_reduce(t.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's ``t`` in rank order along dim 0. Backward: the
    reduce-scatter of the gradient (each rank's block gets the sum of every
    rank's gradient for it)."""
    return _AllGather.apply(t, axis)


def reduce_scatter(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over the axis of ``t [size * k, ...]``, this rank's ``k``
    rows. Backward: the all-gather of the gradient."""
    return _ReduceScatter.apply(t, axis)


def all_reduce_sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over the axis, out of place. Backward: the identity, which is
    the gradient when every rank computes the same loss from the replicated
    sum (JAX's ``psum`` under ``shard_map`` with a replicated output)."""
    return _AllReduce.apply(t, axis)


class RingStep:
    """One posted ring step: ``send`` goes to the previous rank of the axis
    and ``recv`` comes from the next one (``reverse``: the other way round).
    :meth:`wait` completes it."""

    def __init__(self, send: torch.Tensor, recv: torch.Tensor, axis: Axis,
                 reverse: bool = False):
        self.recv = recv
        self._send = _host(send.contiguous(), axis)
        self._buf = _host(recv, axis)
        to, frm = (1, -1) if reverse else (-1, 1)
        ops = [dist.P2POp(dist.isend, self._send, axis.peer(to), group=axis.group),
               dist.P2POp(dist.irecv, self._buf, axis.peer(frm), group=axis.group)]
        self._reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        if self._buf is not self.recv:
            self.recv.copy_(self._buf)
        return self.recv


def ring_step(send: torch.Tensor, axis: Axis, reverse: bool = False) -> RingStep:
    """Post the rotation of ``send`` one place around the axis: after
    :meth:`RingStep.wait` this rank holds what the next rank sent (with
    ``reverse``, what the previous rank sent)."""
    return RingStep(send, torch.empty_like(send), axis, reverse)


# --------------------------------------------------------------------- spawn

def _module_of(fn: Callable) -> tuple:
    """``(import root, module name, qualified name)`` of a module-level
    function; a ``__main__`` module is imported by the name ``-m`` ran it
    under, a script by its file name."""
    mod = sys.modules[fn.__module__]
    path = Path(mod.__file__).resolve()
    name = fn.__module__
    if name == "__main__":
        spec = getattr(mod, "__spec__", None)
        name = spec.name if spec is not None else path.stem
    root = path.parent
    for _ in range(name.count(".")):
        root = root.parent
    if path.name == "__init__.py":
        root = root.parent
    return str(root), name, fn.__qualname__


def spawn(fn: Callable, world: int, device: Optional[Union[str, torch.device]] = None,
          timeout_s: Optional[float] = 600.0, args: Sequence = (),
          kwargs: Optional[dict] = None,
          backend: Optional[str] = None, data_axis: Optional[int] = None,
          model_axis: int = 1, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(grid, *args, **kwargs)`` on ``world`` ranks and return each
    rank's result, in rank order.

    ``fn`` is a module-level function (it is imported by name in each rank);
    ``args``, ``kwargs`` and the results are pickled (pass numpy arrays or
    CPU tensors). Each rank is a Python process running :func:`rank_main`
    with ``threads`` torch threads (default: the cores shared out).
    Raises ``RuntimeError`` with the rank's traceback when a rank fails, and
    ``TimeoutError`` when ``timeout_s`` passes (None: no deadline; a
    collective that waits past ``GROUP_TIMEOUT_S`` still fails its rank);
    either way every rank's process is killed first."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    check_world(world, dev, backend)
    grid_shape(world, data_axis, model_axis)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory(prefix="pathnet-ranks-") as tmp:
        task = os.path.join(tmp, "task.pkl")
        with open(task, "wb") as f:
            pickle.dump({"fn": _module_of(fn), "args": tuple(args), "kwargs": kwargs or {},
                         "world": world, "device": str(dev), "backend": backend,
                         "data_axis": data_axis, "model_axis": model_axis,
                         "timeout_s": timeout_s or GROUP_TIMEOUT_S, "threads": threads,
                         "store": os.path.join(tmp, "store")}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(PACKAGE_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        procs = [subprocess.Popen([sys.executable, "-c", _RANK_MAIN, task, str(r)], env=env)
                 for r in range(world)]
        try:
            _wait_all(procs, tmp, timeout_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _wait_all(procs: List[subprocess.Popen], tmp: str, timeout_s: Optional[float]) -> None:
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        codes = [p.poll() for p in procs]
        for r, c in enumerate(codes):
            if c not in (None, 0):
                err = os.path.join(tmp, f"err{r}.txt")
                why = Path(err).read_text() if os.path.exists(err) else f"exit code {c}"
                raise RuntimeError(f"rank {r} of {len(procs)} failed:\n{why}")
        if all(c == 0 for c in codes):
            return
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(f"{len(procs)} ranks did not finish within {timeout_s:.0f} s")
        time.sleep(0.05)


_RANK_MAIN = ("import sys; from pathnet_tpu_torch.parallel.comm import rank_main; "
              "sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))")


def rank_main(task_path: str, rank: int) -> int:
    """One rank of :func:`spawn`: join the group, run the task's function,
    write its result (or the traceback) beside the task file."""
    tmp = os.path.dirname(task_path)
    with open(task_path, "rb") as f:
        task = pickle.load(f)
    try:
        torch.set_num_threads(task["threads"])
        root, name, qual = task["fn"]
        if root not in sys.path:
            sys.path.insert(0, root)
        fn = importlib.import_module(name)
        for part in qual.split("."):
            fn = getattr(fn, part)
        grid = init(rank, task["world"], task["store"], task["device"], task["backend"],
                    task["data_axis"], task["model_axis"], task["timeout_s"])
        result = fn(grid, *task["args"], **task["kwargs"])
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        shutdown()
        return 0
    except Exception:
        Path(os.path.join(tmp, f"err{rank}.txt")).write_text(traceback.format_exc())
        traceback.print_exc()
        return 1

