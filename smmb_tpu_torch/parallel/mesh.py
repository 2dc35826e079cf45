"""The process mesh of the parallel layer, its collectives and its launcher
(counterpart of smmb_tpu/parallel/mesh.py).

JAX runs one SPMD program over a (data × model) grid of devices and lets
``shard_map`` slice the operands. The port runs one process per rank, as
PyTorch does: every rank calls the same functions on its own blocks of the
operands, and the blocks meet through ``torch.distributed`` collectives.

Axis convention, as in JAX:
    "data"  — batch (M) sharding
    "model" — feature sharding of the ternary weight planes (N or K axis)

Rank r of the first data·model ranks of the world sits at
``(r // model, r % model)``, the row-major (data, model) grid JAX builds
over its device list; each axis line of the grid is one process group.

Every collective of the layer goes through the helpers below
(``all_reduce``, ``all_gather``, ``ring_shift``). A gloo world given CUDA
tensors stages each call through host memory explicitly, because gloo's
CUDA support is partial (its point-to-point ops and some collectives take
CPU tensors only); the kernels stay on the card, ``STAGED`` counts the
staged calls by op and each op is logged the first time it is staged.
NCCL takes the CUDA tensors as they are. The backend is whatever the caller
initialised the world with: nothing here tries one backend and then another.

``run_world`` starts a world of ranks on one machine (the torch counterpart
of JAX building a mesh over virtual devices): one ``spawn`` process per
rank, a TCP rendezvous on a free localhost port, and each rank's result
returned to the caller.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import logging
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist

from smmb_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# what the first half of the parallel layer leaves to the second
MOE_SLICE = ("MoE under the parallel layer (ep_moe, tp_moe, MoE blocks under TP or PP) "
             "belongs to a later slice of the port")
LORA_SLICE = "LoRA adapters under TP or SP belong to a later slice of the port"

STAGED = collections.Counter()  # collective calls staged through host memory, by op
CALLS = collections.Counter()  # collective calls issued, by (op, axis)
_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class World:
    """What ``run_world`` tells each rank's function about its process."""

    rank: int
    size: int
    backend: str
    device: torch.device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The rank's view of a (data × model) grid of ranks.

    ``groups[axis]`` is the process group of the rank's line along ``axis``
    (None when there is no world: a one-rank mesh, whose collectives are
    the identity); ``lines[axis]`` the global ranks of that line in order.
    A rank of the world beyond data·model is not a ``member``.
    """

    data: int
    model: int
    rank: int
    backend: str | None
    device: torch.device
    groups: dict
    lines: dict

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def member(self) -> bool:
        return self.rank < self.size

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """The rank's coordinate along ``axis``."""
        return self.rank // self.model if axis == DATA_AXIS else self.rank % self.model


_MESHES: dict = {}


def make_mesh(data: int = 1, model: int | None = None, *, device=None,
              backend: str | None = None) -> Mesh:
    """The (data × model) mesh over the initialised world, one process group
    per axis line (every rank of the world must call this, in the same
    order: creating a group is collective). ``model=None`` takes the world's
    remaining ranks. ``device`` is the rank's device (None = its current
    CUDA card). ``backend`` defaults to the world's; another one raises.
    Without an initialised world only the one-rank mesh exists.

    Meshes are cached by their arguments, so a second call with the same
    ones makes no new groups.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        model = 1 if model is None else model
        if data * model != 1:
            raise ValueError(f"a {data}x{model} mesh needs an initialised world of "
                             f"{data * model} ranks (see run_world)")
        return Mesh(1, 1, 0, backend, dev, {DATA_AXIS: None, MODEL_AXIS: None},
                    {DATA_AXIS: [0], MODEL_AXIS: [0]})
    world, rank = dist.get_world_size(), dist.get_rank()
    world_backend = str(dist.get_backend())
    if backend is not None and backend != world_backend:
        raise ValueError(f"backend {backend!r} asked for a {world_backend!r} world")
    if model is None:
        if world % data:
            raise ValueError(f"{world} ranks not divisible by data={data}")
        model = world // data
    if data * model > world:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, "
                         f"the world has {world}")
    key = (data, model, world_backend, str(dev))
    if key in _MESHES:
        return _MESHES[key]
    groups, lines = {DATA_AXIS: None, MODEL_AXIS: None}, {DATA_AXIS: [], MODEL_AXIS: []}
    for d in range(data):  # model-axis lines
        ranks = [d * model + j for j in range(model)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[MODEL_AXIS], lines[MODEL_AXIS] = g, ranks
    for j in range(model):  # data-axis lines
        ranks = [d * model + j for d in range(data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[DATA_AXIS], lines[DATA_AXIS] = g, ranks
    mesh = Mesh(data, model, rank, world_backend, dev, groups, lines)
    _MESHES[key] = mesh
    return mesh


def single_device_mesh(device=None) -> Mesh:
    """The one-rank mesh (no world needed)."""
    dev = resolve_device(device)
    return Mesh(1, 1, 0, None, dev, {DATA_AXIS: None, MODEL_AXIS: None},
                {DATA_AXIS: [0], MODEL_AXIS: [0]})


def _check_member(mesh: Mesh) -> None:
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the {mesh.data}x{mesh.model} mesh")


def _to_wire(t: torch.Tensor, mesh: Mesh, op: str) -> torch.Tensor:
    """A contiguous copy of ``t`` for a collective to work on: in host memory
    when the mesh's backend is gloo and ``t`` is on the GPU (staged: counted
    in STAGED, logged once an op), else on ``t``'s device."""
    if mesh.backend == "gloo" and t.is_cuda:
        if not STAGED[op]:
            _log.info("gloo world: staging %s of CUDA tensors through host memory", op)
        STAGED[op] += 1
        return t.detach().to("cpu", copy=True).contiguous()
    return t.detach().clone().contiguous()


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """The elementwise sum (or ``op="max"``) of ``t`` over the rank's
    ``axis`` line, as a new tensor on ``t``'s device (``psum``/``pmax``)."""
    _check_member(mesh)
    group = mesh.groups[axis]
    if group is None:
        return t
    CALLS[("all_reduce", axis)] += 1
    buf = _to_wire(t, mesh, "all_reduce")
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(buf, op=red, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The ``axis`` line's blocks of ``t`` (equal shapes) concatenated along
    ``dim`` in line order, on ``t``'s device."""
    _check_member(mesh)
    group = mesh.groups[axis]
    if group is None:
        return t
    CALLS[("all_gather", axis)] += 1
    buf = _to_wire(t, mesh, "all_gather")
    parts = [torch.empty_like(buf) for _ in mesh.lines[axis]]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


class _Shift:
    """A ring exchange in flight; ``wait()`` returns the received tensor."""

    def __init__(self, reqs, recv, device):
        self._reqs, self._recv, self._device = reqs, recv, device

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        return self._recv.to(self._device)


def ring_shift_start(t: torch.Tensor, mesh: Mesh, axis: str) -> _Shift:
    """Start sending ``t`` to the next rank of the ``axis`` ring and
    receiving the previous rank's block (``ppermute`` by ``i → i + 1``), as
    one ``batch_isend_irecv``; the caller computes meanwhile and then calls
    ``wait()``."""
    _check_member(mesh)
    line = mesh.lines[axis]
    n = len(line)
    if mesh.groups[axis] is None or n == 1:
        return _Shift([], t, t.device)
    CALLS[("ring_shift", axis)] += 1
    i = mesh.index(axis)
    send = _to_wire(t, mesh, "send/recv")
    recv = torch.empty_like(send)
    group = mesh.groups[axis]
    ops = [dist.P2POp(dist.isend, send, line[(i + 1) % n], group),
           dist.P2POp(dist.irecv, recv, line[(i - 1) % n], group)]
    return _Shift(dist.batch_isend_irecv(ops), recv, t.device)


def ring_shift(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``ring_shift_start(...).wait()``."""
    return ring_shift_start(t, mesh, axis).wait()


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's block of a global ``x`` batch-sharded over ``data``
    (leading axis; JAX's ``P(DATA_AXIS, ...)``)."""
    d = mesh.axis_size(DATA_AXIS)
    if x.shape[0] % d:
        raise ValueError(f"batch {x.shape[0]} not divisible by data axis {d}")
    b = x.shape[0] // d
    i = mesh.index(DATA_AXIS)
    return x[i * b:(i + 1) * b]


def local_cols(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's block of ``x`` feature-sharded over ``model`` (last axis;
    JAX's ``P(..., MODEL_AXIS)``)."""
    n = mesh.axis_size(MODEL_AXIS)
    if x.shape[-1] % n:
        raise ValueError(f"width {x.shape[-1]} not divisible by model axis {n}")
    w = x.shape[-1] // n
    j = mesh.index(MODEL_AXIS)
    return x[..., j * w:(j + 1) * w]


# ---------------------------------------------------------------- launcher
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, size, backend, device, port, args, out, timeout_s):
    try:
        torch.set_num_threads(1)  # one rank a core; the ranks share the host
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            value = fn(World(rank, size, backend, dev), *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        out.put((rank, True, value))
    except BaseException:  # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn, world: int, *, backend: str, device=None, args: tuple = (),
              timeout: float = 600.0) -> list:
    """Run ``fn(World, *args)`` on ``world`` ranks, one ``spawn`` process
    each, in a ``backend`` world ("gloo" or "nccl"); return the ranks'
    results in rank order. ``device`` "cpu", or "cuda" (None): rank r takes
    card r % device_count, so ranks share cards when there are fewer.
    ``fn`` must be importable (a module-level function) and return
    picklable values (numpy arrays, not tensors). A rank that fails or
    dies stops the world and raises here with its traceback."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, dev.type, port, args, out, timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if dead:
                    raise RuntimeError(f"ranks {dead} of {world} died without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world}-rank world did not finish in {timeout} s")
                continue
            if not ok:
                failed = {rank: value}
                end = time.monotonic() + 5.0  # the others' reports, for the first cause
                while time.monotonic() < end and len(failed) + len(results) < world:
                    try:
                        r, ok_r, v = out.get(timeout=0.5)
                    except queue_mod.Empty:
                        continue
                    if not ok_r:
                        failed[r] = v
                raise RuntimeError("\n".join(f"rank {r} of {world} failed:\n{v}"
                                             for r, v in sorted(failed.items())))
            results[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [results[r] for r in range(world)]
