"""Worker groups for :class:`repro_torch.core.backend.MeshBackend`, and
the plans of the production meshes that the dry runs size programs for.

Port of ``repro/launch/mesh.py``.  Its two halves:

- **The plan** (:class:`MeshPlan`, :func:`make_production_mesh`,
  :func:`data_axes_for`, :data:`HARDWARE`): axis names and sizes of a
  mesh of H100s, touching no device and starting no process, for
  ``launch/specs.py``, ``launch/dryrun.py`` and ``launch/dryrun_dssfn.py``.
  ``repro``'s ``make_mesh_compat`` has no counterpart: it builds a
  ``jax`` mesh of devices, and nothing here lowers for one.
- **The (data, model) grid** (:class:`ModelGroup`,
  :func:`make_host_mesh`), the port of ``make_host_mesh(model_parallel)``:
  the W ranks of one worker group laid out as W / model_parallel data
  rows by model_parallel columns in ``repro``'s rank order, with a
  :class:`Transport` for the whole group, one for this rank's model row
  and one for its data column.  ``sharding/parallel.py`` runs a model
  over it.
- **The runtime** (below), the port of ``make_worker_mesh``.  The reference lays
its M workers on a 1-D ``workers`` mesh, one per device slot; here the
worker program runs in W processes (ranks) of a ``torch.distributed``
process group, and each rank holds a contiguous block of M/W workers as
one stacked ``(M/W, ...)`` tensor.  With W = M this is the reference's
layout; a block of workers per rank lets one card run the paper's M=20.

:func:`make_worker_group` returns a :class:`WorkerGroup` three ways:

- inside a ``torchrun`` launch (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``
  in the environment), it joins that group;
- with ``ranks`` of None or 1 otherwise, it builds a one-rank group in
  this process (no global ``torch.distributed`` state is touched);
- :func:`spawn_workers` starts W ranks (``spawn`` context, a
  ``FileStore`` in a temporary directory) and hands each its group.

A rank's card is ``cuda:(local_rank % device_count)``.  The process
group's backend follows the device: ``nccl`` on the card, ``gloo`` on the
CPU; ``gloo`` on the card only when the caller names it.  Nothing
switches backend because another failed.  Every group has a timeout (at
most 120 s), and :func:`spawn_workers` joins its ranks within a bound
and kills them past it, so a rank that dies cannot leave the others
waiting forever.

:class:`Transport` is the only code that moves tensors between ranks.
Gloo's pairs run on the host, so under ``gloo`` a card tensor is staged
explicitly through a pinned host buffer and back (``describe()`` says
``gloo host-staged``); NCCL and CPU tensors go as they are.  It counts
what it carries by kind (``all-reduce``, ``collective-permute``,
``all-gather``, ``reduce-scatter``, ``barrier``), by kind and payload
dtype, and by bytes (the payload this rank hands in), and
the host time spent in it.  :data:`PROCESS_TALLY` adds up the collectives
of every transport of this process, so a check can tell whether any ran.
"""
from __future__ import annotations

import datetime
import functools
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

@dataclass(frozen=True)
class MeshPlan:
    """A mesh of ``prod(shape)`` devices with named axes: a plan, not a
    group of processes (``repro``'s ``Mesh`` stands in its place in the
    planners' signatures)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape) or min(self.shape, default=1) < 1:
            raise ValueError(f"a plan needs one size >= 1 per axis, got "
                             f"{self.axis_names} and {self.shape}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def name(self) -> str:
        return "x".join(map(str, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshPlan:
    """The reference's two production meshes as plans of H100s: 256 as
    (data=16, model=16), or 512 as (pod=2, data=16, model=16), where the
    ``pod`` axis is one more data-parallel dimension (the batch shards
    over ``("pod", "data")``)."""
    if multi_pod:
        return MeshPlan(("pod", "data", "model"), (2, 16, 16))
    return MeshPlan(("data", "model"), (16, 16))


def data_axes_for(plan: MeshPlan) -> tuple[str, ...]:
    """The plan's data-parallel axes, in mesh order."""
    return tuple(a for a in plan.axis_names if a in ("pod", "data"))


#: One NVIDIA H100 SXM5 and its links, the rates the dry runs' roofline
#: terms divide by (dense rates, no sparsity).
HARDWARE = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5: 989 TFLOP/s dense
    # bf16 on the tensor cores (1,979 with sparsity).
    "peak_flops_bf16": 989e12,
    # The same data sheet: 80 GB of HBM3 at 3.35 TB/s.
    "hbm_bandwidth": 3.35e12,
    "hbm_bytes": 80e9,
    # The same data sheet: NVLink 4 at 900 GB/s per GPU, both directions
    # together, so 450 GB/s each way, among the 8 GPUs of one HGX H100
    # board (NVLink Switch within the node).
    "nvlink_bandwidth": 450e9,
    "gpus_per_node": 8,
    # Between nodes: one 400 Gb/s NDR InfiniBand adapter (ConnectX-7) per
    # GPU, as in NVIDIA's DGX H100 reference design: 50 GB/s each way.
    "internode_bandwidth": 50e9,
}


def link_bandwidth(group_size: int) -> float:
    """Bytes per second each way that a collective over ``group_size``
    GPUs moves per GPU: NVLink within one node of 8, InfiniBand for a
    group that spans more than one node."""
    if group_size <= HARDWARE["gpus_per_node"]:
        return HARDWARE["nvlink_bandwidth"]
    return HARDWARE["internode_bandwidth"]


#: Seconds a collective may wait for a peer before the group raises.
DEFAULT_TIMEOUT_S = 120.0
#: Process-group backends a worker group may run on.
DIST_BACKENDS = ("gloo", "nccl")


def default_dist_backend(device: torch.device | str) -> str:
    """``nccl`` for a card, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _make_backend(kind: str, store, rank: int, size: int, timeout_s: float):
    """A c10d backend object for ``kind`` over ``store`` (no default
    process group is created or used)."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s)
    if kind == "gloo":
        return dist.ProcessGroupGloo(store, rank, size, timeout)
    if kind == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"unknown dist backend {kind!r}; expected one of {DIST_BACKENDS}")


@dataclass
class TransportStats:
    """What a :class:`Transport` carried: logical collectives by kind
    (a gossip hop is one ``collective-permute``, as in the reference's
    lowering), bytes this rank sent by kind, point-to-point messages this
    rank sent, host seconds spent inside the transport, and of those the
    seconds a staged copy waited for the card's stream."""

    counts: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)
    #: Collectives by ``(kind, payload dtype)``, the dtype as torch names
    #: it (``"bfloat16"``): what the wire carried, not what was summed.
    dtypes: dict = field(default_factory=dict)
    messages: int = 0
    host_s: float = 0.0
    sync_s: float = 0.0


#: Collectives by kind over every :class:`Transport` of this process, never
#: reset: a probe that must run none reads it before and after.
PROCESS_TALLY: dict = {}


def moved(now: dict, before: dict) -> dict:
    """The entries of a tally that grew since ``before``, by how much."""
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


class Transport:
    """Collectives and point-to-point exchanges over one process group.

    ``staged`` (gloo with card tensors) copies each outgoing tensor into
    a pinned host buffer, waits for the card's stream once, runs the
    gloo operation on the host, and copies the result back; the buffers
    are kept per (role, peer, shape, dtype) and reused.
    """

    def __init__(self, pg, *, rank: int, size: int, dist_backend: str,
                 device: torch.device):
        self.pg = pg
        self.rank = rank
        self.size = size
        self.dist_backend = dist_backend
        self.device = torch.device(device)
        self.staged = dist_backend == "gloo" and self.device.type == "cuda"
        self.stats = TransportStats()
        self._pinned: dict = {}

    def describe(self) -> str:
        return f"{self.dist_backend} host-staged" if self.staged else self.dist_backend

    def reset(self) -> None:
        self.stats = TransportStats()

    def count(self, kind: str, n: int = 1, nbytes: int = 0, dtype=None) -> None:
        self.stats.counts[kind] = self.stats.counts.get(kind, 0) + n
        self.stats.bytes[kind] = self.stats.bytes.get(kind, 0) + nbytes
        if dtype is not None:
            key = (kind, str(dtype).removeprefix("torch."))
            self.stats.dtypes[key] = self.stats.dtypes.get(key, 0) + n
        PROCESS_TALLY[kind] = PROCESS_TALLY.get(kind, 0) + n

    # -------------------------------------------------------------- staging
    def _host(self, role, peer, like: torch.Tensor) -> torch.Tensor:
        key = (role, peer, tuple(like.shape), like.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _out(self, tensors: dict) -> dict:
        """Card tensors -> their pinned host copies (one wait for the
        stream), or the tensors themselves when nothing is staged."""
        if not self.staged:
            return tensors
        host = {}
        for peer, t in tensors.items():
            host[peer] = self._host("send", peer, t)
            host[peer].copy_(t, non_blocking=True)
        t0 = time.perf_counter()
        torch.cuda.current_stream(self.device).synchronize()
        self.stats.sync_s += time.perf_counter() - t0
        return host

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    # ---------------------------------------------------------- collectives
    def all_reduce(self, x: torch.Tensor, op: str = "sum", *, kind: str = "all-reduce"):
        """The elementwise sum (or max) of ``x`` over the ranks."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        buf = self._out({None: x.contiguous()})[None]
        if not self.staged and buf is x:
            buf = x.clone()
        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        self.pg.allreduce([buf], opts).wait()
        out = self._back(buf)
        self.count(kind, 1, x.numel() * x.element_size(), x.dtype)
        self.stats.host_s += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0, in rank order,
        received into one tensor (staged: one pinned host buffer)."""
        t0 = time.perf_counter()
        x = x.contiguous()
        src = self._out({None: x})[None]
        like = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                           device="meta")
        dst = (self._host("gather", None, like) if self.staged
               else torch.empty(like.shape, dtype=x.dtype, device=x.device))
        self.pg._allgather_base(dst, src).wait()
        out = self._back(dst)
        self.count("all-gather", 1, x.numel() * x.element_size(), x.dtype)
        self.stats.host_s += time.perf_counter() - t0
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``x`` (size * n, ...), this rank's
        n rows of it."""
        import torch.distributed as dist

        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.size} ranks")
        n = x.shape[0] // self.size
        t0 = time.perf_counter()
        x = x.contiguous()
        src = self._out({None: x})[None]
        out = (self._host("recv", None, src[:n]) if self.staged
               else torch.empty_like(x[:n]))
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self.pg.reduce_scatter([out], [list(src.chunk(self.size))], opts).wait()
        res = self._back(out)
        self.count("reduce-scatter", 1, x.numel() * x.element_size(), x.dtype)
        self.stats.host_s += time.perf_counter() - t0
        return res

    def barrier(self) -> None:
        """Return once every rank has reached this call."""
        dev = self.device if self.dist_backend == "nccl" else torch.device("cpu")
        t = torch.zeros(1, device=dev)
        t0 = time.perf_counter()
        self.pg.allreduce([t]).wait()
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        self.count("barrier", 1, t.element_size(), t.dtype)
        self.stats.host_s += time.perf_counter() - t0

    def exchange(self, sends: dict, recv_rows: dict, like: torch.Tensor) -> dict:
        """One round of point-to-point messages: ``sends`` maps a peer
        rank to the rows this rank sends it, ``recv_rows`` a peer rank to
        the number of rows it sends here (each row shaped and typed like
        ``like``'s rows).  Every receive is posted before any send, and
        no rank sends to itself.  Returns the received tensors by peer,
        on ``like``'s device."""
        t0 = time.perf_counter()
        rows = tuple(like.shape[1:])
        recvs = {}
        for peer, n in recv_rows.items():
            shape = (n,) + rows
            recvs[peer] = (
                self._host("recv", peer, torch.empty(shape, dtype=like.dtype, device="meta"))
                if self.staged else torch.empty(shape, dtype=like.dtype, device=like.device)
            )
        out = self._out({p: t.contiguous() for p, t in sends.items()})
        works = [self.pg.recv([buf], peer, 0) for peer, buf in recvs.items()]
        works += [self.pg.send([buf], peer, 0) for peer, buf in out.items()]
        for w in works:
            w.wait()
        got = {peer: self._back(buf) for peer, buf in recvs.items()}
        self.stats.messages += len(out)
        self.stats.host_s += time.perf_counter() - t0
        return got


@dataclass
class WorkerGroup:
    """M workers over the W ranks of one process group; this process is
    rank ``rank`` and holds workers ``rows`` (``M/W`` of them)."""

    num_workers: int
    rank: int
    size: int
    dist_backend: str
    device: torch.device
    transport: Transport
    #: The store the group met through; sub-groups meet under prefixes of it.
    store: object = field(default=None, repr=False)
    timeout_s: float = DEFAULT_TIMEOUT_S
    #: Grids built over this group so far (each meets under its own prefix).
    grids_made: int = 0

    def __post_init__(self):
        if self.num_workers % self.size:
            raise ValueError(
                f"{self.num_workers} workers do not split over {self.size} ranks; "
                "the rank count must divide the worker count"
            )

    @property
    def local_workers(self) -> int:
        return self.num_workers // self.size

    @property
    def rows(self) -> slice:
        lo = self.rank * self.local_workers
        return slice(lo, lo + self.local_workers)

    def describe(self) -> str:
        return (f"{self.size} rank(s) x {self.local_workers} worker(s), "
                f"{self.transport.describe()} on {self.device}")


@dataclass
class ModelGroup:
    """The ranks of one :class:`WorkerGroup` as a grid of data rows by
    model columns, laid out by ``plan`` (``("data", "model")`` or
    ``("pod", "data", "model")``; the last axis is the model axis) in
    ``repro``'s rank order: rank r sits at data index r // model_parallel
    (the data axes flattened, the first slowest) and model index
    r % model_parallel.  ``model`` joins this rank's row (its data index's
    model_parallel ranks), ``data`` its column (the ranks of its model
    index); ``world`` is the worker group's own transport."""

    group: WorkerGroup
    plan: MeshPlan
    model: Transport
    data: Transport
    #: FSDP over the data axes (``AxisRules.fsdp``).
    fsdp: bool = True

    @property
    def world(self) -> Transport:
        return self.group.transport

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def model_parallel(self) -> int:
        return self.plan.shape[-1]

    @property
    def data_parallel(self) -> int:
        return self.plan.size // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    @property
    def coords(self) -> dict:
        """This rank's index along each axis of the plan."""
        return dict(zip(self.plan.axis_names,
                        (int(i) for i in np.unravel_index(self.rank, self.plan.shape))))

    @property
    def rules(self):
        """The ``AxisRules`` the plan's layout follows (``repro``'s
        launchers': batch and FSDP over the data axes, tensor over
        ``model``)."""
        from repro_torch.sharding.rules import AxisRules

        return AxisRules(mesh=self.plan, data_axes=data_axes_for(self.plan),
                         model_axis="model", fsdp=self.fsdp)

    def transports(self) -> dict:
        return {"world": self.world, "model": self.model, "data": self.data}

    def reset_stats(self) -> None:
        for t in self.transports().values():
            t.reset()

    def stats(self) -> dict:
        """What the three transports carried, added up: ``{"counts",
        "bytes", "dtypes", "host_s", "sync_s"}``."""
        out = {"counts": {}, "bytes": {}, "dtypes": {}, "host_s": 0.0, "sync_s": 0.0}
        for t in self.transports().values():
            for key in ("counts", "bytes", "dtypes"):
                for k, v in getattr(t.stats, key).items():
                    out[key][k] = out[key].get(k, 0) + v
            out["host_s"] += t.stats.host_s
            out["sync_s"] += t.stats.sync_s
        return out

    def describe(self) -> str:
        return (f"{self.plan.name} grid ({', '.join(self.plan.axis_names)}), "
                f"{self.world.describe()} on {self.device}")


def make_host_mesh(group: WorkerGroup, model_parallel: int = 1, *,
                   plan: MeshPlan | None = None) -> ModelGroup:
    """The (data, model) grid over ``group``'s ranks: ``repro``'s
    ``make_host_mesh(model_parallel)``, a (W / model_parallel,
    model_parallel) plan, or ``plan`` itself (its size must be the
    group's; its last axis is the model axis).  Every rank of the group
    calls this together: it builds the row's and the column's process
    groups over prefixes of the group's store (each call its own, so the
    ranks must build their grids in one order)."""
    if plan is None:
        if model_parallel < 1 or group.size % model_parallel:
            raise ValueError(f"model_parallel={model_parallel} does not divide the "
                             f"{group.size} ranks")
        plan = MeshPlan(("data", "model"), (group.size // model_parallel, model_parallel))
    if plan.size != group.size:
        raise ValueError(f"the {plan.name} plan needs {plan.size} ranks; the group has "
                         f"{group.size}")
    if plan.axis_names[-1] != "model":
        raise ValueError(f"a grid's last axis is the model axis, got {plan.axis_names}")
    if group.store is None:
        raise ValueError("the worker group carries no store to build sub-groups over")
    import torch.distributed as dist

    mp = plan.shape[-1]
    row, col = group.rank // mp, group.rank % mp
    group.grids_made += 1
    tag = f"grid{group.grids_made}"

    def sub(prefix: str, rank: int, size: int) -> Transport:
        pg = _make_backend(group.dist_backend, dist.PrefixStore(prefix, group.store),
                           rank, size, group.timeout_s)
        return Transport(pg, rank=rank, size=size, dist_backend=group.dist_backend,
                         device=group.device)

    return ModelGroup(group, plan, model=sub(f"{tag}/model-row-{row}", col, mp),
                      data=sub(f"{tag}/data-column-{col}", row, plan.size // mp))


def rank_device(device, local_rank: int) -> torch.device:
    """The device a rank runs on: ``cuda:(local_rank % device_count)`` for
    a card, the CPU as given."""
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _group(num_workers, store, rank, size, dist_backend, device, timeout_s) -> WorkerGroup:
    if dist_backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device; use gloo on the CPU")
    timeout_s = min(timeout_s, DEFAULT_TIMEOUT_S)
    pg = _make_backend(dist_backend, store, rank, size, timeout_s)
    transport = Transport(pg, rank=rank, size=size, dist_backend=dist_backend, device=device)
    return WorkerGroup(num_workers, rank, size, dist_backend, device, transport, store, timeout_s)


def _in_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


@functools.lru_cache(maxsize=8)
def _torchrun_group(num_workers, dist_backend, device, timeout_s) -> WorkerGroup:
    """The group of a ``torchrun`` launch, joined once per process (the
    default process group, initialized from the environment)."""
    import torch.distributed as dist

    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    backend = dist_backend or default_dist_backend(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=min(timeout_s, DEFAULT_TIMEOUT_S)),
        )
    pg = dist.distributed_c10d._get_default_group()
    transport = Transport(pg, rank=rank, size=size, dist_backend=backend, device=dev)
    m = size if num_workers is None else num_workers
    return WorkerGroup(m, rank, size, backend, dev, transport,
                       dist.distributed_c10d._get_default_store(),
                       min(timeout_s, DEFAULT_TIMEOUT_S))


def make_worker_group(
    num_workers: int | None = None,
    ranks: int | None = None,
    backend: str | None = None,
    *,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> WorkerGroup:
    """A :class:`WorkerGroup` of ``num_workers`` workers: the ``torchrun``
    group when this process is one of its ranks, else a one-rank group
    built in this process (``ranks`` must then be None or 1; start W > 1
    ranks with :func:`spawn_workers`).  ``backend`` is the process-group
    backend (default: ``nccl`` for a card, ``gloo`` for the CPU);
    ``device`` the device (default ``cuda``, which must exist).
    ``num_workers`` defaults to one worker per rank."""
    import torch.distributed as dist

    if _in_torchrun():
        group = _torchrun_group(num_workers, backend, device, float(timeout_s))
        if ranks is not None and ranks != group.size:
            raise ValueError(f"ranks={ranks}, but torchrun started {group.size}")
        return group
    if ranks not in (None, 1):
        raise ValueError(
            f"ranks={ranks}: a group of more than one rank is started with "
            "spawn_workers (or torchrun)"
        )
    dev = rank_device(device, 0)
    backend = backend or default_dist_backend(dev)
    m = 1 if num_workers is None else num_workers
    return _group(m, dist.HashStore(), 0, 1, backend, dev, float(timeout_s))


def _rank_entry(fn, args, rank, size, store_path, num_workers, dist_backend, device,
                timeout_s, threads, allow_tf32, results):
    """One spawned rank: build its group, run ``fn(group, *args)``, and
    report ``(rank, "ok", result)`` or ``(rank, "error", traceback)``."""
    try:
        import torch.distributed as dist

        torch.set_num_threads(threads)
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        # Every rank of a spawned group is on this host.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dev = rank_device(device, rank)
        store = dist.FileStore(store_path, size)
        group = _group(num_workers, store, rank, size, dist_backend, dev, timeout_s)
        results.put((rank, "ok", fn(group, *args)))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, "error", traceback.format_exc()))


def spawn_workers(
    fn,
    ranks: int,
    *args,
    num_workers: int | None = None,
    backend: str | None = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    join_timeout_s: float = 600.0,
    threads: int | None = None,
) -> list:
    """Run ``fn(group, *args)`` in ``ranks`` new processes, one rank each,
    over a group of ``num_workers`` workers (default: one a rank), and
    return their results in rank order.

    ``fn`` and ``args`` must pickle (``spawn`` context).  Each rank runs
    ``threads`` intra-op threads (default: the host's CPUs shared out).
    If a rank raises, the others are killed and ``RuntimeError`` carries
    the rank's traceback; ranks still running after ``join_timeout_s``
    are killed and ``TimeoutError`` is raised.  Every process started is
    gone when this returns."""
    from repro_torch._device import resolve_device

    if ranks < 1:
        raise ValueError(f"ranks must be >= 1, got {ranks}")
    dev = resolve_device(device)
    backend = backend or default_dist_backend(dev)
    if backend == "nccl" and ranks > 1 and torch.cuda.device_count() < ranks:
        raise ValueError(
            f"nccl takes one card a rank; {ranks} ranks on {torch.cuda.device_count()} "
            "card(s) need the gloo backend (--dist-backend gloo)"
        )
    m = ranks if num_workers is None else num_workers
    threads = threads or max(1, (os.cpu_count() or 1) // ranks)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    procs = []
    try:
        for rank in range(ranks):
            p = ctx.Process(
                target=_rank_entry,
                args=(fn, args, rank, ranks, os.path.join(tmp, "store"), m, backend,
                      str(dev), float(timeout_s), threads,
                      torch.backends.cuda.matmul.allow_tf32, results),
                daemon=True,
            )
            p.start()
            procs.append(p)
        out: dict = {}
        deadline = time.monotonic() + join_timeout_s
        while len(out) < ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{ranks - len(out)} of {ranks} ranks did not finish within "
                    f"{join_timeout_s:.0f} s"
                )
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.pid for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"rank process(es) {dead} died without a result")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {ranks} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(ranks)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def exchange_plan(perms: tuple, num_workers: int, rank: int, ranks: int):
    """How rank ``rank`` of ``ranks`` receives, for each permutation of
    ``perms`` (``(src, dst)`` pair lists over ``num_workers`` workers),
    the message of every worker it holds.

    Returns ``(index, recv_rows, send_rows)``: ``index`` (steps * m,)
    picks each (step, local worker)'s message from the pool of this
    rank's own rows followed by the rows received from each peer in rank
    order; ``recv_rows[peer]`` counts the rows ``peer`` sends here;
    ``send_rows[peer]`` lists the local rows this rank sends ``peer``, in
    the order ``peer`` expects them (step, then destination)."""
    m = num_workers // ranks
    lo = rank * m
    srcs = []
    for perm in perms:
        src_of = np.empty(num_workers, np.int64)
        for s, d in perm:
            src_of[int(d)] = int(s)
        srcs.append(src_of)
    owner = lambda g: int(g) // m  # noqa: E731
    remote: dict = {}
    slots = []
    for src_of in srcs:
        for d in range(lo, lo + m):
            src = src_of[d]
            if owner(src) == rank:
                slots.append(("local", int(src) - lo))
            else:
                peer = owner(src)
                remote.setdefault(peer, 0)
                slots.append((peer, remote[peer]))
                remote[peer] += 1
    offsets, at = {}, m
    for peer in sorted(remote):
        offsets[peer] = at
        at += remote[peer]
    index = np.array([
        i if where == "local" else offsets[where] + i for where, i in slots
    ], np.int64)
    send_rows: dict = {}
    for peer in range(ranks):
        if peer == rank:
            continue
        plo = peer * m
        rows = [int(src_of[d]) - lo for src_of in srcs for d in range(plo, plo + m)
                if owner(src_of[d]) == rank]
        if rows:
            send_rows[peer] = rows
    return index, dict(sorted(remote.items())), send_rows
