"""The device mesh on torch.distributed.

Counterpart of `marigold_tpu/parallel/mesh.py`. The JAX package spans its
1-D `data` mesh over the chips of one program and lets XLA insert the
collectives; the port runs one process per GPU (a rank) and names its
collectives. A `Mesh` is the process group seen from one rank: its rank, the
group's size (`shape["data"]`, as the JAX mesh's axis size) and the rank's
device. The models take it as their `spatial` argument and call its three
collectives, all_gather, all_reduce and broadcast, which NCCL and gloo both
take; gloo also takes CUDA tensors (it stages them through host memory
itself), which lets several ranks share one card where NCCL refuses to.
Data-parallel training adds reduce_scatter (ZeRO-1's gradient into each
rank's block), and two host-side calls on a gloo group of their own with a
long explicit timeout: `barrier`, the counterpart of the JAX trainer's
coordination-service barrier, and `broadcast_object` (rank 0's run token and
its `--exit_after` decision).

Launch: `torchrun --nproc_per_node N script.py` (MASTER_ADDR, MASTER_PORT,
RANK, WORLD_SIZE, LOCAL_RANK) or the JAX package's MARIGOLD_TPU_COORDINATOR
(host:port), MARIGOLD_TPU_NUM_PROCESSES and MARIGOLD_TPU_PROCESS_ID, then
`init_distributed()` and `get_mesh()` in every rank. NCCL serves CUDA
ranks and gloo CPU ranks; `run_on_ranks` spawns n ranks, gloo ones on the
CPU for the tests.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

AXIS = "data"
# the host group's deadline: long enough for rank 0's validation pass while
# the other ranks wait (the JAX trainer's _coord_barrier waits 2 h)
HOST_TIMEOUT_S = 7200.0
# torch 2.13 names reduce_scatter_tensor reduce_scatter_single
_reduce_scatter = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a 1-D `data` mesh over the default process group:
    this rank, the number of ranks and this rank's device. A mesh of one
    rank needs no process group (its collectives are the identity)."""

    rank: int
    size: int
    device: torch.device
    axis_names: tuple = (AXIS,)
    # the gloo group of barrier and broadcast_object, made at their first call
    _host: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's x, concatenated along `dim` in rank order into one
        contiguous tensor."""
        x = x.contiguous()
        if self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x (a new tensor)."""
        x = x.clone(memory_format=torch.contiguous_format)
        if self.size > 1:
            dist.all_reduce(x)
        return x

    def broadcast(self, x: torch.Tensor) -> None:
        """Overwrite x in place with rank 0's."""
        if self.size > 1:
            dist.broadcast(x, src=0)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block (`rows`) along `dim` of the sum of every rank's
        x (a new contiguous tensor); x.shape[dim] must divide the mesh."""
        rows = self.rows(x.shape[dim])
        if self.size == 1:
            return x.clone(memory_format=torch.contiguous_format)
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((rows.stop - rows.start,) + x.shape[1:])
        _reduce_scatter(out, x)
        return out.movedim(0, dim).contiguous()

    def _host_group(self):
        if "group" not in self._host:  # every rank makes it at the same call
            self._host["group"] = dist.new_group(
                backend="gloo", timeout=datetime.timedelta(seconds=HOST_TIMEOUT_S))
        return self._host["group"]

    def barrier(self, timeout_s: float = HOST_TIMEOUT_S) -> None:
        """Wait until every rank has reached this call, for up to timeout_s
        (raising past it, naming the ranks that did not arrive). On the host
        group, so that one rank's long pass (rank 0's validation) cannot
        trip the deadline of the next collective on the others."""
        if self.size > 1:
            dist.monitored_barrier(
                group=self._host_group(),
                timeout=datetime.timedelta(seconds=timeout_s))

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's obj (a small picklable host object) on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self._host_group())
        return box[0]

    def halo_rows(self, x: torch.Tensor) -> tuple:
        """For x [B, C, Hl, W] sharded along H in rank order: (the previous
        shard's last row, the next shard's first row), each [B, C, 1, W],
        zeros at the first and the last shard, which are the unsharded
        op's zero padding (`marigold_tpu/models/layers.py:_halo_rows`). One
        all_gather of every shard's two edge rows."""
        edges = self.all_gather(torch.cat([x[:, :, :1], x[:, :, -1:]], 2)[None])
        zero = torch.zeros_like(x[:, :, :1])
        prev = edges[self.rank - 1, :, :, 1:] if self.rank > 0 else zero
        nxt = edges[self.rank + 1, :, :, :1] if self.rank < self.size - 1 else zero
        return prev, nxt

    def rows(self, n: int) -> slice:
        """This rank's block of n items cut evenly over the mesh (raises
        when n does not divide)."""
        if n % self.size:
            raise ValueError(f"{n} items do not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def get_mesh(n_devices: Optional[int] = None, axis_name: str = AXIS,
             device=None) -> Mesh:
    """The mesh over every rank of the initialised default process group.

    Raises when there is no process group, and when it has fewer ranks than
    `n_devices`, as the JAX get_mesh raises with fewer devices; a group of
    more ranks raises too, since each rank belongs to the one mesh.
    device: this rank's device, `cuda:LOCAL_RANK` when None (raising
    without a card; there is no fallback), "cpu" for a CPU rank."""
    if axis_name != AXIS:
        raise ValueError(f"the port's mesh has the one axis {AXIS!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            "get_mesh needs an initialised process group: launch under "
            "torchrun or with MARIGOLD_TPU_COORDINATOR/NUM_PROCESSES/"
            "PROCESS_ID and call init_distributed() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and world < n_devices:
        raise RuntimeError(
            f"get_mesh({n_devices}) but the process group has only {world} "
            "rank(s); start one rank per device (torchrun --nproc_per_node, "
            "or run_on_ranks for CPU tests)")
    if n_devices is not None and world > n_devices:
        raise RuntimeError(
            f"get_mesh({n_devices}) on a process group of {world} ranks: the "
            "mesh spans every rank")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank; pass "
                               "device='cpu' for a CPU rank")
        device = torch.device("cuda", _local_rank(rank))
    device = torch.device(device)
    if device.type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("an NCCL process group cannot serve a CPU rank")
    return Mesh(rank, world, device)


# the variables through which a launcher names the cluster
_LAUNCH_VARIABLES = ("MARIGOLD_TPU_COORDINATOR", "MARIGOLD_TPU_NUM_PROCESSES",
                     "MASTER_ADDR", "WORLD_SIZE")


def cluster_named() -> bool:
    """Whether a launcher's variables name a cluster, from which
    init_distributed() would make the process group."""
    return any(k in os.environ for k in _LAUNCH_VARIABLES)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Optional[str] = None,
                     backend: Optional[str] = None) -> int:
    """Initialise the default process group from the arguments, else from
    MARIGOLD_TPU_COORDINATOR / MARIGOLD_TPU_NUM_PROCESSES /
    MARIGOLD_TPU_PROCESS_ID (as `marigold_tpu/parallel/mesh.py:
    init_distributed`), else from torchrun's MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK. The backend is NCCL for CUDA ranks (device None,
    raising without a card) and gloo for CPU ranks (device="cpu");
    backend="gloo" also serves several ranks on one card. A no-op when the
    group exists or when nothing names a cluster. Returns the number of
    ranks."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("MARIGOLD_TPU_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        n = env.get("MARIGOLD_TPU_NUM_PROCESSES", env.get("WORLD_SIZE"))
        num_processes = int(n) if n is not None else None
    if process_id is None:
        r = env.get("MARIGOLD_TPU_PROCESS_ID", env.get("RANK"))
        process_id = int(r) if r is not None else None
    if coordinator_address is None and num_processes is None:
        return 1  # one process, no cluster named
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a multi-process launch needs the coordinator address, the number "
            f"of processes and this process's id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    if backend is None:
        backend = "gloo" if device is not None and \
            torch.device(device).type == "cpu" else "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("NCCL needs a CUDA device; use backend='gloo' for "
                           "CPU ranks")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return dist.get_world_size()


def data_parallel_sharding(mesh: Mesh, ndim: int, axis_name: str = AXIS) -> tuple:
    """The partition spec that splits the leading (batch/ensemble) dim:
    (axis_name, None, ...), as the JAX NamedSharding's PartitionSpec."""
    return (axis_name,) + (None,) * (ndim - 1)


def _tree_map(fn: Callable, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def shard_batch(mesh: Mesh, x, axis_name: str = AXIS):
    """This rank's block of the leading dim of each tensor (or array) in x,
    moved to the mesh's device; the leading dim must divide the mesh size."""
    def cut(a):
        a = torch.as_tensor(a)
        spec = data_parallel_sharding(mesh, a.ndim, axis_name)
        index = tuple(mesh.rows(a.shape[d]) if s == axis_name else slice(None)
                      for d, s in enumerate(spec))
        return a[index].to(mesh.device)

    return _tree_map(cut, x)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers of `module` to every rank,
    in place; returns the module."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            mesh.broadcast(t.data)
    return module


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def global_batch_from_local(mesh: Mesh, local_batch, axis_name: str = AXIS):
    """The global batch from per-rank local data. On one rank it is
    shard_batch; on several each rank passes its local rows of the global
    batch (the global batch is their concatenation in rank order) and keeps
    them, on its device, as the JAX package's globally sharded array keeps
    each process's shard where it is."""
    if mesh.size == 1:
        return shard_batch(mesh, local_batch, axis_name)
    return _tree_map(lambda a: torch.as_tensor(a).to(mesh.device), local_batch)


# ------------------------------------------------------------------ #
# spawned ranks


def _rank_main(fn, rank: int, n: int, store_path: str, device: str,
               backend: str, timeout_s: Optional[float], args: tuple,
               results) -> None:
    """One spawned rank: a group through the FileStore, fn(mesh, *args) and
    its result (or its traceback) onto the queue."""
    torch.set_num_threads(1)
    if device == "cuda":  # one card per rank
        device = f"cuda:{rank}"
    timeout = ({} if timeout_s is None
               else {"timeout": datetime.timedelta(seconds=timeout_s)})
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, **timeout)
        try:
            out = fn(get_mesh(n, device=device), *args)
        finally:
            dist.destroy_process_group()
        # pickled here, by value: a queue would pass a tensor as a handle to
        # this process's memory, gone once the rank exits
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_on_ranks(fn: Callable, n: int, args: tuple = (), device: str = "cpu",
                 backend: str = "gloo", store_dir: Optional[str] = None,
                 timeout_s: Optional[float] = 600.0) -> list:
    """fn(mesh, *args) on n spawned ranks of one process group; returns the
    ranks' results in rank order. device: "cpu", one card that every rank
    shares ("cuda:0", over gloo: NCCL refuses two ranks on one device) or
    "cuda", rank r on cuda:r (over NCCL). The counterpart of the JAX
    package's force_cpu_devices for tests. fn and args must pickle (fn a
    module-level function) and the module holding fn is imported in each
    rank. The ranks meet through a FileStore in `store_dir` (a new
    temporary directory when None), so no port is taken. Raises with a
    rank's traceback when one fails, and TimeoutError past timeout_s (also
    the group's collective timeout; None: no deadline and the backend's
    default collective timeout, for a training run); no rank outlives the
    call."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        # not daemonic: a rank may start processes of its own (the
        # training loader's workers); the finally below ends every rank
        procs = [ctx.Process(target=_rank_main, daemon=False,
                             args=(fn, r, n, store_path, device, backend,
                                   timeout_s, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        out, errors, failed = {}, [], set()
        deadline = time.monotonic() + (float("inf") if timeout_s is None
                                       else timeout_s)
        grace = None
        try:
            # after a first failure, the other ranks' reports for a few
            # seconds: the rank that failed first is not always the one
            # that reports first
            while len(out) + len(failed) < n and \
                    (grace is None or time.monotonic() < grace):
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue_lib.Empty:
                    # a rank that died before reporting (it failed to start,
                    # or was killed) never will
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and r not in failed
                            and p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"ranks {dead} exited with codes "
                                      f"{[procs[r].exitcode for r in dead]} "
                                      "before giving a result")
                        failed.update(dead)
                        grace = grace or time.monotonic() + 5.0
                    elif grace is None and time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{n - len(out)} of {n} ranks gave no result in "
                            f"{timeout_s} s") from None
                    continue
                if ok:
                    out[rank] = pickle.loads(value)  # a rank of this call wrote it
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    failed.add(rank)
                    grace = grace or time.monotonic() + 5.0
        finally:
            for p in procs:
                p.join(timeout=5.0 if errors or len(out) < n else 60.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10.0)
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [out[r] for r in range(n)]
