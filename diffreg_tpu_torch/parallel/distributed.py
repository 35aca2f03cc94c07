"""Process groups, per-process data shards and collectives: one process per device.

Counterpart of the JAX package's parallel/distributed.py (the reference's
torchrun wiring, vision3d/utils/distributed.py:11-75, Diff-Reg-3dmatch/
main.py:44-47). ``setup_distributed`` joins the process group that torchrun's
variables (or explicit arguments) describe: NCCL between CUDA devices, gloo on
the CPU, each process on its own card (``LOCAL_RANK``). Without them it is one
process, as in JAX. The collectives here take any tensor: where the backend
cannot reach its device (gloo and a CUDA tensor) they go through host memory.

``run_ranks`` starts a group of processes on this host and gathers their
results: the tests, ``chip_smoke.py`` and ``tools/ddp_check_port.py`` use it.
"""
from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 1800.0      # a collective waits this long for the other processes
_LOOPBACK = ("127.0.0.1", "localhost")


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def setup_distributed(init_method: Optional[str] = None, rank: Optional[int] = None,
                      world_size: Optional[int] = None, local_rank: Optional[int] = None,
                      device_type: str = "cuda", backend: Optional[str] = None,
                      timeout_s: float = TIMEOUT_S) -> dict:
    """Join the process group if the environment or the arguments ask for one.

    Reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK (and MASTER_ADDR /
    MASTER_PORT through ``env://``), or the explicit arguments
    (``init_method="tcp://127.0.0.1:<port>"``, ``rank``, ``world_size``). On
    CUDA the process takes card ``local_rank`` (``torch.cuda.set_device``);
    fewer visible cards than that raise. The backend is NCCL on CUDA and gloo
    on the CPU unless ``backend`` names one. One process when nothing is set,
    and a call in a process already in a group only reports it. Returns the
    JAX function's dict (process_index, process_count, local_devices,
    global_devices: one device a process) with ``local_rank`` and
    ``initialized`` (whether this call joined the group)."""
    env = os.environ
    world = int(world_size if world_size is not None else env.get("WORLD_SIZE", 1))
    local = int(local_rank if local_rank is not None else env.get("LOCAL_RANK", 0))
    joined = False
    if not dist.is_initialized() and (world > 1 or init_method is not None):
        rank = int(rank if rank is not None else env["RANK"])
        if any(host in (init_method or env.get("MASTER_ADDR", "")) for host in _LOOPBACK):
            # one host: both backends bootstrap over the loopback, which a
            # machine without a network has too
            env.setdefault("NCCL_SOCKET_IFNAME", "lo")
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if device_type == "cuda":
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if local >= visible:
                raise RuntimeError(f"local rank {local} of a world of {world} needs card {local}, "
                                   f"but {visible} CUDA device(s) are visible")
            torch.cuda.set_device(local)
        dist.init_process_group(backend or ("nccl" if device_type == "cuda" else "gloo"),
                                init_method=init_method or "env://", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        joined = True
    return {"process_index": process_index(), "process_count": process_count(),
            "local_devices": 1, "global_devices": process_count(), "local_rank": local,
            "initialized": joined}


def cleanup_distributed() -> None:
    """Leave the process group (if this process is in one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_master() -> bool:
    return process_index() == 0


def master_only(fn):
    """Run only on process 0 (reference distributed.py master_only)."""
    def wrapped(*args, **kwargs):
        if is_master():
            return fn(*args, **kwargs)
        return None

    return wrapped


def per_host_slice(global_index: np.ndarray) -> np.ndarray:
    """This process's shard of a global sample index list (the
    DistributedSampler replacement)."""
    return shard_order_for_process(global_index, process_index(), process_count())


def shard_order_for_process(order: np.ndarray, process_index: int,
                            process_count: int) -> np.ndarray:
    """DistributedSampler twin: equal-length, stride-interleaved per-process
    shards of a (pre-shuffled) global index order.

    Exactly torch's ``DistributedSampler`` semantics, which the reference
    installs on every DDP dataloader (vision3d/utils/dataloader.py:80-109;
    Diff-Reg-3dmatch/main.py:127): every process applies the SAME epoch
    shuffle to the global order, the order is padded by wrap-around to a
    multiple of ``process_count`` so all processes step in lockstep
    (collectives deadlock on unequal step counts), then process ``i`` takes
    ``order[i::process_count]``. Shards are disjoint except for the
    <= process_count-1 wrap-padding duplicates.
    """
    order = np.asarray(order)
    if process_count <= 1:
        return order
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} not in [0, {process_count})")
    total = -(-len(order) // process_count) * process_count
    if total > len(order):
        order = np.concatenate([order, order[:total - len(order)]])
    return order[process_index::process_count]


def comm_device() -> torch.device:
    """The device the group's backend moves tensors on."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` in place over the group (through ``comm_device``)."""
    dev = comm_device()
    if t.device == dev:
        dist.all_reduce(t, op)
        return t
    buf = t.to(dev)
    dist.all_reduce(buf, op)
    return t.copy_(buf)


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over the group, in a new tensor."""
    return all_reduce_(t.detach().clone(), op)


def all_gather_rows(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every process's ``t`` (same shape everywhere), concatenated along
    ``axis`` in process order."""
    dev = comm_device()
    src = t.detach().to(dev).contiguous()
    if src.dtype == torch.bool:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=axis).to(t.device).view(t.dtype)


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` in place with process ``src``'s."""
    dev = comm_device()
    if t.device == dev:
        dist.broadcast(t, src)
        return t
    buf = t.to(dev)
    dist.broadcast(buf, src)
    return t.copy_(buf)


def barrier() -> None:
    """Wait for every process of the group (none in one process)."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


_END = object()


def lockstep(iterable):
    """Yield ``iterable``'s items while every process still has one: each
    step all-reduces a have-an-item flag (min), so every process takes the
    same number of steps an epoch, whatever its loader dropped or bucketed.
    The items of the processes that had more are left out. One process:
    ``iterable`` as it is."""
    if process_count() == 1:
        yield from iterable
        return
    it = iter(iterable)
    while True:
        item = next(it, _END)
        flag = torch.tensor([0 if item is _END else 1], dtype=torch.int32)
        if int(all_reduce_(flag, dist.ReduceOp.MIN)) == 0:
            return
        yield item


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, init_method, cards, backend, timeout_s, out_dir, args):
    """A process of ``run_ranks``: join the group, run ``fn``, save its result
    (or the traceback, and exit at once: the others may wait in a collective)
    under ``out_dir``."""
    try:
        setup_distributed(init_method=init_method, rank=rank, world_size=world,
                          local_rank=cards[rank] if cards is not None else 0,
                          device_type="cpu" if cards is None else "cuda", backend=backend,
                          timeout_s=timeout_s)
        result = fn(rank, world, *args)
        path = os.path.join(out_dir, f"{rank}.pt")
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    cleanup_distributed()


def run_ranks(fn: Callable, world_size: int, args: tuple = (), *,
              cards: Optional[Sequence[int]] = None, backend: Optional[str] = None,
              timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (spawned, so ``fn`` and ``args`` must pickle) joined in one group over
    ``tcp://127.0.0.1``, and return their results in rank order. ``cards``:
    the CUDA card of each rank (NCCL unless ``backend`` says otherwise; two
    ranks on one card need gloo), or None for the CPU (gloo). Raises when a
    process fails (the others are killed) or when ``timeout_s`` runs out."""
    import multiprocessing.connection

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="ranks-") as out_dir:
        procs = [ctx.Process(target=_rank_main, args=(fn, rank, world_size, init_method, cards,
                                                      backend, timeout_s, out_dir, args))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: {world_size} processes still running after "
                                       f"{timeout_s:.0f} s")
                multiprocessing.connection.wait([p.sentinel for p in procs if p.is_alive()],
                                                timeout=min(left, 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = []
        for rank, p in enumerate(procs):
            err = os.path.join(out_dir, f"{rank}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {rank}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {rank}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("run_ranks: a process failed\n" + "\n".join(errors))
        return [torch.load(os.path.join(out_dir, f"{rank}.pt"), weights_only=False)
                for rank in range(world_size)]
