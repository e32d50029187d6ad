"""Multi-process distributed gate evaluation on ``torch.distributed``.

Counterpart of zig_tfhe_tpu/parallel/distributed.py.  The reference is
single-process (its parallel surface is a thread pool,
parallel/thread_pool.zig:39-128).  The design:

  * ``initialize`` joins the processes into one process group (NCCL for
    the cards; gloo when the caller asks for it, as on the CPU);
  * the cloud key travels out of band: rank 0 saves it
    (utils/serialization.py, the file carries the whole parameter set)
    where every rank can read it, the others load it after a barrier
    (``broadcast_cloud_key``);
  * each rank holds its own rows of the batch (parallel/mesh.py states the
    contract); ``global_batch`` places a rank's rows and checks that every
    data rank holds as many, ``local_shards`` returns them to the host;
  * gate evaluation is independent per lane, so a rank evaluates its rows
    with no collective, and its outputs are bit-equal to the same lanes
    of a single-process ``apply_gates``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from zig_tfhe_tpu_torch.parallel import mesh as _mesh


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: str | None = None) -> None:
    """Join this process to the job as rank ``process_id`` of
    ``num_processes``, rendezvousing at ``coordinator_address``
    ("host:port").  ``backend`` None is NCCL, which binds the rank to card
    ``process_id % device_count``; pass "gloo" for CPU ranks (or several
    ranks on one card, which NCCL refuses)."""
    backend = "nccl" if backend is None else backend
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def barrier() -> None:
    """Block until every rank reaches this point (no-op without a process
    group)."""
    if dist.is_initialized():
        dist.barrier()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def broadcast_cloud_key(path, ck=None, device="cuda"):
    """Key distribution: rank 0 saves ``ck`` at ``path`` (a file every rank
    can read), the others load it onto ``device`` after a barrier.  Rank 0
    passes the key, the others None; returns the CloudKey on every rank."""
    from zig_tfhe_tpu_torch.utils import serialization as ser

    if _rank() == 0:
        if ck is None:
            raise ValueError("rank 0 must provide the cloud key")
        ser.save_cloud_key(path, ck)
    barrier()
    if _rank() != 0:
        ck = ser.load_cloud_key(path, device=device)
    return ck


def replicate_global(mesh: _mesh.Mesh, module: torch.nn.Module):
    """The module (a CloudKey) on the mesh's device.  Needs the same key on
    every rank, which broadcast_cloud_key gives (parallel/mesh.py:
    ``replicate`` broadcasts the buffers from rank 0 instead)."""
    return module.to(mesh.device)


def global_batch(mesh: _mesh.Mesh, local_x) -> torch.Tensor:
    """This rank's rows [B_local, ...] of a batch on the mesh's device.
    Every data rank must hold the same B_local (checked with one
    all-reduce over the data axis), as the JAX package's global array
    needs equal shards."""
    x = torch.as_tensor(local_x).to(mesh.device)
    group = mesh.groups[_mesh.BATCH_AXIS]
    if group is not None:
        n = torch.tensor([x.shape[0], -x.shape[0]], dtype=torch.int64,
                         device=mesh.device)
        dist.all_reduce(n, op=dist.ReduceOp.MAX, group=group)
        if int(n[0]) != x.shape[0] or int(-n[1]) != x.shape[0]:
            raise ValueError(f"data ranks hold {int(-n[1])} to {int(n[0])} "
                             "rows: every rank needs the same count")
    return x


def local_shards(x: torch.Tensor):
    """This rank's rows as a numpy array (the inverse of global_batch)."""
    return x.detach().cpu().numpy()


def distributed_gates(mesh: _mesh.Mesh, ck_global):
    """Batched heterogeneous gates over the mesh: returns ``run(gate_ids,
    ct_a, ct_b) -> out`` on this rank's rows (see global_batch) with a key
    that every rank already holds (replicate_global); no collective."""
    return _mesh._gate_runner(ck_global)
