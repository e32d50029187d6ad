"""A (data, model) grid of processes for batched gate evaluation.

Counterpart of zig_tfhe_tpu/parallel/mesh.py on ``torch.distributed``.
The reference's parallel surface is a 16-thread ``parMap`` over
independent blind rotations (parallel/thread_pool.zig:39-128); here every
op is batch-first on one device, and the batch axis is split over
processes (ranks), one device each.

The contract: torch has no global sharded array, so **each rank holds its
own rows of the batch**.  A batch of B lanes over n_data data ranks gives
the rank at data index d the rows [d * B / n_data, (d + 1) * B / n_data)
(``shard_batch``); B must divide by n_data (ValueError otherwise, as the
JAX package's sharding refuses it).  Keys are replicated: every rank holds
the whole cloud key (``replicate`` broadcasts its buffers from rank 0).
Gate evaluation is independent per lane, so a rank evaluates its rows
alone and no collective runs during it.

Rank r sits at (data, model) = (r // n_model, r % n_model), numpy's
row-major reshape of the JAX package's device list.  The model axis exists
for layout parity: ranks that share a data index hold the same rows and
compute the same outputs.  The JAX package splits the key switch's
contraction over that axis only in the multichip dry run of its entry
script (__graft_entry__.py, ``ksk_sh``), which is not a module of the
package and is not ported.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

BATCH_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an [n_data, n_model] grid: ``shape``,
    ``rank`` (0 without a process group), ``device`` (where its rows and
    its key live) and the process groups of its two axes (``groups[axis]``:
    the ranks that differ from it only along that axis; None without a
    process group)."""

    shape: tuple
    rank: int
    device: torch.device
    groups: dict

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_model(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device=None) -> Mesh:
    """The [n_data, n_model] grid of the initialised process group's ranks
    (n_data defaults to world size // n_model; the grid must cover the
    world), with one subgroup per axis.  Without a process group it is the
    1 x 1 mesh of this process.  ``device`` defaults to the card of this
    rank (``torch.cuda.current_device()``)."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if not dist.is_initialized():
        if (n_data or 1) != 1 or n_model != 1:
            raise ValueError(f"a {n_data} x {n_model} mesh needs an "
                             "initialised process group (distributed."
                             "initialize); without one the mesh is 1 x 1")
        return Mesh((1, 1), 0, device, {BATCH_AXIS: None, MODEL_AXIS: None})
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh does not cover the "
                         f"{world} ranks of the process group")
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in the same order (new_group's rule)
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            groups[BATCH_AXIS] = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            groups[MODEL_AXIS] = g
    return Mesh((n_data, n_model), rank, device, groups)


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole [B, ...] batch (the same on every rank),
    on the mesh's device; B must divide by n_data."""
    B = x.shape[0]
    if B % mesh.n_data:
        raise ValueError(f"a batch of {B} lanes does not divide over "
                         f"{mesh.n_data} data ranks")
    rows = B // mesh.n_data
    d = mesh.data_index
    return x[d * rows:(d + 1) * rows].to(mesh.device)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """The module (a CloudKey) on the mesh's device with every buffer
    broadcast from rank 0, so all ranks hold rank 0's key.  The buffers
    travel as their bytes (gloo has no int16 collective)."""
    module = module.to(mesh.device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        for buf in module.buffers():
            dist.broadcast(buf.view(-1).view(torch.uint8), src=0)
    return module


def _gate_runner(ck):
    from zig_tfhe_tpu_torch.models import gates as G

    def run(gate_ids, ct_a, ct_b):
        return G.apply_gates(gate_ids, ct_a, ct_b, ck)

    return run


def shard_map_gates(mesh: Mesh, ck):
    """Batched gate evaluation over the mesh: returns ``run(gate_ids, ct_a,
    ct_b) -> ct_out`` on this rank's rows (``shard_batch``) with the cloud
    key replicated from rank 0; each rank runs the whole blind rotation on
    its own lanes, with no collective."""
    return _gate_runner(replicate(mesh, ck))
