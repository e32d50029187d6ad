"""The port's parallel/ package: meshes of torch.distributed ranks and
distributed gate evaluation.

In process: without a process group the mesh is 1 x 1 and its gate runners
equal ``apply_gates``; a batch that does not divide over the data ranks
raises.  Two processes on gloo (CPU): rank 0 broadcasts a port-made
TEST_TINY cloud key through ``broadcast_cloud_key``; each rank evaluates
its half of an 8-lane heterogeneous batch with ``distributed_gates`` and
``shard_map_gates``; the halves put together are bit-equal to the
single-process ``apply_gates``.  The workers import only the port.
"""

import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from zig_tfhe_tpu_torch import key as TK
from zig_tfhe_tpu_torch import params as TP
from zig_tfhe_tpu_torch import tlwe as TT
from zig_tfhe_tpu_torch.models import gates as TG
from zig_tfhe_tpu_torch.parallel import distributed as D
from zig_tfhe_tpu_torch.parallel import mesh as M
from zig_tfhe_tpu_torch.utils import serialization as tser

_REPO = pathlib.Path(__file__).resolve().parent.parent
P = TP.TEST_TINY
B = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs its test processes side by side (pytest-xdist); with
    one intra-op thread the port's small CPU ops do not wait on pool
    threads that another process holds the cores from."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    """A port TEST_TINY key and an 8-lane batch of gates 0..7."""
    g = torch.Generator().manual_seed(90)
    sk = TK.SecretKey.generate(g, P)
    ck = TK.CloudKey.generate(g, sk, P)
    rng = np.random.default_rng(91)
    x, y = rng.integers(0, 2, (2, B)).astype(bool)
    ids = torch.arange(B)
    a = TT.encrypt_bool(g, torch.from_numpy(x), 0.0, sk.key_lv0)
    b = TT.encrypt_bool(g, torch.from_numpy(y), 0.0, sk.key_lv0)
    return ck, ids, a, b, TG.apply_gates(ids, a, b, ck)


def test_mesh_without_process_group(batch):
    ck, ids, a, b, want = batch
    mesh = M.make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.data_index, mesh.model_index) == (
        (1, 1), 0, 0, 0)
    assert mesh.groups == {M.BATCH_AXIS: None, M.MODEL_AXIS: None}
    assert torch.equal(M.shard_batch(mesh, a), a)
    assert torch.equal(M.shard_map_gates(mesh, ck)(ids, a, b), want)
    run = D.distributed_gates(mesh, D.replicate_global(mesh, ck))
    out = run(D.global_batch(mesh, ids), D.global_batch(mesh, a),
              D.global_batch(mesh, b))
    assert np.array_equal(D.local_shards(out), want.numpy())
    with pytest.raises(ValueError, match="process group"):
        M.make_mesh(n_data=2, device="cpu")


def test_shard_batch_must_divide(batch):
    a = batch[2]
    mesh = M.Mesh((3, 1), 1, torch.device("cpu"),
                  {M.BATCH_AXIS: None, M.MODEL_AXIS: None})
    with pytest.raises(ValueError, match="does not divide"):
        M.shard_batch(mesh, a)
    two = M.Mesh((2, 2), 3, torch.device("cpu"),
                 {M.BATCH_AXIS: None, M.MODEL_AXIS: None})
    assert (two.data_index, two.model_index) == (1, 1)
    assert torch.equal(M.shard_batch(two, a), a[B // 2:])


_WORKER = textwrap.dedent("""
    import copy, os, sys
    sys.path.insert(0, sys.argv[5])
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from zig_tfhe_tpu_torch.parallel import distributed as D
    from zig_tfhe_tpu_torch.parallel import mesh as M
    from zig_tfhe_tpu_torch.utils import serialization as ser

    rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    D.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = M.make_mesh(device="cpu")
    assert mesh.shape == (world, 1) and mesh.data_index == rank, mesh
    ck = (ser.load_cloud_key(os.path.join(tmp, "parent_ck"), device="cpu")
          if rank == 0 else None)
    ck = D.broadcast_cloud_key(os.path.join(tmp, "broadcast_ck"), ck,
                               device="cpu")
    z = np.load(os.path.join(tmp, "batch.npz"))
    ids, a, b = (M.shard_batch(mesh, torch.from_numpy(z[k]))
                 for k in ("ids", "a", "b"))
    run = D.distributed_gates(mesh, D.replicate_global(mesh, ck))
    out = run(D.global_batch(mesh, ids), D.global_batch(mesh, a),
              D.global_batch(mesh, b))
    # shard_map_gates replicates rank 0's key over the process group: the
    # other ranks pass a zeroed copy, which the broadcast overwrites
    mine = ck if rank == 0 else copy.deepcopy(ck)
    if rank:
        for buf in mine.buffers():
            buf.zero_()
    again = M.shard_map_gates(mesh, mine)(ids, a, b)
    assert torch.equal(again, out)
    np.save(os.path.join(tmp, f"out{rank}.npy"), D.local_shards(out))
    D.barrier()
    dist.destroy_process_group()
    print(f"PARALLEL_OK rank={rank}", flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_gates_bit_equal(batch, tmp_path):
    ck, ids, a, b, want = batch
    tser.save_cloud_key(tmp_path / "parent_ck", ck)
    np.savez(tmp_path / "batch.npz", ids=ids.numpy(), a=a.numpy(),
             b=b.numpy())
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), "2", str(port), str(tmp_path),
         str(_REPO)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"gloo workers timed out; output so far: {outs}")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"PARALLEL_OK rank={r}" in out, out
    got = np.concatenate([np.load(tmp_path / f"out{r}.npy") for r in range(2)])
    assert np.array_equal(got, want.numpy())
