#!/usr/bin/env python
"""Multi-process LMI on the port: one process (a *rank*) per device, the
same public API (the port of ``examples/03_multihost.py``).

Every rank runs :func:`main`: it joins the process group
(``multiprocess.initialize``: NCCL on a GPU, gloo on the CPU), feeds
only its own block of rows (``from_process_local``), and then calls the
same build → sharded store → search as a single process, with
``devices=`` the world (``global_mesh()``).  Each rank holds its own
shard of the store; every rank gets the same neighbours.

Run without ``--worker``, it launches ``--ranks`` local ranks (two by
default, a card each) through a file rendezvous; ``--device cpu`` runs
them over gloo on the CPU::

    python learnedmetricindex_tpu_torch/examples/multihost.py --device cpu

On a cluster run the worker on every host instead, with its rank and a
coordinator address from your launcher (or torchrun's variables)::

    python .../multihost.py --worker <rank> <world size> <host0>:<port>
"""

import argparse
import os
import subprocess
import sys
import tempfile

# import the package from a source checkout (sys.path[0] is this directory)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(process_id: int, num_processes: int, coordinator: str, device: str, n: int) -> None:
    """The per-rank body: only the three setup calls (initialize,
    global_mesh, from_process_local) differ from a single process."""
    import torch

    from learnedmetricindex_tpu_torch.parallel import multiprocess as mp

    if device == "cuda":  # one card a rank
        device = f"cuda:{process_id % torch.cuda.device_count()}"
    mp.initialize(coordinator_address=coordinator, num_processes=num_processes,
                  process_id=process_id, device=device)
    world = mp.global_mesh()  # this rank's view of the world

    import learnedmetricindex_tpu_torch as lmi
    from learnedmetricindex_tpu_torch.data import synthetic_blobs
    from learnedmetricindex_tpu_torch.ops import exact_knn, recall

    # every rank draws the same dataset but feeds only its own rows
    # (a stand-in for per-host loaders)
    data, queries = synthetic_blobs(n, 32, 64, n_clusters=12, seed=13)
    share = len(data) // num_processes
    gdata = mp.from_process_local(data[process_id * share:(process_id + 1) * share], world)

    cfg = lmi.BuildConfiguration("kmeans", 30, "MLP", 0.02, [8], seed=3)
    index, pred, nb, build_s, _ = lmi.LearnedIndexBuilder(
        gdata, cfg, device=world.device, devices=world).build()
    store = index.get_sharded_store(gdata, pred, world)
    total = int(mp.to_host_replicated(
        torch.tensor([store.nbytes_device_arrays()], device=world.device), world).sum())

    dd, ii, _ = index.search(gdata, queries, gdata, queries, pred, None,
                             n_buckets=nb, k=10, store=store)
    _, gt = exact_knn(data[: share * num_processes], queries, k=10, device=world.device)
    r = recall(ii, gt, 10)
    print(f"[rank {world.rank}] {world.size} ranks on {torch.distributed.get_backend()} | "
          f"store {store.nbytes_device_arrays() / 2**20:.2f} MiB local of {total / 2**20:.2f} "
          f"MiB | build {build_s:.1f}s | full-visit recall@10 {r:.4f}", flush=True)
    assert r == 1.0, r
    torch.distributed.destroy_process_group()
    print(f"[rank {world.rank}] OK", flush=True)


def _demo(ranks: int, device: str, n: int) -> None:
    """Launch ``ranks`` local ranks through a file rendezvous."""
    with tempfile.TemporaryDirectory() as where:
        procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(rank),
                              str(ranks), f"file://{where}/rdv", "--device", device,
                              "--n", str(n)])
            for rank in range(ranks)
        ]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            # a rank that died before the rendezvous leaves the others waiting
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(rcs):
        raise SystemExit(f"rank exit codes: {rcs}")
    print("multi-host demo OK")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=3, metavar=("RANK", "WORLD", "COORDINATOR"),
                        help="run one rank (COORDINATOR: host:port or file://path)")
    parser.add_argument("--ranks", type=int, default=2, help="local ranks the demo launches")
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, a card a rank; raises without a GPU) or cpu (gloo)")
    parser.add_argument("--n", type=int, default=2048, help="synthetic corpus rows")
    args = parser.parse_args()
    if args.worker:
        main(int(args.worker[0]), int(args.worker[1]), args.worker[2], args.device, args.n)
    else:
        _demo(args.ranks, args.device, args.n)
