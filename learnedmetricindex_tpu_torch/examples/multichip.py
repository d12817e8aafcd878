#!/usr/bin/env python
"""Multi-device LMI on the port: build over a device list, search a
sharded store (the port of ``examples/02_multichip.py``).

1. ``LearnedIndexBuilder(data, cfg, device=devices[0], devices=devices)``
   splits the rows over the devices: the root is clustered as on one
   device, sibling nodes are clustered in blocks over the devices, and
   the node MLPs train expert parallel (data parallel at the root);
2. ``index.get_sharded_store`` balances the leaf buckets over the
   devices, each holding its buckets' slabs;
3. ``index.search(..., store=store)`` scans each shard where it lies
   and merges the shards' top-k on the first device.

On a machine with several GPUs the list is its cards; ``--device cpu``
stands in for the JAX package's 8-device virtual CPU mesh with
``["cpu"] * 8``::

    python learnedmetricindex_tpu_torch/examples/multichip.py --device cpu --n 4000

For one process per host (or per GPU) see ``examples/multihost.py``.
"""

import argparse
import os
import sys

# import the package from a source checkout (sys.path[0] is this directory)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=20_000, help="synthetic corpus rows")
    parser.add_argument("--device", default="cuda", help="cuda (every card, at most 8) or cpu")
    args = parser.parse_args(argv)

    import learnedmetricindex_tpu_torch as lmi
    from learnedmetricindex_tpu_torch.data import synthetic_blobs
    from learnedmetricindex_tpu_torch.ops import exact_knn, recall
    from learnedmetricindex_tpu_torch.parallel import create_mesh

    if args.device == "cpu":
        devices = ["cpu"] * 8
    else:
        devices = create_mesh(device_type="cuda")[:8]
    n_devices = len(devices)
    print(f"devices: {n_devices} ({devices[0]})")

    data, queries = synthetic_blobs(args.n, 96, 500, n_clusters=32, seed=2023)
    cfg = lmi.BuildConfiguration(
        clustering_algorithms="kmeans",
        epochs=30, model_types="MLP", lrs=0.01,
        n_categories=[4, 4],  # 2-level tree, 16 leaf buckets
    )
    index, pred, n_buckets, build_s, cluster_s = lmi.LearnedIndexBuilder(
        data, cfg, device=devices[0], devices=devices).build()
    print(f"built {n_buckets} buckets in {build_s:.1f}s (cluster {cluster_s:.1f}s)")

    store = index.get_sharded_store(data, pred, devices)
    per_device = store.nbytes_device_arrays() // n_devices
    print(f"sharded store: {store.nbytes_device_arrays() / 1e6:.1f} MB, "
          f"~{per_device / 1e6:.2f} MB per device "
          f"({', '.join(f'{s.nbytes() / 1e6:.2f}' for s in store.shards)})")

    dists, nns, times = index.search(
        data, queries, data, queries, pred, cfg.n_categories,
        n_buckets=4, k=10, store=store,
    )
    _, gt = exact_knn(data, queries, k=10, device=devices[0])
    print(f"recall@10 visiting 4/{n_buckets} buckets: {recall(nns, gt, 10):.4f} "
          f"(search {times['search']:.3f}s)")

    # full f32 and no shortlist for an exact full-visit check
    _, nns_all, _ = index.search(
        data, queries, data, queries, pred, cfg.n_categories,
        n_buckets=n_buckets, k=10, store=store, precision="highest", rerank=False,
    )
    r = recall(nns_all, gt, 10)
    print(f"recall@10 visiting ALL buckets: {r:.4f}")
    assert r == 1.0, r
    print("OK")


if __name__ == "__main__":
    main()
