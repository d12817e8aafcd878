#!/usr/bin/env python
"""A mutable deployment on the port: insert, delete and checkpoint a live
index.

    build → serve → insert/delete (routers fixed, store mutates)
          → checkpoint (the corpus lives in the store: serve-time
            inserts exist nowhere else) → restore → keep mutating

Run it end to end on synthetic data::

    python learnedmetricindex_tpu_torch/examples/dynamic.py --device cpu

The serving equivalents::

    python -m learnedmetricindex_tpu_torch.serve --synthetic 100000 --dynamic
    curl -X POST :8088/insert -d '{"vectors": [[...]]}'
    curl -X POST :8088/delete -d '{"ids": [100001]}'
    # later, after dyn.save("deploy.npz"):
    python -m learnedmetricindex_tpu_torch.serve --index deploy.npz
"""

import argparse
import os
import sys
import tempfile

import numpy as np

# import the package from a source checkout (sys.path[0] is this directory)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=20_000, help="synthetic corpus rows")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cpu, ...)")
    args = parser.parse_args(argv)

    import learnedmetricindex_tpu_torch as lmi
    from learnedmetricindex_tpu_torch.data import synthetic_blobs
    from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall

    # ---- build once ----
    data, queries = synthetic_blobs(args.n, 96, 256, n_clusters=24, seed=5)
    cfg = lmi.BuildConfiguration("kmeans", 30, "MLP-2", 0.01, [10], seed=5)
    index, data_prediction, n_buckets, build_t, _ = lmi.LearnedIndexBuilder(
        data, cfg, device=args.device
    ).build()
    print(f"built {n_buckets} buckets in {build_t:.1f}s")

    dyn = lmi.DynamicIndex.from_built(index, data, data_prediction)

    # ---- the corpus moves; the index stays online ----
    arrivals, _ = synthetic_blobs(2_000, 96, 1, n_clusters=24, seed=9)
    ids = dyn.insert(arrivals)  # routed by the trained MLPs
    print(f"inserted {len(ids)} rows -> {dyn.n_rows} live")

    removed = dyn.delete(ids[:500])
    print(f"deleted {removed} rows -> {dyn.n_rows} live")

    # exactness over the mutated corpus: a full visit equals brute force
    live = np.concatenate([data, arrivals[500:]])
    live_ids = np.concatenate([np.arange(1, len(data) + 1), ids[500:]])
    _, gt_rows = exact_knn(live, queries, k=10, device=args.device)
    gt = live_ids[gt_rows.astype(np.int64) - 1]
    _, nns, _ = dyn.search(queries, n_buckets=n_buckets, k=10)
    print(f"full-visit recall over the mutated corpus: {recall(nns, gt, 10):.4f}")

    # ---- checkpoint the deployment, restore, keep mutating ----
    path = os.path.join(tempfile.mkdtemp(), "deploy.npz")
    dyn.save(path)
    restored = lmi.DynamicIndex.load(path, args.device)
    _, nns2, _ = restored.search(queries, n_buckets=n_buckets, k=10)
    if not (nns == nns2).all():
        raise RuntimeError("the restored index must reproduce the searches")
    more = restored.insert(arrivals[:3])
    print(f"restored from {path}; resumed ids at {more.min()} (no collisions)")


if __name__ == "__main__":
    main()
