#!/usr/bin/env python
"""Introduction: the Learned Metric Index API tour, on the port.

Build a 2-level learned index ([10, 10] categories), search with an
increasing bucket budget, and watch recall approach exact search.  Runs
offline on seeded synthetic embeddings by default; ``--sisap`` uses the
SISAP'23 LAION-100K data instead (downloads ~300 MB: pca32v2 to navigate,
clip768v2 to scan)::

    python learnedmetricindex_tpu_torch/examples/introduction.py --device cpu --n 20000
"""

import argparse
import os
import sys
import tempfile
import time

# import the package from a source checkout (sys.path[0] is this directory)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--sisap", action="store_true",
                        help="use real SISAP LAION-100K data (downloads)")
    parser.add_argument("--n", type=int, default=100_000, help="synthetic corpus rows")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cpu, ...)")
    args = parser.parse_args(argv)

    import learnedmetricindex_tpu_torch as lmi
    from learnedmetricindex_tpu_torch.data import load_dataset, synthetic_blobs
    from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall

    # 1. Navigation embeddings and (possibly other) search embeddings:
    #    32-d PCA to navigate and 768-d CLIP to scan for SISAP; synthetic
    #    mode uses one space for both.
    if args.sisap:
        data_nav, queries_nav = load_dataset("pca32v2", "100K")
        data_search, queries_search = load_dataset("clip768v2", "100K")
    else:
        data_nav, queries_nav = synthetic_blobs(args.n, 32, 1_000, n_clusters=64, seed=2023)
        data_search, queries_search = data_nav, queries_nav
    print(f"data: {data_nav.shape} navigation, {data_search.shape} search")

    # 2. Ground truth by brute force, for recall.
    _, gt = exact_knn(data_search, queries_search, k=10, device=args.device)

    # 3. A 2-level index: 10 level-1 nodes x 10 leaf buckets each.
    config = lmi.BuildConfiguration(
        clustering_algorithms="kmeans",
        epochs=100,
        model_types="MLP",
        lrs=0.01,
        n_categories=[10, 10],
        seed=2023,
    )
    start = time.perf_counter()
    builder = lmi.LearnedIndexBuilder(data_nav, config, device=args.device)
    index, data_prediction, n_buckets, build_s, cluster_s = builder.build()
    print(f"built {n_buckets} buckets in {time.perf_counter() - start:.1f}s "
          f"(clustering {cluster_s:.1f}s)")

    # 4. An increasing bucket budget: recall climbs toward 1.0 while the
    #    scan touches a fraction of the data.
    for n_visit in (1, 2, 5, 10, 20):
        dists, nns, measured = index.search(
            data_navigation=data_nav,
            queries_navigation=queries_nav,
            data_search=data_search,
            queries_search=queries_search,
            data_prediction=data_prediction,
            n_categories=config.n_categories,
            n_buckets=n_visit,
            k=10,
        )
        frac = n_visit / n_buckets
        print(f"  {n_visit:3d}/{n_buckets} buckets (~{frac:5.1%} of data): "
              f"recall@10 = {recall(nns, gt, 10):.4f}, "
              f"search = {measured['search']:.3f}s "
              f"(navigation {measured['inference']:.3f}s)")

    # 5. Save and reload: the .npz loads in either package.
    path = os.path.join(tempfile.mkdtemp(), "lmi-intro-index.npz")
    index.save(path, data_prediction)
    index2, pred2 = lmi.LearnedIndex.load(path, args.device)
    _, nns2, _ = index2.search(
        data_nav, queries_nav, data_search, queries_search, pred2,
        config.n_categories, n_buckets=10, k=10,
    )
    print(f"reloaded index recall@10: {recall(nns2, gt, 10):.4f}")


if __name__ == "__main__":
    main()
