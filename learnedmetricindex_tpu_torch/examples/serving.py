#!/usr/bin/env python
"""Serving an LMI index on the port: micro-batched search over HTTP.

Builds a small index, starts the HTTP server on an ephemeral port, fires
16 concurrent clients at it and prints the server's own ``/stats``:
``batches`` below ``requests`` is the micro-batching::

    python learnedmetricindex_tpu_torch/examples/serving.py --device cpu

The production entry point runs the same code::

    python -m learnedmetricindex_tpu_torch.serve --index index.npz --data corpus.npy
"""

import argparse
import json
import os
import sys
import threading
import urllib.request

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
    from learnedmetricindex_tpu_torch.serve import SearchServer, make_http_server

    # ---- build (the normal public flow) ----
    data, queries = synthetic_blobs(args.n, 96, 512, n_clusters=24, seed=5)
    cfg = lmi.BuildConfiguration("kmeans", 40, "MLP", 0.01, [12], seed=5, chunk_size=1024)
    index, pred, n_buckets, build_t, _ = lmi.LearnedIndexBuilder(
        data, cfg, device=args.device
    ).build()
    store = index.get_bucket_store(data, pred)
    print(f"built {n_buckets} buckets in {build_t:.1f}s")

    # ---- serve ----
    server = SearchServer(index, store, k=10, n_buckets=4, max_batch=1024, max_wait_ms=3.0)
    httpd = make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"serving on http://127.0.0.1:{port}")

    # ---- 16 concurrent clients, 32 queries each ----
    _, gt = exact_knn(data, queries, k=10, device=args.device)
    results = {}
    barrier = threading.Barrier(16)

    def client(i: int) -> None:
        q = queries[i * 32 : (i + 1) * 32]
        body = json.dumps({"queries": q.tolist(), "k": 10}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/search", data=body,
            headers={"Content-Type": "application/json"},
        )
        barrier.wait()
        with urllib.request.urlopen(req, timeout=120) as r:
            results[i] = np.asarray(json.loads(r.read())["ids"], np.uint32)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    ids = np.concatenate([results[i] for i in range(16)])
    r = recall(ids, gt[: len(ids)], 10)
    print(f"recall@10 over HTTP ({len(ids)} queries, 4/{n_buckets} buckets): {r:.4f}")

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as resp:
        stats = json.loads(resp.read())
    print("server stats:", json.dumps(stats, indent=2))
    print(f"micro-batching: {stats['requests']} requests ran as {stats['batches']} device batches")

    httpd.shutdown()
    httpd.server_close()
    server.close()


if __name__ == "__main__":
    main()
