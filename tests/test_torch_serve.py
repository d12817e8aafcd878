"""The port's serving layer: the cases of tests/test_serve.py against
``learnedmetricindex_tpu_torch.serve`` over real sockets, on an index the
JAX package built and the port loaded, plus searches racing mutations:
every result is the answer of one state of the store, never a mix."""

import contextlib
import json
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index.serialization import save_index as jax_save_index
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch import serve
from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall
from learnedmetricindex_tpu_torch.serve import SearchServer, make_http_server

torch.set_num_threads(2)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """tests/test_serve.py's index (3000×24, 8 buckets, MLP-2, chunk 256),
    built by the JAX package and loaded into the port."""
    data, queries = synthetic_blobs(3000, 24, 64, n_clusters=16, seed=7)
    cfg = jlmi.BuildConfiguration("kmeans", 30, "MLP-2", 0.01, [8], seed=7, chunk_size=256)
    jidx, pred, *_ = jlmi.LearnedIndexBuilder(data, cfg).build()
    path = str(tmp_path_factory.mktemp("serve") / "index.npz")
    jax_save_index(jidx, path, pred)
    index, pred = lmi.load_index(path, "cpu")
    return index, pred, data, queries, jidx


@pytest.fixture(scope="module")
def served(built):
    index, pred, data, queries, _ = built
    server = SearchServer(index, index.get_bucket_store(data, pred), k=10, n_buckets=8,
                          max_batch=256, max_wait_ms=5.0)
    yield server, data, queries
    server.close()


def _post(url, obj, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _http(server):
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_single_request_matches_direct_search(built, served):
    server, data, queries = served
    index, pred, _, _, jidx = built
    q = queries[:16]
    dists, ids = server.search(q)
    assert dists.shape == (16, 10) and ids.shape == (16, 10) and ids.dtype == np.uint32
    dd, di, _ = index.search(None, q, data, q, pred, n_buckets=8, k=10)
    np.testing.assert_array_equal(ids, di)
    np.testing.assert_array_equal(dists.view(np.uint32), dd.view(np.uint32))
    _, gt = exact_knn(data, q, k=10, device="cpu")
    assert recall(ids, gt, 10) == 1.0  # all 8 buckets visited: exact
    _, ji, _ = jidx.search(None, q, data, q, pred, n_buckets=8, k=10)
    assert recall(ids, np.asarray(ji), 10) == 1.0


def test_per_request_k_is_sliced(served):
    server, _, queries = served
    dists, ids = server.search(queries[:4], k=3)
    assert dists.shape == (4, 3) and ids.shape == (4, 3)
    np.testing.assert_array_equal(ids, server.search(queries[:4])[1][:, :3])
    with pytest.raises(ValueError):
        server.search(queries[:4], k=99)  # above the server's k
    with pytest.raises(ValueError):
        server.search(queries[:1, :5])  # wrong width
    with pytest.raises(ValueError):
        server.search(np.zeros((300, 24), np.float32))  # above max_batch


def test_concurrent_requests_coalesce(served):
    server, data, queries = served
    before = server.stats()["batches"]
    results = {}
    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait()
        results[i] = server.search(queries[i * 8 : (i + 1) * 8])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _, gt = exact_knn(data, queries[:64], k=10, device="cpu")
    assert recall(np.concatenate([results[i][1] for i in range(8)]), gt, 10) == 1.0
    st = server.stats()
    assert st["batches"] - before < 8, "no coalescing"
    assert st["requests"] >= 8 and st["batch_queries"]["max"] >= 16
    # what really ran: the scan's plain version (CPU tensors), no kernel
    assert st["engine"] == "plain" and st["scan_launches"] == 0


def test_http_endpoints(served):
    server, data, queries = served
    httpd, base = _http(server)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        out = _post(f"{base}/search", {"queries": queries[:5].tolist(), "k": 10})
        ids = np.asarray(out["ids"], np.uint32)
        assert ids.shape == (5, 10) and np.asarray(out["dists"]).shape == (5, 10)
        _, gt = exact_knn(data, queries[:5], k=10, device="cpu")
        assert recall(ids, gt, 10) == 1.0
        with urllib.request.urlopen(f"{base}/stats", timeout=10) as r:
            st = json.loads(r.read())
        assert st["requests"] >= 1 and st["config"]["k"] == 10 and st["engine"] == "plain"
        with pytest.raises(urllib.error.HTTPError) as ei:  # malformed → 400
            _post(f"{base}/search", {"queries": "nope"}, timeout=10)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nowhere", timeout=10)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_close_rejects_new_requests(built):
    index, pred, data, _, _ = built
    server = SearchServer(index, index.get_bucket_store(data, pred), k=5, n_buckets=4,
                          max_batch=64, max_wait_ms=0.0, warmup=False)
    assert server.stats()["engine"] is None  # nothing dispatched yet
    d, _ = server.search(data[:3])
    assert d.shape == (3, 5)
    server.close()
    with pytest.raises(RuntimeError):
        server.submit(data[:3])


def test_mutation_is_rejected_on_an_immutable_server(served):
    """In process (ValueError) and over HTTP (400)."""
    server, data, _ = served
    for call in (lambda: server.insert(data[:1]), lambda: server.delete([1]),
                 server.compact):
        with pytest.raises(ValueError, match="immutable"):
            call()
    httpd, base = _http(server)
    try:
        for path, body in (("/insert", {"vectors": [[0.0] * 24]}), ("/delete", {"ids": [1]}),
                           ("/compact", {})):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + path, body, timeout=10)
            assert ei.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
    with pytest.raises(ValueError, match="either"):
        SearchServer(lmi.DynamicIndex(server.index, server.store), server.store)
    with pytest.raises(ValueError, match="required"):
        SearchServer(server.index)


def test_dynamic_server_insert_delete_compact(built):
    """A server over a DynamicIndex serves mutations in process and over
    HTTP; a search after a mutation sees it; an online compaction keeps
    the answers bit-identical."""
    index, pred, data, queries, _ = built
    server = SearchServer(lmi.DynamicIndex.from_built(index, data, pred), k=10, n_buckets=8,
                          max_batch=256, max_wait_ms=0.0, warmup=False)
    try:
        extra, _ = synthetic_blobs(50, 24, 1, n_clusters=16, seed=99)
        ids = server.insert(extra)
        assert len(ids) == 50
        np.testing.assert_array_equal(server.search(extra[:8], k=1)[1][:, 0], ids[:8])
        assert server.delete(ids[:10]) == 10
        assert not np.isin(server.search(queries[:32])[1], ids[:10]).any()
        st = server.stats()
        assert st["mutable"] and st["inserts"] == 50 and st["deletes"] == 10
        assert st["rows"] == len(data) + 40

        httpd, base = _http(server)
        try:
            new_ids = _post(f"{base}/insert", {"vectors": extra[:3].tolist()})["ids"]
            assert len(new_ids) == 3
            assert _post(f"{base}/delete", {"ids": new_ids}) == {"deleted": 3}
            # delete half the corpus so that compaction must free chunks
            victims = list(range(2, len(data) + 1, 2))
            assert _post(f"{base}/delete", {"ids": victims})["deleted"] == len(victims)
            before = server.search(queries[:16])
            rep = _post(f"{base}/compact", {})
            assert rep["chunks_after"] < rep["chunks_before"]
            after = server.search(queries[:16])
            np.testing.assert_array_equal(before[1], after[1])
            np.testing.assert_array_equal(before[0].view(np.uint32), after[0].view(np.uint32))
            assert not np.isin(after[1], victims).any()
        finally:
            httpd.shutdown()
            httpd.server_close()
    finally:
        server.close()


def test_searches_racing_mutations_see_one_state(built):
    """Four client threads search 8 probe queries without pause while a
    mutator inserts exact copies of the probes under fresh ids (with 100
    filler rows, far from every probe, that make the store take pool
    chunks and grow),
    then deletes them.  Every answer equals the answer of one state:
    either no copy (the base answer), or every probe's copy first from
    one insert batch and the base answer after it.  A search submitted
    after a mutation returns sees that mutation."""
    index, pred, data, queries, _ = built
    dyn = lmi.DynamicIndex.from_built(index, data, pred, chunk=64)
    server = SearchServer(dyn, k=10, n_buckets=8, precision="highest", max_batch=256,
                          max_wait_ms=1.0, warmup=False)
    probes = queries[:8]
    rng = np.random.default_rng(5)
    try:
        base_d, base_i = server.search(probes)
        stop = threading.Event()
        seen, errors = [], []

        def client():
            try:
                while not stop.is_set():
                    seen.append(server.search(probes)[1])
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        clients = [threading.Thread(target=client) for _ in range(4)]
        for t in clients:
            t.start()
        batches = []
        n_chunks = [dyn.store.n_chunks]
        # filler rows: random directions farther from every probe than its
        # 10th neighbor, so that they never enter an answer
        cands = rng.normal(size=(40_000, 24)).astype(np.float32)
        cands /= np.linalg.norm(cands, axis=1, keepdims=True)
        fillers = cands[(cands @ probes.T).max(1) < (1.0 - base_d[:, 9]).min() - 0.05]
        assert len(fillers) >= 2000
        for r in range(20):
            filler = fillers[r * 100 : (r + 1) * 100]
            ids = server.insert(np.concatenate([probes, filler]))
            batches.append(ids[:8])
            after = server.search(probes)[1]
            np.testing.assert_array_equal(after[:, 0], ids[:8])
            assert server.delete(ids[:8]) == 8
            np.testing.assert_array_equal(server.search(probes)[1], base_i)
            server.delete(ids[8 : 8 + 50])
            n_chunks.append(dyn.store.n_chunks)
        time.sleep(0.05)
        stop.set()
        for t in clients:
            t.join(30)
        assert not errors, errors
        assert n_chunks[-1] > n_chunks[0]  # the store grew while it served
        assert len(seen) > 20
        for ids in seen:
            if np.array_equal(ids, base_i):
                continue
            batch = [b for b in batches if np.array_equal(ids[:, 0], b)]
            assert batch and np.array_equal(ids[:, 1:], base_i[:, :9]), (
                f"an answer mixing states:\n{ids}")
        assert server.stats()["errors"] == 0
    finally:
        server.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _serve_main(args):
    """``python -m learnedmetricindex_tpu_torch.serve --device cpu <args>`` in
    a subprocess on a free port; yields its base URL once /healthz answers."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "learnedmetricindex_tpu_torch.serve", "--device", "cpu",
         *args, "--port", str(port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=1) as r:
                    assert json.loads(r.read()) == {"status": "ok"}
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.communicate()[1]
                time.sleep(0.1)
        yield base
    finally:
        proc.terminate()
        proc.communicate(timeout=30)


def test_main_serves_a_synthetic_dynamic_index():
    """``python -m learnedmetricindex_tpu_torch.serve --device cpu
    --synthetic N --dynamic`` builds, listens and answers."""
    with _serve_main(["--synthetic", "2000", "--d", "16", "--buckets", "4", "--dynamic",
                      "--max-batch", "64"]) as base:
        v = np.eye(16, dtype=np.float32)[:2]
        ids = _post(f"{base}/insert", {"vectors": v.tolist()})["ids"]
        out = _post(f"{base}/search", {"queries": v.tolist(), "k": 1})
        assert [row[0] for row in out["ids"]] == ids


def test_main_serves_a_saved_index_over_an_h5_corpus(built, tmp_path):
    """``--index index.npz --data corpus.h5`` reads the corpus from the
    file's ``emb`` dataset (the SISAP layout), as the JAX package's
    ``serve.main`` does, and answers as a search over that corpus."""
    import h5py

    index, pred, data, queries, _ = built
    lmi.save_index(index, str(tmp_path / "index.npz"), pred)
    with h5py.File(tmp_path / "corpus.h5", "w") as f:
        f.create_dataset("emb", data=data.astype(np.float64))  # read back as f32
    q = queries[:8]
    with _serve_main(["--index", str(tmp_path / "index.npz"), "--data",
                      str(tmp_path / "corpus.h5"), "--n-buckets", "8"]) as base:
        out = _post(f"{base}/search", {"queries": q.tolist(), "k": 10})
    _, di, _ = index.search(None, q, data, q, pred, n_buckets=8, k=10)
    np.testing.assert_array_equal(np.asarray(out["ids"], np.uint32), di)


@pytest.mark.parametrize("argv,error", [
    (["--data", "corpus.h5", "--device", "cpu"], SystemExit),
    (["--device", "cpu"], SystemExit),
])
def test_main_refuses_what_the_port_does_not_serve(argv, error):
    with pytest.raises(error):
        serve.main(argv)


def test_main_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda would serve")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--synthetic", "100"])
