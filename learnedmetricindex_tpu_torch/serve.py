"""Serving: a micro-batching search server over a built index, with a
JSON-over-HTTP front end (counterpart of ``learnedmetricindex_tpu/serve.py``).

A search's fixed costs (navigation, planning, the kernel launches, the
copy back) hardly grow with the number of queries in it, so the server
coalesces concurrent requests into one ``LearnedIndex.search`` call.

* :class:`SearchServer` — client threads ``submit()`` query arrays; one
  dispatcher thread drains the queue into one search a tick, at most
  ``max_batch`` queries, after waiting up to ``max_wait_ms`` for more
  requests to join.  Over a
  :class:`~learnedmetricindex_tpu_torch.index.mutation.DynamicIndex`, or
  a ``ShardedDynamicIndex`` over a store sharded by bucket over devices,
  it also inserts, deletes and compacts.  The port's mutations write the
  store's tensors in place, so one lock is held around every dispatch
  and every mutation: a search never sees half of a mutation, and a
  request submitted after a mutation returns sees all of it.  A plain
  index serves any store: packed, virtual or sharded over devices.
  ``stats()["busy_s"]`` holds cumulative seconds: ``queue_wait`` (summed
  over requests, submit to the start of their dispatch), ``lock_wait``
  (the dispatcher waiting for the lock), ``dispatch`` and ``mutation``
  (the lock held by each).  The dispatcher names its steps on the
  profiler's clock: ``lmi.serve.batch_window``, ``lmi.serve.lock_wait``,
  ``lmi.serve.dispatch``.
* :func:`make_http_server` / :func:`main` — ``POST /search``, ``GET
  /healthz``, ``GET /stats``, and ``POST /insert``, ``/delete`` and
  ``/compact`` over a ``DynamicIndex``, on the standard library's
  ``ThreadingHTTPServer``: each connection waits on its request while
  the dispatcher batches across connections.

    python -m learnedmetricindex_tpu_torch.serve --device cpu --synthetic 20000 --dynamic
    python -m learnedmetricindex_tpu_torch.serve --device cpu --synthetic 20000 \
        --shard-devices 4 --dynamic
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from learnedmetricindex_tpu_torch.index.mutation import DynamicIndex
from learnedmetricindex_tpu_torch.ops import scan_kernel
from learnedmetricindex_tpu_torch.parallel.sharded_mutation import ShardedDynamicIndex
from learnedmetricindex_tpu_torch.utils.profiling import span

__all__ = ["SearchServer", "make_http_server", "main"]

_log = logging.getLogger(__name__)


class _Request:
    """One submitted query batch, filled in by the dispatcher thread."""

    __slots__ = ("queries", "k", "event", "dists", "ids", "error", "t_submit")

    def __init__(self, queries: np.ndarray, k: int):
        self.queries = queries
        self.k = k
        self.event = threading.Event()
        self.dists: Optional[np.ndarray] = None
        self.ids: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()

    def wait(self, timeout: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        if not self.event.wait(timeout):
            raise TimeoutError("search request timed out")
        if self.error is not None:
            raise self.error
        return self.dists, self.ids


class SearchServer:
    """Micro-batching executor: concurrent search requests coalesce into
    one search on the index's device.

    ``index``: a :class:`DynamicIndex` or a :class:`ShardedDynamicIndex`
    (the server then takes mutations too), or a ``LearnedIndex`` with its
    ``store`` (packed, virtual or sharded).  The search
    knobs are fixed per server; a request may ask for any ``k`` up to the
    server's, which computes at its own ``k`` and slices.  ``max_batch``
    bounds a dispatch (requests beyond it wait for the next tick);
    ``max_wait_ms`` is how long the dispatcher waits after a tick's first
    request for more to join.  ``warmup`` runs one ``max_batch`` search
    at construction: on a GPU it loads the scan kernel's library (and
    builds it at first use), so the first client does not pay that."""

    def __init__(
        self,
        index,
        store=None,
        *,
        k: int = 10,
        n_buckets: int = 4,
        policy: str = "best_first",
        nav_temp=None,
        precision: str = "default",
        rerank: bool = True,
        rerank_margin: int = 6,
        max_batch: int = 4096,
        max_wait_ms: float = 2.0,
        warmup: bool = True,
    ):
        if isinstance(index, (DynamicIndex, ShardedDynamicIndex)):
            if store is not None:
                raise ValueError("pass either a DynamicIndex or (index, store)")
            self.dynamic = index
            index, store = index.index, index.store
        else:
            self.dynamic = None
            if store is None:
                raise ValueError("store is required for a plain index")
        # held around every dispatch and every mutation (module docstring)
        self._device_lock = threading.Lock()
        self._n_inserts = 0
        self._n_deletes = 0
        self.index = index
        self.store = store
        self.k = int(k)
        self.n_buckets = int(n_buckets)
        self.policy = policy
        self.nav_temp = nav_temp
        self.precision = precision
        self.rerank = rerank
        self.rerank_margin = int(rerank_margin)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        # every store layout: packed, virtual (the corpus's width) and sharded
        self.d = store.dim

        self._lock = threading.Condition()
        self._pending: deque = deque()
        self._closed = False
        self._t_start = time.perf_counter()
        # stats, under self._lock: totals and bounded latency/batch logs
        self._n_requests = 0
        self._n_queries = 0
        self._n_batches = 0
        self._n_errors = 0
        self._latencies: deque = deque(maxlen=4096)  # seconds, per request
        self._batch_sizes: deque = deque(maxlen=4096)
        self._engine: Optional[str] = None  # what the last dispatch ran
        self._scan_launches = 0  # scan kernel launches of this server's dispatches
        # cumulative seconds (stats()["busy_s"]): requests from submit to the
        # start of their dispatch, the dispatcher waiting for the device lock,
        # and the lock held by dispatches and by mutations
        self._busy = {"queue_wait": 0.0, "lock_wait": 0.0, "dispatch": 0.0, "mutation": 0.0}

        if warmup:
            q = np.zeros((self.max_batch, self.d), np.float32)
            q[:, 0] = 1.0
            self._dispatch(q)

        self._thread = threading.Thread(target=self._loop, name="lmi-serve-dispatch", daemon=True)
        self._thread.start()

    # ---- client API ----

    def submit(self, queries: np.ndarray, k: Optional[int] = None) -> _Request:
        """Enqueue a (Q, d) float32 query batch; the request's ``wait()``
        yields ``(dists (Q, k), ids (Q, k) uint32 1-based)``."""
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.d:
            raise ValueError(f"queries must be (Q, {self.d}) float32, got {queries.shape}")
        if len(queries) > self.max_batch:
            raise ValueError(
                f"batch of {len(queries)} exceeds max_batch={self.max_batch} — split the request"
            )
        k = self.k if k is None else int(k)
        if not 1 <= k <= self.k:
            raise ValueError(f"k must be in [1, {self.k}], got {k}")
        req = _Request(queries, k)
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._pending.append(req)
            self._lock.notify_all()
        return req

    def search(
        self, queries: np.ndarray, k: Optional[int] = None, timeout: Optional[float] = 60.0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking :meth:`submit`."""
        return self.submit(queries, k).wait(timeout)

    # ---- mutation API (servers over a DynamicIndex) ----

    def _require_dynamic(self):
        if self.dynamic is None:
            # a ValueError: the client's misuse (HTTP 400), not a device failure (500)
            raise ValueError(
                "this server wraps an immutable (index, store) pair — "
                "construct SearchServer(DynamicIndex(...)) to serve "
                "inserts and deletes"
            )

    @contextmanager
    def _mutating(self):
        """The device lock around a mutation, its hold added to ``busy_s``."""
        with self._device_lock:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                with self._lock:
                    self._busy["mutation"] += time.perf_counter() - t0

    def insert(self, vectors: np.ndarray, object_ids=None) -> np.ndarray:
        """Insert rows into the live corpus; returns their 1-based ids.
        Searches submitted after this returns see the new rows."""
        self._require_dynamic()
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.d:
            raise ValueError(f"vectors must be (N, {self.d}) float32, got {vectors.shape}")
        with self._mutating():
            ids = self.dynamic.insert(vectors, object_ids)
            self.store = self.dynamic.store
        with self._lock:
            self._n_inserts += len(ids)
        return ids

    def delete(self, object_ids) -> int:
        """Delete rows by 1-based id; returns how many were live."""
        self._require_dynamic()
        with self._mutating():
            n = self.dynamic.delete(np.asarray(object_ids, np.int64))
            self.store = self.dynamic.store
        with self._lock:
            self._n_deletes += n
        return n

    def compact(self) -> Dict:
        """Repack the live store (drop delete holes and pool chunks); search
        results are bit-identical before and after.  Returns
        ``{"chunks_before": ..., "chunks_after": ...}``."""
        self._require_dynamic()
        with self._mutating():
            before = self.dynamic.store.n_chunks
            self.dynamic.compact()
            self.store = self.dynamic.store
        return {"chunks_before": before, "chunks_after": self.store.n_chunks}

    def stats(self) -> Dict:
        with self._lock:
            lat = sorted(self._latencies)
            sizes = sorted(self._batch_sizes)

            def pct(xs, p):
                return float(xs[min(len(xs) - 1, int(p * len(xs)))]) if xs else 0.0

            return {
                "uptime_s": round(time.perf_counter() - self._t_start, 3),
                "requests": self._n_requests,
                "queries": self._n_queries,
                "batches": self._n_batches,
                "errors": self._n_errors,
                "pending": len(self._pending),
                "latency_ms": {
                    "p50": round(pct(lat, 0.50) * 1e3, 3),
                    "p95": round(pct(lat, 0.95) * 1e3, 3),
                    "max": round(lat[-1] * 1e3, 3) if lat else 0.0,
                },
                "batch_queries": {
                    "p50": pct(sizes, 0.50),
                    "max": float(sizes[-1]) if sizes else 0.0,
                },
                # "cuda": the scan kernel ran (scan_launches counts its
                # launches); "plain": its PyTorch version on the CPU
                "engine": self._engine,
                "scan_launches": self._scan_launches,
                "busy_s": {kind: round(t, 6) for kind, t in self._busy.items()},
                "mutable": self.dynamic is not None,
                "inserts": self._n_inserts,
                "deletes": self._n_deletes,
                "rows": self.dynamic.n_rows if self.dynamic is not None else None,
                "config": {
                    "k": self.k,
                    "n_buckets": self.n_buckets,
                    "policy": self.policy,
                    "nav_temp": self.nav_temp,
                    "precision": self.precision,
                    "rerank": self.rerank,
                    "max_batch": self.max_batch,
                    "max_wait_ms": self.max_wait_ms,
                    "d": self.d,
                },
            }

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._thread.join(timeout)
        # fail the requests that never made it into a batch
        with self._lock:
            while self._pending:
                req = self._pending.popleft()
                req.error = RuntimeError("server closed")
                req.event.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- dispatcher ----

    def _dispatch(self, queries: np.ndarray):
        t0 = time.perf_counter()
        with span("lmi.serve.lock_wait"):
            self._device_lock.acquire()
        t1 = time.perf_counter()
        try:
            with span("lmi.serve.dispatch"):
                before = scan_kernel.LAUNCHES
                out = self.index.search(
                    None, queries, None, queries, None,
                    n_buckets=self.n_buckets, k=self.k, policy=self.policy,
                    nav_temp=self.nav_temp, precision=self.precision, rerank=self.rerank,
                    rerank_margin=self.rerank_margin, store=self.store,
                )
                launched = scan_kernel.LAUNCHES - before
                engine = "plain" if self.store.device.type == "cpu" else "cuda"
        finally:
            t2 = time.perf_counter()
            self._device_lock.release()
            with self._lock:
                self._busy["lock_wait"] += t1 - t0
                self._busy["dispatch"] += t2 - t1
        with self._lock:
            self._engine = engine
            self._scan_launches += launched
        return out

    def _take_batch(self) -> List[_Request]:
        """Wait for work, apply the batching window, drain at most
        ``max_batch`` queries' worth of requests."""
        with self._lock:
            while not self._pending and not self._closed:
                self._lock.wait(0.1)
            if self._closed:
                return []
            if self.max_wait_ms > 0:
                with span("lmi.serve.batch_window"):
                    deadline = time.perf_counter() + self.max_wait_ms / 1e3
                    while time.perf_counter() < deadline:
                        if sum(len(r.queries) for r in self._pending) >= self.max_batch:
                            break
                        self._lock.wait(max(deadline - time.perf_counter(), 0))
            batch: List[_Request] = []
            n_q = 0
            while self._pending and n_q + len(self._pending[0].queries) <= self.max_batch:
                req = self._pending.popleft()
                batch.append(req)
                n_q += len(req.queries)
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                with self._lock:
                    if self._closed:
                        return
                continue
            t_start = time.perf_counter()
            queries = (batch[0].queries if len(batch) == 1
                       else np.concatenate([r.queries for r in batch]))
            try:
                dists, ids, _ = self._dispatch(queries)
                err = None
            except Exception as e:  # noqa: BLE001 — handed to the callers
                _log.exception("serving dispatch failed")
                dists = ids = None
                err = e
            t_done = time.perf_counter()
            with self._lock:
                self._n_batches += 1
                self._batch_sizes.append(len(queries))
                self._n_requests += len(batch)
                self._n_queries += len(queries)
                self._busy["queue_wait"] += sum(t_start - req.t_submit for req in batch)
                if err is not None:
                    self._n_errors += len(batch)
                for req in batch:
                    self._latencies.append(t_done - req.t_submit)
            row = 0
            for req in batch:
                n = len(req.queries)
                if err is not None:
                    req.error = err
                else:
                    req.dists = dists[row : row + n, : req.k]
                    req.ids = ids[row : row + n, : req.k]
                row += n
                req.event.set()


# ---- HTTP front end (standard library only) ----


def make_http_server(server: SearchServer, host: str = "127.0.0.1", port: int = 0):
    """A ``ThreadingHTTPServer`` speaking JSON:

    * ``POST /search`` — ``{"queries": [[...], ...], "k": 10?}`` →
      ``{"ids": [[...]], "dists": [[...]]}`` (ids 1-based);
    * ``POST /insert`` — ``{"vectors": [[...]], "ids": [...]?}`` →
      ``{"ids": [...]}``; ``POST /delete`` — ``{"ids": [...]}`` →
      ``{"deleted": n}``; ``POST /compact`` → the chunk counts (over a
      ``DynamicIndex``; 400 otherwise);
    * ``GET /healthz`` → ``{"status": "ok"}``; ``GET /stats`` →
      :meth:`SearchServer.stats`.

    Not yet serving: call ``serve_forever()`` (on a thread, say).  Port 0
    binds an ephemeral port (``server_address[1]``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/search":
                    queries = np.asarray(payload["queries"], dtype=np.float32)
                    if queries.ndim == 1:
                        queries = queries[None, :]
                    dists, ids = server.search(queries, k=payload.get("k"),
                                               timeout=float(payload.get("timeout_s", 60.0)))
                    self._reply(200, {"ids": ids.tolist(),
                                      "dists": [[float(x) for x in row] for row in dists]})
                elif self.path == "/insert":
                    vectors = np.asarray(payload["vectors"], dtype=np.float32)
                    if vectors.ndim == 1:
                        vectors = vectors[None, :]
                    ids = server.insert(vectors, payload.get("ids"))
                    self._reply(200, {"ids": [int(i) for i in ids]})
                elif self.path == "/delete":
                    n = server.delete(np.asarray(payload["ids"], dtype=np.int64))
                    self._reply(200, {"deleted": n})
                elif self.path == "/compact":
                    self._reply(200, server.compact())
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the serving boundary
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            _log.debug("%s " + fmt, self.client_address[0], *args)

    return ThreadingHTTPServer((host, port), Handler)


def _build_demo_index(n: int, d: int, n_buckets: int, device, seed: int = 2023):
    """A small synthetic index for ``--synthetic``: the JAX package's demo
    (blobs of per-coordinate spread 0.25 around ``min(64, 2·buckets)``
    unit centers, k-means, MLP, 8 epochs), drawn on ``device``."""
    import learnedmetricindex_tpu_torch as lmi
    from learnedmetricindex_tpu_torch.data import BlobGenerator

    data = BlobGenerator(min(64, n_buckets * 2), d, seed, noise=0.25 * d**0.5,
                         device=device).rows(n)
    cfg = lmi.BuildConfiguration("kmeans", 8, "MLP", 0.01, [n_buckets], seed=seed,
                                 chunk_size=1024)
    index, data_prediction, *_ = lmi.LearnedIndexBuilder(data, cfg, device=device).build()
    return index, data_prediction, data


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m learnedmetricindex_tpu_torch.serve`` — serve a synthetic
    demo index (``--synthetic N``), a dynamic checkpoint (``--index
    ckpt``) or a saved index over its corpus (``--index index.npz
    --data corpus.npy``, or an ``.h5`` file with dataset ``emb``) on
    ``--device`` (default ``cuda``: without a GPU this raises; ``--device
    cpu`` runs the plain versions).  ``--shard-devices N`` shards the
    store by bucket over ``parallel.mesh.device_list(N, device)`` (the
    first N cards; ``["cpu"] * N`` on the CPU) and, with ``--dynamic``,
    serves a ``ShardedDynamicIndex``."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device to serve on (cuda, cpu, ...)")
    p.add_argument("--index", help="saved index .npz (save_index), or a dynamic checkpoint")
    p.add_argument("--data", help="corpus rows for a saved index (.npy, or .h5 with dataset emb)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="serve a synthetic demo index of N rows instead")
    p.add_argument("--d", type=int, default=128, help="synthetic dim")
    p.add_argument("--buckets", type=int, default=16, help="synthetic leaf buckets")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8088)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--n-buckets", type=int, default=4, help="buckets visited per query")
    p.add_argument("--policy", default="best_first", choices=["best_first", "joint"])
    p.add_argument("--nav-temp", default=None,
                   help="navigation softmax temperature: scalar or per-level comma list")
    p.add_argument("--precision", default="default", choices=["default", "highest", "int8"])
    p.add_argument("--no-rerank", action="store_true")
    p.add_argument("--max-batch", type=int, default=4096)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--dynamic", action="store_true",
                   help="enable POST /insert, /delete and /compact (a DynamicIndex)")
    p.add_argument("--shard-devices", type=int, default=0,
                   help="shard the store by bucket over the first N cards (-1: all; "
                        "with --device cpu, N repeats of the CPU); composes with --dynamic")
    args = p.parse_args(argv)

    from learnedmetricindex_tpu_torch.cli import parse_nav_temp
    from learnedmetricindex_tpu_torch.index.index import resolve_device
    from learnedmetricindex_tpu_torch.index.serialization import load_dynamic_index, load_index
    from learnedmetricindex_tpu_torch.parallel.mesh import device_list

    device = resolve_device(args.device)
    devices = device_list(args.shard_devices, device) if args.shard_devices else None
    if devices is not None:
        device = devices[0]  # the routers live where the shards merge
    dyn = None
    if args.synthetic:
        index, data_prediction, data = _build_demo_index(args.synthetic, args.d, args.buckets,
                                                         device)
    elif args.index and not args.data:
        # a dynamic checkpoint carries its own corpus
        try:
            dyn = load_dynamic_index(args.index, device)
        except ValueError as e:
            p.error(str(e) + " (plain checkpoints also need --data)")
        args.dynamic = True
    else:
        if not args.index or not args.data:
            p.error("--index and --data are required (or use --synthetic N)")
        index, data_prediction = load_index(args.index, device)
        if data_prediction is None:
            p.error(f"{args.index} was saved without data_prediction — "
                    "re-save with save_index(index, path, data_prediction)")
        if args.data.endswith((".h5", ".hdf5")):
            from learnedmetricindex_tpu_torch.data import load_h5

            data = load_h5(args.data, "emb")
        else:
            data = np.load(args.data).astype(np.float32)

    knobs = dict(
        k=args.k, n_buckets=args.n_buckets, policy=args.policy,
        nav_temp=parse_nav_temp(args.nav_temp),
        precision=args.precision, rerank=not args.no_rerank,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
    )
    if dyn is not None:
        server = SearchServer(dyn, **knobs)
    elif devices is not None and args.dynamic:
        server = SearchServer(
            ShardedDynamicIndex.from_built(index, data, data_prediction, devices), **knobs)
    elif devices is not None:
        server = SearchServer(index, index.get_sharded_store(data, data_prediction, devices),
                              **knobs)
    elif args.dynamic:
        server = SearchServer(DynamicIndex.from_built(index, data, data_prediction), **knobs)
    else:
        server = SearchServer(index, index.get_bucket_store(data, data_prediction), **knobs)
    httpd = make_http_server(server, args.host, args.port)
    host, port = httpd.server_address[:2]
    endpoints = "POST /search, GET /healthz, GET /stats" + (
        ", POST /insert, POST /delete, POST /compact" if args.dynamic else "")
    where = device if devices is None else f"{len(devices)} shards on {devices}"
    print(f"lmi-serve listening on http://{host}:{port} on {where} ({endpoints})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
