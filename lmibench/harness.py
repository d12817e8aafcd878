"""One run of one cell: set-up from the seed, the measured window, the
comparison with the reference, and the result line.

Set-up builds everything on the device: the corpus in blocks, the
hand-set MLP-4 through ``index_from_arrays``, each row's bucket by the
index's own ``classify``, and the store by ``prepare_packed_store`` (the
corpus is freed once the store is packed).  A serving cell wraps the
store in a ``DynamicIndex`` and a ``SearchServer`` and runs the open
loop for the traffic's ``warmup_s`` before the window, so every shape
and path the window uses has run once.
"""

from __future__ import annotations

import contextlib
import gc
import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lmibench import check, generator, inputs, trace as tracing
from lmibench.frozen import handset, work
from lmibench.reference.exact import Reference

_T_IMPORT = time.perf_counter()
#: a minute past the window's close for the last answers
ANSWER_GRACE_S = 60.0


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Record:
    """What the metric readers (``lmibench/metrics``) read."""

    def __init__(self, workload: str, config: dict, traffic: dict):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.setup_s = 0.0
        self.window_s = 0.0
        self.n_queries = 0  # queries answered in the window
        self.latencies_s: List[float] = []  # open loop: due -> answered, inf if failed
        self.calls: List[dict] = []  # closed loop: LearnedIndex.search's ``measured``
        self.stats = None  # open loop: SearchServer.stats() before and after the window
        self.insert_s: List[float] = []
        self.n_dispatches = 0
        self.scan_bound_s: Optional[float] = None  # frozen.work's bound, summed over the window
        self.trace: Optional[tracing.Trace] = None
        self.counters: Dict[str, int] = {}


def _counters() -> Dict[str, int]:
    from learnedmetricindex_tpu_torch.ops import cuda_build, gather_kernel, scan_kernel

    out = {name.lower(): getattr(scan_kernel, name) for name in dir(scan_kernel)
           if name.endswith("LAUNCHES") and isinstance(getattr(scan_kernel, name), int)}
    out["gather_launches"] = gather_kernel.LAUNCHES
    out["gather_pair_launches"] = gather_kernel.PAIR_LAUNCHES
    out["builds"] = cuda_build.BUILDS
    return out


class Cell:
    """The port as set up for one cell and seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, log):
        import learnedmetricindex_tpu_torch as lmi
        from learnedmetricindex_tpu_torch.index.serialization import index_from_arrays

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.log = log
        n, d, nb = config["rows"], config["dim"], config["n_buckets"]
        int8 = config["store"] == "int8"
        gen = inputs.generator(config, seed, self.device)
        cpos = inputs.centroid_positions(config, seed)
        centroids = torch.empty(nb, d, device=self.device)
        values = torch.empty((n, d), dtype=torch.int8 if int8 else torch.float32,
                             device=self.device)
        scales = torch.empty(n, device=self.device) if int8 else None
        synchronize(self.device)
        log(f"[setup] device context and buffers: process age {process_age_s():.2f} s")
        t0 = time.perf_counter()
        for s0, x in inputs.corpus_blocks(gen, config):
            e = s0 + len(x)
            v, s = inputs.stored_form(x, config["store"])
            values[s0:e] = v
            if int8:
                scales[s0:e] = s
            hit = (cpos >= s0) & (cpos < e)
            if hit.any():
                rows = (cpos[hit] - s0).to(self.device)
                centroids[torch.nonzero(hit)[:, 0].to(self.device)] = x[rows]
            del x, v, s
        synchronize(self.device)
        log(f"[setup] corpus {n}x{d} {config['store']}: {time.perf_counter() - t0:.2f} s")
        self.params = handset.mlp4_params(centroids, config["hidden"])
        cfg = lmi.BuildConfiguration("kmeans", 4, config["model"], 0.01, [nb],
                                     chunk_size=config["chunk_size"], dtype=config["store"])
        self.index = index_from_arrays(cfg, [self.params], [np.ones((1, nb), bool)],
                                       [config["model"]], np.ones(nb, bool), self.device)
        t0 = time.perf_counter()
        pred = np.empty((n, 1), np.int64)
        for s0 in range(0, n, inputs.BLOCK):
            e = min(s0 + inputs.BLOCK, n)
            pred[s0:e] = self.index.classify(
                inputs.as_float(values[s0:e], None if scales is None else scales[s0:e]))
        log(f"[setup] buckets by the index's classify: {time.perf_counter() - t0:.2f} s; sizes "
            f"min {np.bincount(pred[:, 0], minlength=nb).min()} "
            f"max {np.bincount(pred[:, 0], minlength=nb).max()}")
        t0 = time.perf_counter()
        self.store = self.index.prepare_packed_store(
            (values, scales) if int8 else values, pred)
        del values, scales, pred
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        synchronize(self.device)
        log(f"[setup] packed store {self.store.nbytes() / 1e9:.2f} GB: "
            f"{time.perf_counter() - t0:.2f} s")
        # the query pool, then the rows serving inserts, as the client holds them
        self.pool = gen.rows(traffic["queries"]).cpu().numpy()
        self._gen = gen
        self.ins_rows = np.zeros((0, d), np.float32)
        self.ins_cursor = 0
        self.muts = check.Mutations()
        self.server = self.dynamic = None

    def reserve_inserts(self, rows: int) -> None:
        """Draw rows so that ``rows`` more can be inserted."""
        need = self.ins_cursor + rows - len(self.ins_rows)
        if need > 0:
            more = self._gen.rows(need).cpu().numpy()
            self.ins_rows = np.concatenate([self.ins_rows, more])

    def knobs(self, overrides: dict) -> dict:
        t = {**self.traffic, **overrides}
        return {"n_buckets": t["visits"], "k": t["k"], "precision": t["precision"],
                "rerank": t.get("rerank", True), "rerank_margin": t["rerank_margin"]}

    def free(self) -> None:
        if self.server is not None:
            self.server.close()
        self.server = self.dynamic = self.index = self.store = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Window:
    """What one window produced."""

    def __init__(self):
        self.answers: List[check.Answer] = []
        self.unanswered = 0
        self.attempted = 0
        self.n_queries = 0
        self.latencies_s: List[float] = []
        self.calls: List[dict] = []
        self.insert_s: List[float] = []
        self.probes: List[tuple] = []
        self.dispatches: List[tuple] = []  # (t, queries) of each dispatch, traced runs
        self.window_s = 0.0
        self.lateness_s: List[float] = []


def closed_loop(cell: Cell, seconds: float, overrides: dict, spans: bool,
                warm: bool = False) -> Window:
    """Back-to-back ``search`` calls of the whole pool, host float32."""
    kn = cell.knobs(overrides)
    w = Window()
    pool, qidx = cell.pool, np.arange(len(cell.pool))
    got = []
    t0 = time.perf_counter()
    while True:
        try:
            with (torch.profiler.record_function("lmibench.search") if spans
                  else contextlib.nullcontext()):
                d, ids, measured = cell.index.search(None, pool, None, pool, None,
                                                     store=cell.store, **kn)
            w.calls.append(measured)
            w.n_queries += len(pool)
            got.append((d, ids))
        except Exception as e:  # noqa: BLE001 -- a failed call is counted, not fatal
            cell.log(f"[window] search failed: {e!r}")
            w.unanswered += len(pool)
        w.attempted += len(pool)
        if warm or time.perf_counter() - t0 >= seconds:
            break
    w.window_s = time.perf_counter() - t0
    seen = set()
    for d, ids in got:  # identical answers are compared once
        key = (d.tobytes(), ids.tobytes())
        if key not in seen:
            seen.add(key)
            w.answers.append(check.Answer(qidx, d, ids))
    return w


def start_server(cell: Cell, overrides: dict):
    """A ``SearchServer`` over the cell's ``DynamicIndex`` with the traffic's
    knobs (``overrides`` on top), replacing the cell's last one."""
    from learnedmetricindex_tpu_torch.index.mutation import DynamicIndex
    from learnedmetricindex_tpu_torch.serve import SearchServer

    t = {**cell.traffic, **overrides}
    if cell.dynamic is None:
        cell.dynamic = DynamicIndex(cell.index, cell.store)
    if cell.server is not None:
        cell.server.close()
    kn = cell.knobs(overrides)
    cell.server = SearchServer(cell.dynamic, k=kn["k"], n_buckets=kn["n_buckets"],
                               precision=kn["precision"], rerank=kn["rerank"],
                               rerank_margin=kn["rerank_margin"], max_batch=t["max_batch"],
                               max_wait_ms=t["max_wait_ms"])
    return cell.server


def open_loop(cell: Cell, seconds: float, stream: int, spans: bool, keep: bool) -> Window:
    """Requests on the traffic's schedule to the cell's server, with the
    mutator alongside; ``keep`` keeps the answers for the comparison."""
    server, traffic = cell.server, cell.traffic
    sched = generator.arrivals(traffic, cell.seed, seconds, stream)
    mut_due = generator.mutation_times(traffic, seconds)
    m = traffic.get("mutations") or {}
    cell.reserve_inserts(len(mut_due) * m.get("insert_rows", 0))
    w = Window()
    w.attempted = len(sched)
    done = [None] * len(sched)
    q: queue.Queue = queue.Queue()
    errors: List[BaseException] = []
    index = server.index
    wrapped = None
    if spans:  # a span around each dispatch, and what it held
        wrapped = index.search

        def search(*a, **kw):
            t = time.perf_counter()
            with torch.profiler.record_function("lmibench.dispatch"):
                out = wrapped(*a, **kw)
            w.dispatches.append((t, a[1]))
            return out
        index.search = search
    t0 = time.perf_counter() + 0.01

    def collector():
        while True:
            item = q.get()
            if item is None:
                return
            i, req, t_sub = item
            try:
                d, ids = req.wait(max(t0 + seconds + ANSWER_GRACE_S - time.perf_counter(), 0.1))
                done[i] = (t_sub, time.perf_counter(), d, ids)
            except Exception as e:  # noqa: BLE001 -- an answer that never came
                done[i] = (t_sub, None, repr(e), None)

    def mutator():
        try:
            for due in mut_due:
                time.sleep(max(t0 + due - time.perf_counter(), 0.0))
                rows = cell.ins_rows[cell.ins_cursor : cell.ins_cursor + m["insert_rows"]]
                first = cell.ins_cursor
                cell.ins_cursor += len(rows)
                ta = time.perf_counter()
                ids = server.insert(rows)
                tb = time.perf_counter()
                cell.muts.inserts.append((ta, tb, np.asarray(ids), first))
                w.insert_s.append(tb - ta)
                # every other row goes again; a search for two that stay must find them
                gone = np.arange(len(rows))[1::2][: m["delete_rows"]]
                kept = np.setdiff1d(np.arange(len(rows)), gone)[:2]
                w.probes.append((server.submit(rows[kept], k=1), np.asarray(ids)[kept], True))
                tc = time.perf_counter()
                server.delete(np.asarray(ids)[gone])
                cell.muts.deletes.append((tc, time.perf_counter(), np.asarray(ids)[gone]))
                # and a search for two that went must not find them
                w.probes.append((server.submit(rows[gone[:2]], k=1), np.asarray(ids)[gone[:2]],
                                 False))
        except Exception as e:  # noqa: BLE001 -- reported through unanswered
            errors.append(e)

    threads = [threading.Thread(target=collector, name="lmibench-collect")]
    if len(mut_due):
        threads.append(threading.Thread(target=mutator, name="lmibench-mutate"))
    for t in threads:
        t.start()
    for i, (due, off, nq) in enumerate(sched):
        time.sleep(max(t0 + due - time.perf_counter(), 0.0))
        t_sub = time.perf_counter()
        w.lateness_s.append(t_sub - (t0 + due))
        try:
            q.put((i, server.submit(cell.pool[off : off + nq]), t_sub))
        except Exception as e:  # noqa: BLE001 -- a refused request
            done[i] = (t_sub, None, repr(e), None)
    q.put(None)
    for t in threads:
        t.join(seconds + ANSWER_GRACE_S + 30)
    if wrapped is not None:
        index.search = wrapped
    t_end = max([x[1] for x in done if x is not None and x[1] is not None] + [t0])
    w.window_s = t_end - t0
    for i, ((due, off, nq), x) in enumerate(zip(sched, done)):
        if x is None or x[1] is None:
            w.unanswered += 1
            w.latencies_s.append(float("inf"))
            if x is not None:
                cell.log(f"[window] request {i} failed: {x[2]}")
            continue
        t_sub, t_done, d, ids = x
        w.latencies_s.append(t_done - (t0 + due))
        w.n_queries += nq
        if keep:
            w.answers.append(check.Answer(np.arange(off, off + nq), d, ids, t_sub, t_done))
    probes = []
    for req, want, found in w.probes:
        try:
            _, got = req.wait(ANSWER_GRACE_S)
            probes.extend((g, x, found) for g, x in zip(got[:, 0], want))
        except Exception:  # noqa: BLE001 -- a probe that never came misses
            probes.extend((None, x, found) for x in want)
    w.probes = probes
    for e in errors:
        cell.log(f"[window] mutator failed: {e!r}")
        w.unanswered += 1
    return w


def _scan_bound_s(ref: Reference, cell: Cell, win: Window, pool_t: torch.Tensor) -> float:
    """frozen.work's bound, summed over the window's searches."""
    cfg, t = cell.config, cell.traffic
    k_scan = t["k"] + t["rerank_margin"] if t.get("rerank", True) else t["k"]
    V = t["visits"]

    def visits(x: torch.Tensor) -> np.ndarray:
        return torch.topk(ref.logits(x), min(V, ref.nb), dim=1).indices.cpu().numpy()

    sizes = ref.bucket_sizes()
    if not win.dispatches:  # the closed loop: every call the same
        one = work.scan_work(visits(pool_t), sizes, cfg["dim"], cfg["store"], t["precision"],
                             k_scan)
        return one["bound_s"] * len(win.calls)
    # open loop: each dispatch at the bucket sizes of its moment
    events = [(t1, ref.ins_b1[ref_pos(ref, ids)].cpu().numpy(), +1)
              for _, t1, ids, _ in cell.muts.inserts]
    events += [(t1, ref.ins_b1[ref_pos(ref, ids)].cpu().numpy(), -1)
               for _, t1, ids in cell.muts.deletes]
    events.sort(key=lambda e: e[0])
    total, j, cur = 0.0, 0, sizes.astype(np.int64).copy()
    for t_d, qs in sorted(win.dispatches, key=lambda x: x[0]):
        while j < len(events) and events[j][0] < t_d:
            np.add.at(cur, events[j][1], events[j][2])
            j += 1
        x = torch.as_tensor(np.asarray(qs, np.float32), device=ref.device)
        total += work.scan_work(visits(x), cur, cfg["dim"], cfg["store"], t["precision"],
                                k_scan)["bound_s"]
    return total


def ref_pos(ref: Reference, ids) -> torch.Tensor:
    _, _, ipos = ref.resolve(torch.as_tensor(np.asarray(ids, np.int64), device=ref.device))
    return ipos.clamp_min(0)


def run(bench: dict, cell_spec: dict, seed: int, seconds: float, trace: bool, device,
        log, *, config: Optional[dict] = None, traffic: Optional[dict] = None,
        limits: Optional[dict] = None, overrides: Optional[dict] = None):
    """One run of a cell.  Returns ``(result line dict, numbers, limits)``."""
    from lmibench import spec

    workload = cell_spec["name"]
    config = config or spec.config(cell_spec["config"])
    traffic = traffic or spec.traffic(cell_spec["traffic"])
    limits = limits if limits is not None else spec.limits(workload)
    overrides = overrides or {}
    device = torch.device(device)
    rec = Record(workload, config, traffic)
    log(f"[setup] imports: process age {process_age_s():.2f} s")
    c = Cell(config, traffic, seed, device, log)
    serving = traffic["kind"] == "open_loop"
    t_warm = time.perf_counter()
    # warm-up: every shape the window runs, before the clock starts
    if serving:
        c.reserve_inserts(generator.insert_rows_needed(traffic, seconds))
        start_server(c, overrides)
        open_loop(c, traffic.get("warmup_s", 1.0), stream=1, spans=False, keep=False)
    else:
        for _ in range(2):
            closed_loop(c, 0.0, overrides, spans=False, warm=True)
    synchronize(device)
    before = _counters()
    rec.setup_s = process_age_s()
    log(f"[setup] warm-up {time.perf_counter() - t_warm:.2f} s; set-up {rec.setup_s:.2f} s")
    prof = tracing.profiler() if trace else None
    if prof is not None:
        prof.start()
    stats0 = c.server.stats() if serving else None
    chunks0 = c.dynamic.store.n_chunks if serving else 0
    with torch.profiler.record_function(tracing.WINDOW):
        if serving:
            win = open_loop(c, seconds, stream=0, spans=trace, keep=True)
        else:
            win = closed_loop(c, seconds, overrides, spans=trace)
        synchronize(device)
    if prof is not None:
        prof.stop()
    rec.window_s = win.window_s
    rec.stats = (stats0, c.server.stats()) if serving else None
    after = _counters()
    rec.counters = {k: after[k] - before.get(k, 0) for k in after}
    rec.counters["builds_in_process"] = after["builds"]
    # the process's peak so far: set-up's corpus and store, then the window
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec.n_queries = win.n_queries
    rec.latencies_s = win.latencies_s
    rec.calls = win.calls
    rec.insert_s = win.insert_s
    rec.n_dispatches = len(win.dispatches)
    if win.lateness_s:
        lat = np.asarray(win.lateness_s) * 1e3
        log(f"[window] generator lateness ms: mean {lat.mean():.4f} p99 "
            f"{np.percentile(lat, 99):.4f} max {lat.max():.4f} over {len(lat)} requests")
    log(f"[window] {win.window_s:.4f} s, {win.n_queries} queries answered, "
        f"{win.unanswered} unanswered, counters {rec.counters}")
    if serving:
        ins = np.asarray(win.insert_s + [0.0]) * 1e3
        log(f"[window] store chunks {chunks0} -> {c.dynamic.store.n_chunks}; inserts "
            f"{len(win.insert_s)}, ms median {np.median(ins):.3f} max {ins.max():.3f}; "
            f"dispatches {rec.stats[1]['batches'] - rec.stats[0]['batches']}")
    # the reference, once the port's state is freed
    muts, ins_rows, ins_cursor, params, pool = c.muts, c.ins_rows, c.ins_cursor, c.params, c.pool
    c.free()
    t0 = time.perf_counter()
    ref = Reference(params, config, device)
    ref.load_corpus(seed)
    for _, _, ids, first in muts.inserts:
        ref.add_inserted(torch.as_tensor(ins_rows[first : first + len(ids)]), ids)
    pool_t = torch.as_tensor(pool, device=device)
    kn = {**traffic, **overrides}
    numbers = check.compare(ref, pool_t, kn["visits"], kn["k"], win.answers,
                            muts if serving else None, win.probes, win.unanswered)
    if trace:
        rec.trace = tracing.Trace(prof)
        log(f"[trace] {rec.trace.n_device_events} device events, {rec.trace.n_host_events} host "
            f"events, busy {rec.trace.busy_s:.4f} of {rec.trace.window_s:.4f} s")
        rec.scan_bound_s = _scan_bound_s(ref, c, win, pool_t)
    log(f"[check] reference {time.perf_counter() - t0:.2f} s over {len(win.answers)} answers")
    del ref
    gc.collect()
    correct = all(numbers[n] <= limits[n] for n in check.NUMBERS)
    metrics = {}
    wanted = spec.per_layer(bench, workload) if trace else spec.end_to_end(bench, workload)
    for m in wanted:
        value = spec.metric_module(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.unanswered), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = tracing.breakdown(rec.trace)
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]} for n in check.NUMBERS}
    return result, numbers, limits
