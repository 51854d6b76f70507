"""Benchmark: batched queries/sec/chip (primary metric, BASELINE.json:2).

The primary number is the PUBLIC API serving loop (round-2 VERDICT #1):
`SearchEngine.search_stream` over raw query TEXT batches — tokenize/hash
analysis, df lookup, slot->row mapping, mixed-block bucket planning,
host->device staging, ONE fused device dispatch per batch (DMA plan
tables expand on device), and the single device->host readback of ranked
(ids, scores) — all inside the timed loop, pipelined depth-N exactly as
production serving runs. Nothing is pre-staged in the loop except the
immutable index and the query strings themselves.

The 1M-doc Zipf index goes through the production build code path with
its postings GENERATED ON DEVICE: the vocabulary is real token strings
hashed by the real analyzer, the geometry comes from
`builder.aligned_geometry`, and the value plane is materialized by
`builder.device_materialize_vals` — the same jit job the engine's device
build runs. Only the O(nnz) doc/tf plane contents are synthesized
in-place on device (chip_smoke.py builds the same shape from text
through SearchEngine.build). Work per query depends on postings
touched, not corpus size; BENCH_DOCS=8000000 runs the 8M config.

Secondary metrics print to stderr: serving without text analysis
(pre-analyzed slot arrays through the same dispatch), device-step-only
qps (fixed staged batch — the round-1/2 metric), and host/device index
build docs/sec over a real synthetic corpus.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", ...}; vs_baseline is value / 10_000 (the BASELINE.json:5
target). It refuses to run on a backend other than the GPU.

Env knobs: BENCH_DOCS (default 1_000_000), BENCH_NQ (16384), BENCH_K (10),
BENCH_ITERS (24), BENCH_KIND (bm25), BENCH_DEPTH (8, pipelining),
BENCH_SCORER ('' = backend default | fused | xla),
BENCH_TERMS_PER_QUERY (8), BENCH_AVG_TERMS (60, postings density),
BENCH_BATCHES (8 distinct query batches), BENCH_BUILD (1),
BENCH_BUILD_DEVICE (0), BENCH_SHARDS (1: time the 1-shard SPMD
serving path), BENCH_PACK (1: run the real jit CSR pack at full scale,
on-device), BENCH_PASSES (5), BENCH_SPLIT (doc-range split threshold in
compacted rows: '' = engine default (off), '0' = off, e.g. '64'),
BENCH_8M (1: 8M-doc config-3 leg with memory accounting), BENCH_STREAM
(1: 1M-doc streaming-build leg), BENCH_DEADLINE (3300 s: optional legs
are skipped past this so the JSON artifact always prints; 0 disables).

A leg that fails or is skipped past the deadline is logged and named in
the JSON line's "failed_legs", and the run then exits non-zero.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from document_search_engine_tpu.utils.cache import enable_persistent_cache


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class LegTimeout(Exception):
    """A bench phase exceeded its watchdog budget. Converted to an
    exception so a hung leg is recorded as failed instead of hanging the
    whole run."""


def with_alarm(fn, secs: int):
    """Run fn() under a SIGALRM watchdog; raise LegTimeout at secs.
    The handler interrupts Python-level waits AND most blocking C calls
    (EINTR surfaces the pending exception); a leg that hangs stops
    costing wall clock instead of stalling the artifact."""
    import signal

    if secs <= 0 or not hasattr(signal, "SIGALRM"):
        return fn()

    def _h(_sig, _frm):
        raise LegTimeout(f"phase exceeded its {secs}s watchdog")

    old = signal.signal(signal.SIGALRM, _h)
    prev_remaining = signal.alarm(secs)  # nesting: outer watchdog left
    t0 = time.monotonic()
    try:
        return fn()
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        if prev_remaining:  # re-arm the outer watchdog's remainder
            left = prev_remaining - (time.monotonic() - t0)
            signal.alarm(max(1, int(left)))


def timed_serving_passes(label, eng_like, batches, nq, iters, k, depth,
                         passes):
    """`passes` timed serving passes over the PUBLIC search_stream API;
    every pass is logged and the returned dict carries best AND median,
    so the artifact is self-describing."""
    qps_list = []
    for p in range(passes):
        t0 = time.perf_counter()
        n_out = 0
        lat, submit_t = [], []

        def timed_batches():
            for i in range(iters):
                submit_t.append(time.perf_counter())
                yield batches[i % len(batches)]

        for ids, _sc in eng_like.search_stream(
            timed_batches(), k=k, depth=depth
        ):
            lat.append(time.perf_counter() - submit_t[len(lat)])
            n_out += len(ids)
        dt = time.perf_counter() - t0
        assert n_out == nq * iters
        qps_p = nq * iters / dt
        qps_list.append(round(qps_p, 1))
        lat_ms = np.sort(np.array(lat) * 1e3)
        log(
            f"{label} pass {p + 1}/{passes}: {iters} iters in "
            f"{dt:.3f}s -> {qps_p:,.0f} q/s "
            f"({dt / iters * 1e3:.2f} ms/batch of {nq}; latency "
            f"p50={lat_ms[len(lat_ms) // 2]:.0f} "
            f"p90={lat_ms[int(len(lat_ms) * 0.9)]:.0f} "
            f"max={lat_ms[-1]:.0f} ms)"
        )
    out = {
        "best": max(qps_list),
        "median": round(float(np.median(qps_list)), 1),
        "passes": qps_list,
    }
    log(
        f"{label}: best {out['best']:,.0f} / median "
        f"{out['median']:,.0f} q/s over {len(qps_list)} passes"
    )
    return out


def stream_pass_qps(eng_like, batches, nq, iters, k, depth):
    """One timed serving pass over the public search_stream API (the
    same loop timed_serving_passes runs); returns q/s."""
    t0 = time.perf_counter()
    n_out = 0

    def gen():
        for i in range(iters):
            yield batches[i % len(batches)]

    for ids, _sc in eng_like.search_stream(gen(), k=k, depth=depth):
        n_out += len(ids)
    dt = time.perf_counter() - t0
    assert n_out == nq * iters
    return nq * iters / dt


def make_batches(df_by_row, tokens_by_row, nq, tpq, n_batches, seed=7):
    """Fresh raw-TEXT query batches sampled from mid-df vocabulary."""
    rng = np.random.default_rng(seed)
    eligible = np.where((df_by_row >= 64) & (df_by_row <= 32768))[0]
    batches = []
    for _b in range(n_batches):
        rows = rng.choice(eligible, size=(nq, tpq))
        batches.append(
            [" ".join(tokens_by_row[r] for r in qr) for qr in rows]
        )
    return batches, int(df_by_row[rows].sum(1).mean())


def engine_hbm_bytes(eng) -> int:
    """Resident device bytes of the index: posting planes, CSR lookup
    tables, per-doc arrays, cached doc-quantile tables — evidence for
    the "at equal memory" clause of BASELINE.json:5."""
    total = 0
    for _h, d in eng.segments:
        for arr in (
            d.post_doc, d.post_val, d.post_tf, d.indptr, d.row_start,
            d.dl, d.alive, d.inv_norm,
        ):
            total += int(arr.size) * arr.dtype.itemsize
    for ent in (getattr(eng, "_quant_cache", None) or {}).values():
        total += int(ent[2].size) * 4  # (T, P+1) i32 quantile tables
    return total


def lever_config(eng, depth, nq, iters, k, kind):
    """The full kernel/plan lever configuration that produced the
    numbers (round-4 VERDICT #1b: BENCH_r04 did not record which
    configuration produced its qps, so the artifact was not
    self-describing)."""
    from document_search_engine_tpu.ops.schedule import (
        DEFAULT_FAMILIES,
        FUSED_FAMILIES,
    )

    fams = eng.block_families or (
        FUSED_FAMILIES if eng.scorer_mode == "fused" else DEFAULT_FAMILIES
    )
    return {
        "scorer": eng.scorer_mode,
        "kind": kind,
        "split_rows": eng.split_rows,
        "families": [list(f) for f in fams],
        "plan_min_blocks": eng.plan_min_blocks,
        "pipeline_depth": depth,
        "nq": nq,
        "iters": iters,
        "k": k,
    }


def step_only_qps(eng, pre0, k, iters, depth, nq, label):
    """Device-step-only qps (the round-1/2 metric): capture one staged
    dispatch's args through the public path, then re-run the fixed jit
    step `iters` times with a depth-N in-flight window."""
    from collections import deque

    from document_search_engine_tpu.engine import engine as engine_mod

    captured = {}
    real_step = engine_mod._batch_step

    def capture_step(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return real_step(*args, **kw)

    engine_mod._batch_step = capture_step
    try:
        fut = eng._dispatch(*pre0, k)
        _ = eng._collect(fut)
    finally:
        engine_mod._batch_step = real_step
    args, kw = captured["args"], captured["kw"]
    t0 = time.perf_counter()
    inflight = deque()
    for _i in range(iters):
        inflight.append(real_step(*args, **kw))
        if len(inflight) >= depth:
            _ = np.asarray(inflight.popleft())
    while inflight:
        _ = np.asarray(inflight.popleft())
    dt0 = time.perf_counter() - t0
    qps = nq * iters / dt0
    log(
        f"{label}: {qps:,.0f} q/s ({dt0 / iters * 1e3:.2f} "
        f"ms/batch, fixed staged batch, full readback)"
    )
    return round(qps, 1)


def synth_text_batches(n_docs, vocab, mean_len, batch_docs, seed=3):
    """Vectorized Zipf text batches for the streaming-build leg
    (corpus.synth.synth_corpus draws per-doc, ~minutes at 1M docs)."""
    rng = np.random.default_rng(seed)
    tokens = np.array([f"s{i:06d}" for i in range(vocab)])
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks)
    cdf /= cdf[-1]
    out = []
    for lo in range(0, n_docs, batch_docs):
        nb = min(batch_docs, n_docs - lo)
        lens = np.maximum(5, rng.poisson(mean_len, nb))
        ptr = np.zeros(nb + 1, np.int64)
        np.cumsum(lens, out=ptr[1:])
        toks = tokens[np.searchsorted(cdf, rng.random(int(ptr[-1])))]
        out.append(
            [" ".join(toks[ptr[i] : ptr[i + 1]]) for i in range(nb)]
        )
    return out


def zipf_df(n_docs: int, vocab: int, avg_terms: int):
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    df = np.maximum(1, (probs * n_docs * avg_terms).astype(np.int64))
    return np.minimum(df, n_docs)


def build_synth_engine(n_docs, vocab, avg_terms, cfg, seed=1):
    """A 1M-doc-scale SearchEngine through the production build path,
    with the O(nnz) plane contents generated on device (module
    docstring): real analyzer vocabulary, real aligned geometry, real
    jit value materialization. Returns (engine, df_by_row, tokens_by_row)
    so the caller can synthesize matching query TEXT."""
    import jax
    import jax.numpy as jnp

    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.index import builder
    from document_search_engine_tpu.index.csr import (
        GlobalStats,
        SegmentDevice,
        SegmentHost,
        round_up,
    )

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    # vocabulary: real token strings through the real analyzer/hasher
    tokens = [f"w{i:07d}" for i in range(vocab)]
    a = builder.analyze_texts_fast(tokens, cfg)  # one 1-term doc each
    assert len(a.hashes) == vocab, "synthetic tokens must hash uniquely"
    order = np.argsort(a.hashes, kind="stable")
    term_hash = a.hashes[order]
    tokens_by_row = [tokens[i] for i in order]
    df_by_rank = zipf_df(n_docs, vocab, avg_terms)
    df_by_row = df_by_rank[order]  # rank->hash-row permutation
    log(f"vocab: {vocab} tokens analyzed+hashed in "
        f"{time.perf_counter()-t0:.1f}s")

    lens = df_by_row.astype(np.int64)
    indptr64 = np.zeros(vocab + 1, np.int64)
    np.cumsum(lens, out=indptr64[1:])
    indptr = indptr64.astype(np.int32)
    row_start, x_rows = builder.aligned_geometry(indptr, cfg.nnz_pad_to)
    total = x_rows * 128
    log(f"synth index: {n_docs} docs, {vocab} terms, "
        f"nnz={lens.sum()/1e6:.1f}M aligned={total/1e6:.1f}M slots")
    al_ind = np.zeros(vocab + 1, np.int64)
    al_ind[:-1] = row_start
    al_ind[-1] = total

    gen_chunk = 1 << 24

    @jax.jit
    def gen(al_start_d, lens_d, key, start):
        """One chunk of the aligned (doc, tf) planes: per flat slot,
        derive its term row + in-row position, draw a doc id spread over
        the corpus and a small tf; out-of-row slots get the sentinel."""
        i = start + jnp.arange(gen_chunk, dtype=jnp.int32)
        row = jnp.searchsorted(al_start_d[1:], i, side="right").astype(
            jnp.int32
        )
        row = jnp.minimum(row, vocab - 1)
        pos = i - al_start_d[row]
        ln = jnp.maximum(lens_d[row], 1).astype(jnp.float32)
        u = jax.random.uniform(key, (gen_chunk,), jnp.float32)
        doc = ((pos.astype(jnp.float32) + u) / ln * n_docs).astype(
            jnp.int32
        )
        doc = jnp.clip(doc, 0, n_docs - 1)
        tf = jax.random.randint(key, (gen_chunk,), 1, 5, jnp.int32)
        pad = pos >= lens_d[row]
        return (
            jnp.where(pad, n_docs, doc),
            jnp.where(pad, 0, tf),
        )

    t0 = time.perf_counter()
    al_start_d = jnp.asarray(al_ind.astype(np.int32))
    lens_d = jnp.asarray(lens.astype(np.int32))
    key = jax.random.PRNGKey(seed)
    dch, tch = [], []
    for c0 in range(0, total, gen_chunk):
        d_c, t_c = gen(
            al_start_d, lens_d, jax.random.fold_in(key, c0), jnp.int32(c0)
        )
        dch.append(d_c)
        tch.append(t_c)
    doc2 = jnp.concatenate(dch)[:total].reshape(x_rows, 128)
    tf2 = jnp.concatenate(tch)[:total].reshape(x_rows, 128)
    del dch, tch

    # per-doc stats + PRODUCTION value materialization (builder jit job)
    dl = rng.integers(40, 200, n_docs).astype(np.int32)
    stats = GlobalStats(
        vocab=term_hash,
        df=df_by_row.astype(np.int32),
        n_alive=n_docs,
        total_len_alive=int(dl.sum()),
    )
    d_pad = round_up(n_docs + 1, cfg.docs_pad_to)
    alive = np.ones(n_docs, bool)
    k_doc = builder._pad(
        builder.host_k_doc(dl, cfg, stats), d_pad, 0, np.float32
    )
    if cfg.scoring.kind == "tfidf":
        # synthetic positive inv-norms (spec norms need per-doc term
        # lists, which the on-device generator does not materialize)
        inv = builder._pad(
            (rng.random(n_docs) * 0.2 + 0.02).astype(np.float32),
            d_pad, 0, np.float32,
        )
    else:
        inv = np.zeros(d_pad, np.float32)
    alive_d = jnp.asarray(builder._pad(alive, d_pad, False, bool))
    inv_d = jnp.asarray(inv)
    val2 = builder.device_materialize_vals(
        doc2, tf2, jnp.asarray(k_doc), inv_d, alive_d,
        jnp.float32(np.float32(cfg.scoring.k1 + 1.0)),
        kind=cfg.scoring.kind,
    )
    host = SegmentHost(
        term_hash=term_hash,
        df=df_by_row.astype(np.int32),
        doc_base=0,
        n_docs=n_docs,
        dl=dl,
        alive=alive,
        indptr=indptr,
        row_start=row_start,
    )
    device = SegmentDevice(
        indptr=jnp.asarray(indptr),
        row_start=jnp.asarray(row_start.astype(np.int32)),
        post_doc=doc2,
        post_val=val2,
        post_tf=tf2,
        dl=jnp.asarray(
            builder._pad(dl.astype(np.float32), d_pad, 0, np.float32)
        ),
        alive=alive_d,
        inv_norm=inv_d,
    )
    eng = SearchEngine(cfg)
    eng.segments = [[host, device]]
    eng.stats = stats
    eng.n_docs_total = n_docs
    _ = np.asarray(device.post_val[:1, :1])  # force generation
    log(f"index gen (device, incl. jit materialize): "
        f"{time.perf_counter()-t0:.1f}s")
    return eng, df_by_row, tokens_by_row


def sharded_from_engine(eng, cfg):
    """Wrap the synthetic 1M-doc engine's resident planes as a 1-shard
    DistributedSearchEngine so the SPMD serving path (shard_map + device
    plan expansion + all_gather + replicated merge) can be timed on one
    device. The planes never leave device memory; only the small
    global-row lookup tables are built host-side."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine,
        ShardedIndex,
        _global_t_pad,
    )
    from document_search_engine_tpu.parallel.mesh import DOCS_AXIS, make_mesh

    host, dev = eng.segments[0]
    stats = eng.stats
    mesh = make_mesh(1)
    t_pad = _global_t_pad(stats)
    tg = len(stats.vocab)
    ipg = np.zeros((1, t_pad + 1), np.int64)
    ipg[0, 1 : tg + 1] = host.indptr[1:]
    ipg[0, tg + 1 :] = host.indptr[-1]
    ipg = ipg.astype(np.int32)
    rsg = np.zeros((1, t_pad), np.int64)
    rsg[0, :tg] = host.row_start
    rsg = rsg.astype(np.int32)
    d_pad = dev.alive.shape[0]
    sh = NamedSharding(mesh, P(DOCS_AXIS))
    idx = ShardedIndex(
        post_doc=jax.device_put(dev.post_doc[None], sh),
        post_val=jax.device_put(dev.post_val[None], sh),
        post_tf=jax.device_put(dev.post_tf[None], sh),
        alive=jax.device_put(dev.alive[None], sh),
        doc_base=jax.device_put(np.zeros((1, 1), np.int32), sh),
        indptr_g=ipg,
        indptr_d=jax.device_put(ipg, sh),
        row_start_d=jax.device_put(rsg, sh),
        hosts=[host],
        stats=stats,
        n_shards=1,
        d_pad=d_pad,
        t_pad=t_pad,
    )
    deng = DistributedSearchEngine(cfg, mesh=mesh)
    deng.index = idx
    return deng


def bench_device_pack(n_docs, vocab, df_by_row, cfg, eng):
    """Run the REAL jit CSR pack at 1M-doc scale (round-3 VERDICT #4:
    the bench index synthesized plane *contents*, so device_pack /
    device_align_planes never executed at scale). Triples are drawn ON
    DEVICE (row ~ the same Zipf df distribution, doc uniform, tf 1..4)
    so the measurement excludes the host upload; the only host hop is
    the small indptr readback the production build also does (planning
    needs it). First run compiles, second run is timed."""
    import jax
    import jax.numpy as jnp

    from document_search_engine_tpu.index import builder

    nnz = int(df_by_row.sum())
    cum = np.cumsum(df_by_row.astype(np.float64))
    cdf = jnp.asarray((cum / cum[-1]).astype(np.float32))
    chunk = 1 << 24
    n_chunks = -(-nnz // chunk)

    @jax.jit
    def gen_triples(key):
        u = jax.random.uniform(key, (chunk,), jnp.float32)
        r = jnp.minimum(
            jnp.searchsorted(cdf, u).astype(jnp.int32), len(df_by_row) - 1
        )
        d = jax.random.randint(key, (chunk,), 0, n_docs, jnp.int32)
        t = jax.random.randint(key, (chunk,), 1, 5, jnp.int32)
        return r, d, t

    key = jax.random.PRNGKey(11)
    parts = [gen_triples(jax.random.fold_in(key, i)) for i in range(n_chunks)]
    r = jnp.concatenate([p[0] for p in parts])[:nnz]
    d = jnp.concatenate([p[1] for p in parts])[:nnz]
    t = jnp.concatenate([p[2] for p in parts])[:nnz]
    del parts
    _ = np.asarray(r[:1])  # force generation before timing

    host0, dev0 = eng.segments[0]
    k1p1 = jnp.float32(np.float32(cfg.scoring.k1 + 1.0))
    # per-doc K(dl) in the production (host-computed) form, resident
    # before the timed region — the refresh path keeps it resident too
    k_doc_d = jnp.asarray(
        builder._pad(
            builder.host_k_doc(host0.dl, cfg, eng.stats),
            dev0.alive.shape[0], 0, np.float32,
        )
    )
    _ = np.asarray(k_doc_d[:1])

    def run_once():
        r2, d2, t2, indptr_d, _df, _dl = builder.device_pack(
            r, d, t, n_terms=vocab, n_docs=n_docs
        )
        indptr = np.asarray(indptr_d)  # small D2H: planning needs it
        row_start, x_rows = builder.aligned_geometry(
            indptr, cfg.nnz_pad_to
        )
        doc2, tf2 = builder.device_align_planes(
            r2, d2, t2, indptr_d,
            jnp.asarray(row_start.astype(np.int32)),
            x_rows=x_rows, n_docs=n_docs,
        )
        val2 = builder.device_materialize_vals(
            doc2, tf2, k_doc_d, dev0.inv_norm, dev0.alive, k1p1,
            kind=cfg.scoring.kind,
        )
        _ = np.asarray(val2[:1, :1])  # sync
        return val2

    _ = run_once()  # compile
    t0 = time.perf_counter()
    out = run_once()
    dt = time.perf_counter() - t0
    log(
        f"device CSR pack @ scale: {n_docs} docs / {nnz/1e6:.1f}M "
        f"postings — sort+pack+align+materialize {dt:.2f}s on-device "
        f"({n_docs/dt:,.0f} docs/sec; jit device_pack + "
        f"device_align_planes + device_materialize_vals)"
    )
    del out, r, d, t
    return dt


def main():
    t_run0 = time.perf_counter()  # BENCH_DEADLINE reference (guarded)
    n_docs = int(os.environ.get("BENCH_DOCS", 1_000_000))
    # batch size: not yet swept on the GPU (ROADMAP Speed 5)
    nq = int(os.environ.get("BENCH_NQ", 16384))
    k = int(os.environ.get("BENCH_K", 10))
    iters = int(os.environ.get("BENCH_ITERS", 24))
    kind = os.environ.get("BENCH_KIND", "bm25")
    depth = int(os.environ.get("BENCH_DEPTH", 8))
    n_batches = int(os.environ.get("BENCH_BATCHES", 8))
    scorer = os.environ.get("BENCH_SCORER", "") or None
    tpq = int(os.environ.get("BENCH_TERMS_PER_QUERY", 8))
    vocab = max(50_000, n_docs // 5)
    avg_terms = int(os.environ.get("BENCH_AVG_TERMS", 60))

    enable_persistent_cache()
    import jax

    from document_search_engine_tpu.config import IndexConfig, ScoringConfig

    dev0 = jax.devices()[0]
    device = {
        "platform": dev0.platform,
        "kind": dev0.device_kind,
        "count": len(jax.devices()),
    }
    log(f"device: {device}")
    if dev0.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX runs on {dev0.platform!r}"
        )
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))

    # secondary metric (BASELINE.json:2): index build docs/sec, split
    # into host phases vs the H2D transfer
    build_docs_per_sec = 0.0
    if os.environ.get("BENCH_BUILD", "1") == "1":
        import jax.numpy as jnp

        from document_search_engine_tpu.corpus.synth import synth_corpus
        from document_search_engine_tpu.engine.engine import SearchEngine
        from document_search_engine_tpu.index import builder as _builder
        from document_search_engine_tpu.index.csr import (
            GlobalStats as _GS,
            round_up as _round_up,
        )

        bd = synth_corpus(n_docs=20000, vocab_size=30000, mean_len=120, seed=5)
        # warm the lazy imports + numpy first-call paths on a tiny
        # segment so the timed region measures the steady-state pack
        _w = _builder.analyze_texts_fast(bd[:200], cfg)
        _hw = _builder.build_host_segment(_w, 0)
        _stw = _GS(
            vocab=_hw.term_hash, df=_hw.df.copy(), n_alive=_hw.n_docs,
            total_len_alive=int(_w.dl.sum()),
        )
        _rsw, _xrw = _builder.aligned_geometry(_hw.indptr, cfg.nnz_pad_to)
        _hw.row_start = _rsw
        _vw, _ = _builder.segment_vals(_hw, cfg, _stw)
        _builder._host_planes(
            _hw.post_doc, _vw, _hw.post_tf, _hw.indptr, _rsw, _xrw,
            _hw.n_docs,
        )
        del _w, _hw, _stw, _rsw, _xrw, _vw
        t0 = time.perf_counter()
        _a = _builder.analyze_texts_fast(bd, cfg)
        t_an = time.perf_counter() - t0
        # host CSR pack + value materialization (mirrors
        # builder.pack_device_segment minus the device uploads)
        t0 = time.perf_counter()
        _h = _builder.build_host_segment(_a, 0)
        _st = _GS(
            vocab=_h.term_hash, df=_h.df.copy(), n_alive=_h.n_docs,
            total_len_alive=int(_a.dl.sum()),
        )
        _rs, _xr = _builder.aligned_geometry(_h.indptr, cfg.nnz_pad_to)
        _h.row_start = _rs
        _vals, _inv = _builder.segment_vals(_h, cfg, _st)
        _d2, _v2, _t2 = _builder._host_planes(
            _h.post_doc, _vals, _h.post_tf, _h.indptr, _rs, _xr, _h.n_docs
        )
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        _dev_planes = [jnp.asarray(x) for x in (_d2, _v2, _t2)]
        _ = np.asarray(_dev_planes[0][:1, :1])  # force the transfer
        t_h2d = time.perf_counter() - t0
        del _dev_planes
        build_docs_per_sec = len(bd) / (t_an + t_host)
        log(
            f"index build: {len(bd)} docs — host analyze {t_an:.2f}s + "
            f"host pack+materialize {t_host:.2f}s -> "
            f"{build_docs_per_sec:,.0f} docs/sec host-only; H2D transfer "
            f"{t_h2d:.2f}s ({_d2.nbytes*3/1e6:.0f} MB)"
        )
        del _d2, _v2, _t2, _vals
        if os.environ.get("BENCH_BUILD_DEVICE", "0") == "1":
            eng_b = SearchEngine(cfg)
            eng_b.device_build = True
            t0 = time.perf_counter()
            eng_b.build(bd)
            dt = time.perf_counter() - t0
            log(
                f"device build: {len(bd)} docs in {dt:.2f}s -> "
                f"{len(bd)/dt:,.0f} docs/sec (jit pack+materialize)"
            )

    # ---- the index (production build path, device-generated planes) ----
    eng, df_by_row, tokens_by_row = build_synth_engine(
        n_docs, vocab, avg_terms, cfg, seed=1
    )
    if scorer:
        eng.scorer = scorer
    mb_env = os.environ.get("BENCH_MIN_BLOCKS", "")
    if mb_env:
        eng.plan_min_blocks = int(mb_env)
        log(f"plan_min_blocks override: {eng.plan_min_blocks}")
    split_env = os.environ.get("BENCH_SPLIT", "")
    if split_env:  # doc-range splitting threshold in compacted rows
        eng.split_rows = int(split_env) or None
        log(f"split_rows override: {eng.split_rows}")
    fam_env = os.environ.get("BENCH_FAMILIES", "")
    if fam_env:  # e.g. "1024" (uniform) or "8192:256,1024" (mixed)
        fams = []
        for part in fam_env.split(","):
            if ":" in part:
                thr, blk = part.split(":")
                fams.append((int(thr), int(blk)))
            else:
                fams.append((None, int(part)))
        eng.block_families = tuple(fams)
        log(f"block families override: {eng.block_families}")

    # ---- fresh raw-TEXT query batches ----------------------------------
    batches, avg_post = make_batches(
        df_by_row, tokens_by_row, nq, tpq, n_batches, seed=7
    )
    log(
        f"queries: nq={nq} terms/query={tpq} x {n_batches} fresh TEXT "
        f"batches (avg postings/query {avg_post}) "
        f"scorer={eng.scorer_mode}"
    )

    # warmup: compile the serving program through the PUBLIC API. With
    # the plan layout cache the first batch compiles ONE canonical
    # program and the remaining batches fit it.
    from document_search_engine_tpu.utils.cache import cache_dir as _cd

    cache_dir = _cd()

    def cache_snapshot():
        try:
            files = os.listdir(cache_dir)
            return len(files), sum(
                os.path.getsize(os.path.join(cache_dir, f))
                for f in files
            )
        except OSError:
            return 0, 0

    c_files0, c_bytes0 = cache_snapshot()
    t0 = time.perf_counter()
    # host-only: converge the plan layout over ALL warmup batches first,
    # so the stream below compiles exactly ONE program instead of one
    # per layout generation
    eng.preplan(batches, k=k)
    log(f"preplan (host-only, {n_batches} batches): "
        f"{time.perf_counter()-t0:.1f}s; {eng.plan_cache.stats()}")
    for _ids, _sc in eng.search_stream(iter(batches), k=k, depth=depth):
        pass
    t_warm = time.perf_counter() - t0
    c_files1, c_bytes1 = cache_snapshot()
    log(f"compile+warmup ({n_batches} batches): {t_warm:.1f}s; "
        f"plan cache: {eng.plan_cache.stats()}; persistent compile "
        f"cache: +{c_files1-c_files0} files "
        f"(+{(c_bytes1-c_bytes0)/1e6:.0f} MB; 0 new = all programs "
        f"were disk-cache hits)")

    # ---- PRIMARY: the public-API serving loop over raw text ------------
    passes = int(os.environ.get("BENCH_PASSES", "5"))
    primary = timed_serving_passes(
        "engine serving", eng, batches, nq, iters, k, depth, passes,
    )
    qps = primary["best"]

    # Secondary metrics run after the primary number is in hand; a
    # failure or hang inside one must not lose the JSON line, so each
    # runs guarded: watchdog-bounded (with_alarm), skipped once the run
    # is past BENCH_DEADLINE seconds, and on failure logged, named in
    # "failed_legs" and turned into a non-zero exit after the line.
    deadline = int(os.environ.get("BENCH_DEADLINE", "3300"))
    failed_legs = []

    def guarded(name, fn, default=0.0, timeout=900):
        if deadline and time.perf_counter() - t_run0 > deadline:
            log(f"{name} FAILED: past the {deadline}s run deadline")
            failed_legs.append(name)
            return default
        try:
            return with_alarm(fn, timeout)
        except Exception as e:  # noqa: BLE001 — recorded, exits non-zero
            log(f"{name} FAILED: {type(e).__name__}: {e}")
            failed_legs.append(name)
            return default

    # ---- secondary: same loop minus text analysis ----------------------
    from collections import deque

    def run_wo_analysis():
        pre = [eng.frontend.analyze(b, eng.stats) for b in batches]
        t0 = time.perf_counter()
        inflight = deque()
        for i in range(iters):
            slot_h, coeff = pre[i % n_batches]
            inflight.append(eng._dispatch(slot_h, coeff, k))
            if len(inflight) >= depth:
                _ = eng._collect(inflight.popleft())
        while inflight:
            _ = eng._collect(inflight.popleft())
        dt1 = time.perf_counter() - t0
        log(
            f"serving w/o analysis: {nq*iters/dt1:,.0f} q/s "
            f"({dt1/iters*1e3:.2f} ms/batch; pre-analyzed slot arrays, "
            f"plan+stage+H2D+dispatch+D2H)"
        )
        return pre

    pre = guarded("serving w/o analysis", run_wo_analysis, default=None,
                  timeout=420)
    if pre is None:
        pre = [eng.frontend.analyze(b, eng.stats) for b in batches]

    # ---- secondary: device step only (fixed staged batch, r01 metric) --
    step_qps = guarded(
        "device step only",
        lambda: step_only_qps(
            eng, pre[0], k, iters, depth, nq, "device step only"
        ),
        timeout=420,
    )

    # ---- secondary: the SPMD sharded serving path on the same index ----
    # n_shards=1: this prices the SPMD machinery itself — device plan
    # expansion from global-row tables, shard_map, all_gather,
    # replicated merge.
    def run_sharded():
        deng = sharded_from_engine(eng, cfg)
        deng.split_rows = eng.split_rows  # BENCH_SPLIT applies to both
        t0 = time.perf_counter()
        deng.preplan(batches, k=k)
        sh_first = None
        for _ids, _sc in deng.search_stream(
            iter(batches), k=k, depth=depth
        ):
            if sh_first is None:
                sh_first = (_ids, _sc)
        log(f"sharded compile+warmup ({n_batches} batches): "
            f"{time.perf_counter()-t0:.1f}s; plan cache: "
            f"{deng.plan_cache.stats()}")
        # the SPMD path must rank exactly like the single engine
        ref_ids, ref_sc = eng.search(batches[0], k=k)
        assert np.array_equal(sh_first[0], ref_ids) and np.array_equal(
            sh_first[1], ref_sc
        ), "sharded wrapper diverged from single engine"
        # paired windows: a single pass and a sharded pass back to
        # back; the overhead is the median of per-window ratios
        it2 = max(iters // 2, 8)
        windows = max(passes, 5)
        sgl, shd, per_win = [], [], []
        for w in range(windows):
            s_qps = stream_pass_qps(eng, batches, nq, it2, k, depth)
            d_qps = stream_pass_qps(deng, batches, nq, it2, k, depth)
            ov = (s_qps / d_qps - 1) * 100
            sgl.append(round(s_qps, 1))
            shd.append(round(d_qps, 1))
            per_win.append(round(ov, 1))
            log(f"sharded window {w + 1}/{windows}: single "
                f"{s_qps:,.0f} vs sharded {d_qps:,.0f} q/s "
                f"(overhead {ov:+.1f}%)")
        sh = {
            "best": max(shd),
            "median": round(float(np.median(shd)), 1),
            "passes": shd,
            "paired_single_passes": sgl,
            "overhead_per_window_pct": per_win,
            "overhead_median_pct": round(float(np.median(per_win)), 1),
        }
        log(
            f"sharded serving (1-shard SPMD): best {sh['best']:,.0f} "
            f"/ median {sh['median']:,.0f} q/s over {len(shd)} "
            f"windows; SPMD overhead (median of per-window "
            f"single-vs-sharded ratios): "
            f"{sh['overhead_median_pct']:+.1f}%"
        )
        return sh

    sharded = None
    if os.environ.get("BENCH_SHARDS", "1") == "1":
        sharded = guarded("sharded serving", run_sharded, default=None,
                          timeout=1500)

    # ---- secondary: the real jit CSR pack at full scale ----------------
    pack_secs = 0.0
    if os.environ.get("BENCH_PACK", "1") == "1":
        pack_secs = guarded(
            "device CSR pack",
            lambda: bench_device_pack(n_docs, vocab, df_by_row, cfg, eng),
        )

    levers = lever_config(eng, depth, nq, iters, k, kind)
    levers["plan_cache"] = eng.plan_cache.stats() if eng.plan_cache else ""
    hbm_1m = engine_hbm_bytes(eng)
    log(f"resident device memory @ {n_docs} docs: {hbm_1m/1e9:.2f} GB")

    # ---- the 8M-doc config-3 leg (BASELINE.json:9) ----------------------
    # Runs AFTER the primary index is released: the 8M planes are
    # ~5.6 GB and the generator's transient chunks peak well above that.
    def run_8m():
        nonlocal eng, pre
        del eng, pre  # release the 1M index planes before the 8M gen
        import gc

        gc.collect()
        n8 = int(os.environ.get("BENCH_8M_DOCS", "8000000"))
        eng8, df8, tok8 = build_synth_engine(
            n8, max(50_000, n8 // 5), avg_terms, cfg, seed=2
        )
        if scorer:
            eng8.scorer = scorer
        if split_env:
            eng8.split_rows = int(split_env) or None
        batches8, avg_post8 = make_batches(
            df8, tok8, nq, tpq, 4, seed=23
        )
        log(f"8M leg: {n8} docs, avg postings/query {avg_post8}")
        t0 = time.perf_counter()
        eng8.preplan(batches8, k=k)
        for _o in eng8.search_stream(iter(batches8), k=k, depth=depth):
            pass
        warm8 = time.perf_counter() - t0
        log(f"8M compile+warmup: {warm8:.1f}s; plan cache: "
            f"{eng8.plan_cache.stats()}")
        res = timed_serving_passes(
            "8M engine serving", eng8, batches8, nq,
            max(iters // 2, 8), k, depth,
            int(os.environ.get("BENCH_8M_PASSES", "5")),
        )
        res["n_docs"] = n8
        res["compile_warmup_secs"] = round(warm8, 1)
        res["hbm_bytes"] = engine_hbm_bytes(eng8)
        log(f"8M resident device memory: {res['hbm_bytes']/1e9:.2f} GB")
        pre8 = eng8.frontend.analyze(batches8[0], eng8.stats)
        res["step_qps"] = guarded(
            "8M device step",
            lambda: step_only_qps(
                eng8, pre8, k, max(iters // 2, 8), depth, nq,
                "8M device step only",
            ),
        )
        return res

    m8 = None
    if os.environ.get("BENCH_8M", "1") == "1":
        m8 = guarded("8M leg", run_8m, default=None, timeout=2100)

    # ---- streaming-build scale leg (BASELINE.json:10, config 4) --------
    def run_stream():
        from document_search_engine_tpu.engine.engine import SearchEngine

        import gc

        gc.collect()
        n_s = int(os.environ.get("BENCH_STREAM_DOCS", "1000000"))
        batch_docs = int(os.environ.get("BENCH_STREAM_BATCH", "125000"))
        t0 = time.perf_counter()
        text = synth_text_batches(n_s, 200_000, 40, batch_docs)
        log(f"stream leg: {n_s} docs of synthetic text in "
            f"{len(text)} batches generated in "
            f"{time.perf_counter()-t0:.1f}s (excluded from the build "
            f"timing)")
        es = SearchEngine(cfg)
        t0 = time.perf_counter()
        es.build_streaming(iter(text))
        dt = time.perf_counter() - t0
        nseg = len(es.segments)
        nnz = sum(int(h.indptr[-1]) for h, _ in es.segments)
        log(
            f"streaming build: {n_s} docs -> {nseg} segment(s), "
            f"{nnz/1e6:.1f}M postings in {dt:.1f}s "
            f"({n_s/dt:,.0f} docs/s end-to-end: analyze + jit device "
            f"pack per batch + lifecycle auto-compact at "
            f">{es.auto_compact_segments} segments)"
        )
        # serve-ability of streaming-built indexes is pinned bit-identical
        # to bulk builds by the suite (tests/test_engine_features.py
        # test_build_streaming_equals_bulk)
        assert nnz > 0 and es.n_docs_total == n_s, (
            "streaming build produced an empty index"
        )
        return {
            "n_docs": n_s,
            "batches": len(text),
            "segments": nseg,
            "postings": nnz,
            "secs": round(dt, 1),
            "docs_per_sec": round(n_s / dt, 1),
        }

    stream = None
    if os.environ.get("BENCH_STREAM", "1") == "1":
        stream = guarded("streaming build leg", run_stream, default=None,
                         timeout=1200)

    out = {
        "metric": "queries_per_sec_per_chip",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / 10_000.0, 3),
        "device": device,
        "median": primary["median"],
        "passes": primary["passes"],
        "compile_warmup_secs": round(t_warm, 1),
        "levers": levers,
        "hbm_bytes": hbm_1m,
        "n_docs": n_docs,
        "step_qps": step_qps,
        "sharded": sharded,
        "sharded_qps_1shard": sharded["best"] if sharded else 0.0,
        "device_pack_secs": round(pack_secs, 2),
        "build_docs_per_sec_host": round(build_docs_per_sec, 1),
        "m8": m8,
        "stream": stream,
        "failed_legs": failed_legs,
    }
    print(json.dumps(out), flush=True)
    return 1 if failed_legs else 0


if __name__ == "__main__":
    sys.exit(main())
