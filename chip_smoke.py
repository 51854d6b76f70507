#!/usr/bin/env python3
"""Chip smoke: the search engine's main path on an NVIDIA GPU.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs: the sharded engine only

One process opens the card(s) once and runs every phase; nothing is
caught, so any failed check ends the run with a non-zero exit. Phases:

1. environment — the card's name and power limit (nvidia-smi), JAX's
   version and devices (the platform must be "gpu"), and whether the C
   analyzer (built here from native/analyzer.cpp) or its Python fallback
   runs;
2. hardware checks at 20-Newsgroups scale (~18k docs, BASELINE.json:8):
   lax.top_k tie order, builder.exact_div against numpy, the CUDA kernel
   against the XLA twin on random plans, and engine-vs-oracle parity
   (VectorOracleEngine, zero tolerance: ids and integer scores) for both
   scorings, both scorers, k > 128, empty and unknown queries, doc-range
   splitting, add_docs / delete_docs / compact, save / load, hybrid
   rerank and the 1-device SPMD engine;
3. the main path at the shape of bench.py's default cell: 1,000,000
   docs (Zipf terms, ~60 postings per doc), bm25, batches of 16,384
   queries of 8 terms, k = 10 — SearchEngine.build from text (device
   build), preplan + warmup, 8 batches through search_stream and a few
   search calls, 1,024 served queries checked bit-for-bit against the
   same engine API built on the CPU with the XLA twin, and the serving
   step's memory analysis, compile count, build seconds and q/s.

With --four only the document-sharded engine runs: DistributedSearchEngine
over a 4-device mesh on the same 1M-doc corpus (SPMD build,
search_stream batches, one add_docs and delete_docs, sharded rerank),
every result compared with a single-card SearchEngine in this process.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build")


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------- corpora
def token_texts(ids: np.ndarray, ptr: np.ndarray) -> list:
    """Texts of token-id runs ids[ptr[i]:ptr[i+1]]: token t is the word
    "w%06d" — fixed 8-byte cells (word + space), built in bulk."""
    cells = np.empty((len(ids), 8), np.uint8)
    cells[:, 0] = ord("w")
    v = ids.astype(np.int64)
    for c in range(6, 0, -1):
        cells[:, c] = 48 + v % 10
        v //= 10
    cells[:, 7] = 32
    buf = cells.tobytes()
    return [
        buf[8 * a : 8 * b - 1].decode("ascii")
        for a, b in zip(ptr[:-1].tolist(), ptr[1:].tolist())
    ]


def zipf_cdf(vocab: int) -> np.ndarray:
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1, dtype=np.float64))
    return cdf / cdf[-1]


def zipf_corpus(n_docs: int, vocab: int, mean_len: int, seed: int):
    """n_docs texts of Zipf-distributed terms from ONE vectorized draw
    split into documents (corpus/synth.py draws per document)."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(5, rng.poisson(mean_len, n_docs))
    ptr = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lens, out=ptr[1:])
    ids = np.searchsorted(zipf_cdf(vocab), rng.random(int(ptr[-1])))
    return token_texts(np.minimum(ids, vocab - 1), ptr)


def zipf_queries(n_docs, vocab, mean_len, nq, terms, seed):
    """Query texts of `terms` words drawn uniformly from the vocabulary
    ranks whose expected df lies in [64, 32768] (bench.py's
    make_batches range)."""
    rng = np.random.default_rng(seed)
    p = np.diff(np.concatenate([[0.0], zipf_cdf(vocab)]))
    df = n_docs * (1.0 - (1.0 - p) ** mean_len)
    eligible = np.nonzero((df >= 64) & (df <= 32768))[0]
    ids = rng.choice(eligible, size=nq * terms)
    return token_texts(ids, np.arange(nq + 1, dtype=np.int64) * terms)


def sample_queries(docs, nq, terms, seed):
    """Queries of words picked from random documents, plus the empty
    and an unknown query."""
    rng = np.random.default_rng(seed)
    out = []
    for d in rng.integers(0, len(docs), nq):
        toks = docs[int(d)].split()
        pick = rng.choice(len(toks), size=min(terms, len(toks)), replace=False)
        out.append(" ".join(toks[i] for i in pick))
    return out + ["", "zzzunknownzzz"]


# ---------------------------------------------------------------- checks
def same(tag, got, ref) -> None:
    """Zero-tolerance comparison of (ids, scores[, ...]) tuples."""
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        if g.shape != r.shape or not np.array_equal(g, r):
            rows = np.nonzero((g != r).reshape(len(g), -1).any(1))[0]
            raise AssertionError(
                f"{tag}: {len(rows)} of {len(g)} rows differ, first "
                f"{rows[:5].tolist()}"
            )
    log(f"  {tag}: {len(np.asarray(ref[0]))} queries bit-identical")


def check_topk_ties(rows: int = 64, width: int = 4096, k: int = 50):
    """lax.top_k returns tied values by lowest index on the device (the
    twin's rank step depends on it)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.integers(0, 5, size=(rows, width)).astype(np.int32)
    _, idx = jax.lax.top_k(jnp.asarray(x), k)
    idx = np.asarray(idx)
    for r in range(rows):
        expect = np.lexsort((np.arange(width), -x[r]))[:k]
        np.testing.assert_array_equal(idx[r], expect, f"row {r}")
    log(f"  top_k ties by lowest index: {rows} rows x {width}, k={k}")


def check_exact_div(n: int = 1 << 22):
    """builder.exact_div is bit-equal to numpy's f32 divide on the
    device, on structured bm25-like operands."""
    import jax
    import jax.numpy as jnp

    from document_search_engine_tpu.index.builder import exact_div

    rng = np.random.default_rng(11)
    tf = rng.integers(1, 2000, n).astype(np.float32)
    kd = (rng.random(n).astype(np.float32) * 5 + 0.1).astype(np.float32)
    num, den = tf * np.float32(2.5), tf + kd
    got = np.asarray(jax.jit(exact_div)(jnp.asarray(num), jnp.asarray(den)))
    np.testing.assert_array_equal(got, num / den)
    plain = np.asarray(jax.jit(jnp.divide)(jnp.asarray(num), jnp.asarray(den)))
    log(f"  exact_div == numpy on {n:,} samples (plain device divide "
        f"differs on {int((plain != num / den).sum())})")


def check_kernel_vs_twin():
    """The CUDA kernel equals the XLA twin on random plan tables: every
    instantiated buffer size, k up to 128, duplicate slot rows (equal
    docs with different contributions), doc limits, empty queries."""
    import jax.numpy as jnp

    from document_search_engine_tpu.index.builder import (
        _host_planes,
        aligned_geometry,
    )
    from document_search_engine_tpu.ops.fused_cuda import (
        fused_search_cuda,
        kernel_takes,
    )
    from document_search_engine_tpu.ops.packed import search_packed_tables
    from document_search_engine_tpu.ops.plan import compact_rows, plan_tables

    scale = float(np.float32(2.0**16))
    clip = float(np.float32(65075262.0))
    cases = [  # seed, terms, docs, max row, nq, s, block, k, dup, split
        (1, 30, 3000, 600, 16, 4, 512, 10, False, False),
        (2, 30, 5000, 2500, 16, 4, 1024, 10, True, False),
        (3, 40, 20000, 3000, 32, 8, 4096, 128, False, False),
        (4, 40, 20000, 1500, 32, 8, 4096, 17, False, True),
        (5, 60, 200000, 1800, 64, 8, 4096, 10, False, False),
        (6, 60, 1000000, 1500, 64, 8, 512, 64, True, True),
        (7, 20, 900, 100, 8, 2, 256, 5, False, False),
    ]
    for seed, nt, nd, ml, nq, s, block, k, dup, split in cases:
        rng = np.random.default_rng(seed)
        parts = [
            np.unique(rng.integers(0, nd, int(n))).astype(np.int32)
            for n in rng.integers(1, ml, nt)
        ]
        indptr = np.zeros(nt + 1, np.int32)
        np.cumsum([len(x) for x in parts], out=indptr[1:])
        doc = np.concatenate(parts)
        val = (rng.random(len(doc), dtype=np.float32) * 0.9 + 0.05).astype(
            np.float32
        )
        row_start, x_rows = aligned_geometry(indptr, 1)
        d2, v2, _ = _host_planes(
            doc, val, np.ones(len(doc), np.int32), indptr, row_start,
            x_rows, nd,
        )
        rows = rng.integers(0, nt, (nq, s)).astype(np.int32)
        if dup:
            rows[:, 1] = rows[:, 0]
        coeff = (rng.random((nq, s)) * 1.5).astype(np.float32)
        coeff[rng.random((nq, s)) < 0.2] = 0.0
        coeff[0] = 0.0  # an empty query
        lens = (indptr[rows + 1] - indptr[rows]) * (coeff > 0)
        nb = 1 << int(np.ceil(np.log2(max(1, (-(-lens // block)).sum(1).max()))))
        sr, rm, ab, dst = plan_tables(
            row_start.astype(np.int32), indptr, rows, coeff, nb, block
        )
        need = int(compact_rows(rm[:, 0, :], block).sum(1).max())
        r_c = 1 << int(np.ceil(np.log2(max(need, 1))))
        assert kernel_takes(r_c, k), (seed, r_c)
        dlim = None
        if split:
            lo = rng.integers(0, nd // 2, nq)
            dlim = jnp.asarray(
                np.stack([lo, lo + nd // 3], 1).astype(np.int32)
                .reshape(nq, 1, 2)
            )
        planes = (jnp.asarray(d2), jnp.asarray(v2))
        tabs = [jnp.asarray(x) for x in (sr, rm, ab)]
        tv, tg = search_packed_tables(
            *planes, *tabs, jnp.float32(scale), jnp.float32(clip),
            jnp.int32(0), n_blocks=nb, block=block, s=s, k=k, n_docs=nd,
            dlim=dlim,
        )
        kv, kd = fused_search_cuda(
            *planes, *tabs, jnp.asarray(dst), block=block, k=k, n_docs=nd,
            r_c=r_c, scale=scale, clip=clip, dlim=dlim,
        )
        kv = np.asarray(kv)
        same(
            f"kernel == twin (seed {seed}, r_c {r_c}, block {block}, k {k}"
            f"{', dup slots' if dup else ''}{', doc limits' if split else ''})",
            (kv, np.where(kv > 0, np.asarray(kd), -1)),
            (tv, tg),
        )


def check_oracle_parity(n_docs: int, vocab: int, mean_len: int, nq: int,
                        seed: int = 5):
    """SearchEngine (both scorers) vs VectorOracleEngine, zero
    tolerance, through the engine's whole lifecycle."""
    from document_search_engine_tpu.config import IndexConfig, ScoringConfig
    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.oracle.vector import VectorOracleEngine

    docs = zipf_corpus(n_docs, vocab, mean_len, seed)
    queries = sample_queries(docs, nq, 4, seed + 1)
    n0 = n_docs * 9 // 10
    dead = np.random.default_rng(seed + 2).choice(n_docs, n_docs // 60,
                                                  replace=False)
    ckpt = os.path.join(BUILD, "smoke_checkpoint")
    for kind in ("tfidf", "bm25"):
        cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
        ora = VectorOracleEngine(cfg)
        ora.build(docs[:n0])
        ref = {k: ora.search(queries, k=k) for k in (10, 200)}
        engines = {}
        for mode in ("fused", "xla"):
            eng = SearchEngine(cfg)
            eng.scorer = mode
            eng.build(docs[:n0])
            for k in (10, 200):
                same(f"{kind} {mode} k={k}", eng.search(queries, k=k),
                     ref[k])
            engines[mode] = eng
        eng = engines["fused"]
        eng.split_rows = 4
        same(f"{kind} fused split_rows=4", eng.search(queries, k=10),
             ref[10])
        eng.split_rows = None
        eng.auto_compact_segments = None
        ora.add_docs(docs[n0:])
        eng.add_docs(docs[n0:])
        same(f"{kind} fused after add_docs ({len(eng.segments)} segments)",
             eng.search(queries, k=10), ora.search(queries, k=10))
        ora.delete_docs(dead.tolist())
        eng.delete_docs(dead.tolist())
        after = ora.search(queries, k=10)
        same(f"{kind} fused after delete_docs", eng.search(queries, k=10),
             after)
        eng.compact()
        same(f"{kind} fused after compact", eng.search(queries, k=10),
             after)
        eng.save(ckpt)
        loaded = SearchEngine.load(ckpt)
        assert loaded.scorer_mode == "fused"
        same(f"{kind} loaded checkpoint", loaded.search(queries, k=10),
             after)
        if kind == "bm25":
            check_rerank_and_spmd(cfg, docs, queries)


def check_rerank_and_spmd(cfg, docs, queries):
    """Hybrid rerank on the GPU == the same API on the CPU; the 1-device
    SPMD engine == SearchEngine, search and rerank."""
    import jax

    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine,
    )
    from document_search_engine_tpu.parallel.mesh import make_mesh

    single = SearchEngine(cfg)
    single.build(docs)
    got = single.search_rerank(queries, k=10, candidates=64)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = SearchEngine(cfg)
        cpu.scorer = "xla"
        cpu.build(docs)
        want = cpu.search_rerank(queries, k=10, candidates=64)
    same("bm25 search_rerank GPU == CPU", got, want)
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(1))
    dist.build(docs)
    assert dist.scorer_mode == "fused"
    same("bm25 1-device SPMD == single", dist.search(queries, k=10),
         single.search(queries, k=10))
    same("bm25 1-device SPMD rerank == single",
         dist.search_rerank(queries, k=10, candidates=64), got)


# --------------------------------------------------------------- phases
def phase_environment(n_devices: int) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    import jax

    devs = jax.devices()
    log(f"card: {card}")
    log(f"jax {jax.__version__}: {devs}")
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX runs on {devs[0].platform!r} (its CUDA plugin "
            "did not start)"
        )
    if len(devs) < n_devices:
        raise SystemExit(f"need {n_devices} GPUs, JAX has {len(devs)}")
    os.makedirs(BUILD, exist_ok=True)
    make = subprocess.run(
        ["make", "-s", "-C", os.path.join(ROOT, "native"),
         f"OUT={os.path.join(BUILD, 'libdse_native.so')}"],
        capture_output=True, text=True,
    )
    if make.returncode == 0:
        os.environ["DSE_NATIVE_LIB"] = os.path.join(BUILD,
                                                    "libdse_native.so")
    from document_search_engine_tpu.analyze import native
    from document_search_engine_tpu.ops import fused_cuda
    from document_search_engine_tpu.utils.cache import (
        cache_dir,
        enable_persistent_cache,
    )

    lib = native._lib()
    log(f"C analyzer: {'native ' + lib._name if lib else 'Python fallback'}"
        f" (make: rc {make.returncode} {make.stderr.strip()[-200:]})")
    enable_persistent_cache()
    log(f"compile cache: {cache_dir()}")
    t0 = time.perf_counter()
    lib = fused_cuda.build()
    log(f"CUDA kernel library: {lib} ({time.perf_counter() - t0:.1f} s)")
    return {
        "card": card,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": n_devices,
        },
    }


def phase_checks() -> None:
    log("phase 2: hardware checks and oracle parity at ~18k docs")
    check_topk_ties()
    check_exact_div()
    check_kernel_vs_twin()
    check_oracle_parity(n_docs=18000, vocab=60000, mean_len=150, nq=512)


def serving_memory(eng, queries, k):
    """memory_analysis() of the compiled serving step for one batch."""
    from document_search_engine_tpu.engine import engine as engine_mod

    real = engine_mod._batch_step
    seen = {}

    def capture(*a, **kw):
        seen["a"], seen["kw"] = a, kw
        return real(*a, **kw)

    engine_mod._batch_step = capture
    try:
        eng.search(queries, k=k)
    finally:
        engine_mod._batch_step = real
    return real.lower(*seen["a"], **seen["kw"]).compile().memory_analysis()


MAIN = dict(n_docs=1_000_000, mean_len=75, nq=16384, terms=8, k=10,
            batches=8, check=1024)


def main_corpus():
    n = MAIN["n_docs"]
    vocab = max(50_000, n // 5)
    t0 = time.perf_counter()
    docs = zipf_corpus(n, vocab, MAIN["mean_len"], seed=1)
    queries = zipf_queries(n, vocab, MAIN["mean_len"],
                           MAIN["nq"] * MAIN["batches"], MAIN["terms"],
                           seed=7)
    nq = MAIN["nq"]
    batches = [queries[i * nq : (i + 1) * nq] for i in range(MAIN["batches"])]
    log(f"  corpus: {n:,} docs, vocab {vocab:,}, {len(batches)} batches "
        f"of {nq} queries ({time.perf_counter() - t0:.1f} s to generate)")
    return docs, batches


def check_subset(batches):
    """MAIN['check'] queries spread over the served batches: (batch,
    row) positions and texts."""
    per = MAIN["check"] // len(batches)
    pos = [(b, r) for b in range(len(batches)) for r in range(per)]
    return pos, [batches[b][r] for b, r in pos]


def phase_main(card: str) -> None:
    import jax

    from document_search_engine_tpu.config import IndexConfig, ScoringConfig
    from document_search_engine_tpu.engine.engine import SearchEngine

    log("phase 3: 1M-doc main path")
    compiles = {"n": 0}

    def on_event(event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles["n"] += 1

    jax.monitoring.register_event_duration_secs_listener(on_event)
    docs, batches = main_corpus()
    k = MAIN["k"]
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    eng = SearchEngine(cfg)
    assert eng.device_build and eng.scorer_mode == "fused"
    t0 = time.perf_counter()
    eng.build(docs)
    build_s = time.perf_counter() - t0
    host, dev = eng.segments[0]
    nnz = int(host.indptr[-1])
    log(f"  build: {build_s:.1f} s ({nnz / host.n_docs:.1f} postings/doc, "
        f"{nnz:,} postings, {len(eng.stats.vocab):,} terms)")
    t0 = time.perf_counter()
    eng.preplan(batches, k=k)
    c0 = compiles["n"]
    for _ in eng.search_stream(iter(batches), k=k, depth=2):
        pass
    warm_s = time.perf_counter() - t0
    warm_compiles = compiles["n"] - c0
    c1 = compiles["n"]
    served = []
    t0 = time.perf_counter()
    for out in eng.search_stream(iter(batches), k=k, depth=2):
        served.append(out)
    serve_s = time.perf_counter() - t0
    qps = MAIN["nq"] * len(batches) / serve_s
    window_compiles = compiles["n"] - c1
    for b in batches[:3]:
        same("search == search_stream",
             eng.search(b[:2048], k=k),
             tuple(x[:2048] for x in served[batches.index(b)]))
    mem = serving_memory(eng, batches[0], k)
    log(f"  serving step memory_analysis: {mem}")
    pos, texts = check_subset(batches)
    got_ids = np.stack([served[b][0][r] for b, r in pos])
    got_sc = np.stack([served[b][1][r] for b, r in pos])
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        ref = SearchEngine(cfg)
        ref.scorer = "xla"
        ref.build(docs)
        want = ref.search(texts, k=k)
    log(f"  CPU reference (same API, XLA twin on the host backend): "
        f"{time.perf_counter() - t0:.1f} s")
    same(f"served queries vs CPU reference ({len(batches)} batches)",
         (got_ids, got_sc), want)
    assert (got_sc[:, 0] > 0).mean() > 0.9, "most queries should match"
    log(f"  [{card}] build {build_s:.1f} s; warmup {warm_s:.1f} s "
        f"({warm_compiles} compiles); served {qps:,.0f} q/s over "
        f"{len(batches)} batches of {MAIN['nq']} ({window_compiles} "
        f"compiles in the window)")


def phase_four(card: str) -> None:
    from document_search_engine_tpu.config import IndexConfig, ScoringConfig
    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine,
    )
    from document_search_engine_tpu.parallel.mesh import make_mesh

    log("four GPUs: document-sharded engine vs single-card engine, 1M docs")
    docs, batches = main_corpus()
    batches = batches[:4]
    k = MAIN["k"]
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    t0 = time.perf_counter()
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dist.build(docs)
    log(f"  SPMD build: {time.perf_counter() - t0:.1f} s")
    assert dist.scorer_mode == "fused"
    for name in ("post_doc", "post_val", "alive", "indptr_d"):
        arr = getattr(dist.index, name)
        devs = {s.device for s in arr.addressable_shards}
        assert len(devs) == 4, f"{name} on {devs}"
        log(f"  {name}: shards on devices "
            f"{sorted(d.id for d in devs)}, shard shape "
            f"{arr.addressable_shards[0].data.shape}")
    t0 = time.perf_counter()
    single = SearchEngine(cfg)  # on the default device, GPU 0
    single.build(docs)
    log(f"  single-card build: {time.perf_counter() - t0:.1f} s")
    dist.preplan(batches, k=k)
    single.preplan(batches, k=k)
    for _ in dist.search_stream(iter(batches), k=k, depth=2):
        pass
    t0 = time.perf_counter()
    got = list(dist.search_stream(iter(batches), k=k, depth=2))
    dt = time.perf_counter() - t0
    want = list(single.search_stream(iter(batches), k=k, depth=2))
    for i, (g, w) in enumerate(zip(got, want)):
        same(f"sharded == single, batch {i}", g, w)
    log(f"  [{card}] sharded search_stream: "
        f"{MAIN['nq'] * len(batches) / dt:,.0f} q/s over {len(batches)} "
        f"batches of {MAIN['nq']} (4 GPUs)")
    rng = np.random.default_rng(3)
    extra = zipf_corpus(5000, max(50_000, MAIN["n_docs"] // 5),
                        MAIN["mean_len"], seed=9)
    dist.add_docs(extra)
    single.add_docs(extra)
    dead = rng.choice(dist.n_docs_total, 2000, replace=False).tolist()
    dist.delete_docs(dead)
    single.delete_docs(dead)
    probe = batches[0][:4096]
    same("sharded == single after add_docs + delete_docs",
         dist.search(probe, k=k), single.search(probe, k=k))
    same("sharded search_rerank == single",
         dist.search_rerank(probe[:1024], k=k, candidates=64),
         single.search_rerank(probe[:1024], k=k, candidates=64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded path")
    args = ap.parse_args(argv)
    n = 4 if args.four else 1
    t0 = time.perf_counter()
    env = phase_environment(n)
    if args.four:
        phase_four(env["card"])
    else:
        phase_checks()
        phase_main(env["card"])
    log(f"done in {time.perf_counter() - t0:.1f} s")
    log(env["card"])
    print(json.dumps({"ok": True, "device": env["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
