"""CLI (SURVEY.md §1 L6): index build, search, serve, eval.

    python -m document_search_engine_tpu index  <corpus_dir> --out <idx_dir>
    python -m document_search_engine_tpu search <idx_dir> "query text" -k 10
    python -m document_search_engine_tpu serve  <idx_dir>  (queries on stdin)
    python -m document_search_engine_tpu eval   [--kind bm25]
    python -m document_search_engine_tpu bench  (queries/sec/chip, BENCH_* env)

Mirrors the reference's `search(query, k)` + CLI surface (SURVEY.md §2a)
on top of the device engine.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _open_index(index_dir: str):
    """Open a checkpoint with the right engine for its kind (the meta
    records whether it is a sharded index)."""
    import json as _json

    from .engine.engine import SearchEngine

    with open(f"{index_dir}/meta.json") as f:
        meta = _json.load(f)
    if meta.get("sharded"):
        from .parallel.dist import DistributedSearchEngine

        return DistributedSearchEngine.load(index_dir)
    return SearchEngine.load(index_dir)


def cmd_index(args):
    from .config import IndexConfig, ScoringConfig
    from .corpus.loader import load_dir
    from .engine.engine import SearchEngine

    docs = load_dir(args.corpus_dir)
    if not docs:
        print(f"no documents found under {args.corpus_dir}", file=sys.stderr)
        return 1
    names = [n for n, _ in docs]
    cfg = IndexConfig(scoring=ScoringConfig(kind=args.kind))
    if args.shards:
        from .parallel.dist import DistributedSearchEngine
        from .parallel.mesh import make_mesh

        eng = DistributedSearchEngine(cfg, mesh=make_mesh(args.shards))
    else:
        eng = SearchEngine(cfg)
    t0 = time.perf_counter()
    eng.build([t for _, t in docs])
    dt = time.perf_counter() - t0
    eng.save(args.out)
    with open(f"{args.out}/docnames.json", "w") as f:
        json.dump(names, f)
    stats = eng.index.stats if args.shards else eng.stats
    print(
        json.dumps(
            {
                "docs": len(docs),
                "terms": int(len(stats.vocab)),
                "build_secs": round(dt, 2),
                "docs_per_sec": round(len(docs) / dt, 1),
                "out": args.out,
            }
        )
    )
    return 0


def cmd_search(args):
    eng = _open_index(args.index_dir)
    try:
        with open(f"{args.index_dir}/docnames.json") as f:
            names = json.load(f)
    except OSError:
        names = None
    t0 = time.perf_counter()
    if getattr(args, "rerank", False):
        ids, rerank_scores, scores = eng.search_rerank(
            [args.query], k=args.k
        )
    else:
        ids, scores = eng.search([args.query], k=args.k)
        rerank_scores = None
    dt = time.perf_counter() - t0
    sb = eng.config.scoring.scale_bits
    for rank, (g, s) in enumerate(zip(ids[0], scores[0]), 1):
        if g < 0:
            break
        name = names[g] if names and g < len(names) else str(g)
        extra = (
            f"  rerank={rerank_scores[0][rank - 1] / (1 << 20):.4f}"
            if rerank_scores is not None
            else ""
        )
        print(
            f"{rank:3d}. {name}  score={s / (1 << sb):.6f}{extra}"
            f"  (doc {g})"
        )
    print(f"[{dt*1e3:.1f} ms]", file=sys.stderr)
    return 0


def cmd_serve(args):
    """Pipelined stdin serving loop: one query per line, batched into
    `--batch`-sized groups, dispatched through the depth-pipelined
    search_stream; one JSON result line per query on stdout."""
    eng = _open_index(args.index_dir)

    def batches():
        buf = []
        for line in sys.stdin:
            q = line.strip()
            if not q:
                continue
            buf.append(q)
            if len(buf) >= args.batch:
                yield buf
                buf = []
        if buf:
            yield buf

    sb = eng.config.scoring.scale_bits
    n = 0
    t0 = time.perf_counter()
    for ids, scores in eng.search_stream(batches(), k=args.k):
        for row_ids, row_scores in zip(ids, scores):
            hits = [
                {"doc": int(g), "score": float(s) / (1 << sb)}
                for g, s in zip(row_ids, row_scores)
                if g >= 0
            ]
            print(json.dumps({"hits": hits}), flush=True)
            n += 1
    dt = time.perf_counter() - t0
    if n:
        print(
            f"[{n} queries in {dt:.3f}s -> {n/dt:,.0f} q/s]",
            file=sys.stderr,
        )
    return 0


def cmd_eval(args):
    from .config import IndexConfig, ScoringConfig
    from .engine.engine import SearchEngine
    from .eval.harness import (
        parity_report,
        topic_corpus,
        topic_queries,
    )
    from .oracle import OracleEngine

    docs, doc_topics, topics = topic_corpus(seed=args.seed)
    queries, q_topics = topic_queries(topics)
    cfg = IndexConfig(scoring=ScoringConfig(kind=args.kind))
    eng = SearchEngine(cfg)
    eng.build(docs)
    ora = OracleEngine(cfg)
    ora.build(docs)
    rep = parity_report(eng, ora, queries, q_topics, doc_topics)
    print(json.dumps(rep, indent=2))
    return 0


def cmd_bench(args):
    import importlib.util
    import os

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench.py",
    )
    spec_ = importlib.util.spec_from_file_location("dse_bench", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.main()


def main(argv=None):
    p = argparse.ArgumentParser(prog="document_search_engine_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build an index from a directory")
    pi.add_argument("corpus_dir")
    pi.add_argument("--out", required=True)
    pi.add_argument("--kind", default="bm25", choices=["tfidf", "bm25"])
    pi.add_argument(
        "--shards",
        type=int,
        default=0,
        help="build a document-sharded index over an N-device mesh "
        "(0 = single-process; search/serve auto-detect the kind)",
    )
    pi.set_defaults(fn=cmd_index)

    ps = sub.add_parser("search", help="query a saved index")
    ps.add_argument("index_dir")
    ps.add_argument("query")
    ps.add_argument("-k", type=int, default=10)
    ps.add_argument(
        "--rerank",
        action="store_true",
        help="hybrid dense rerank of the lexical candidates",
    )
    ps.set_defaults(fn=cmd_search)

    pv = sub.add_parser(
        "serve", help="pipelined batch serving: queries on stdin"
    )
    pv.add_argument("index_dir")
    pv.add_argument("-k", type=int, default=10)
    pv.add_argument("--batch", type=int, default=256)
    pv.set_defaults(fn=cmd_serve)

    pe = sub.add_parser("eval", help="topic-corpus quality + parity report")
    pe.add_argument("--kind", default="bm25", choices=["tfidf", "bm25"])
    pe.add_argument("--seed", type=int, default=0)
    pe.set_defaults(fn=cmd_eval)

    pb = sub.add_parser("bench", help="run the throughput benchmark")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from .utils.cache import enable_persistent_cache

    enable_persistent_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
