"""Frozen CPU oracle: a classic single-process inverted-index search engine.

This is the "CPU reference run" of BASELINE.json:7 (the reference mount is
empty — SURVEY.md §0 — so this oracle, plus spec.py, *is* the reference):
tokenize -> dict inverted index -> TF-IDF/BM25 -> top-k, all on host, with
the fixed-point deterministic scoring of DESIGN.md §2 so the device engine can
be gated bit-identically against it.

Deliberately simple and dictionary-based — structured like the small Python
engine described in SURVEY.md §2a/§3a — NOT shaped like the device engine, so
agreement between the two is meaningful.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from ..analyze.hashing import TermHasher
from ..analyze.tokenizer import Tokenizer
from ..config import IndexConfig
from . import spec

F32 = np.float32


class OracleEngine:
    def __init__(self, config: IndexConfig | None = None):
        self.config = config or IndexConfig()
        self.tokenizer = Tokenizer(self.config.analyzer)
        self.hasher = TermHasher()
        # postings: term_hash -> dict {doc_id: tf}
        self.postings: dict = {}
        self.df: dict = {}  # term_hash -> alive doc count
        self.doc_terms: dict = {}  # doc_id -> (sorted hashes, tfs)
        self.dl: dict = {}  # doc_id -> token count
        self.alive: dict = {}  # doc_id -> bool
        self.next_doc_id = 0
        self._inv_norm: dict = {}  # doc_id -> f32 (tfidf)
        self._stale = True

    # ------------------------------------------------------------- build
    def _analyze(self, text: str):
        toks = self.tokenizer(text)
        counts = Counter(self.hasher.hash_tokens(toks).tolist())
        hashes = np.array(sorted(counts), dtype=np.uint64)
        tfs = np.array([counts[h] for h in hashes.tolist()], dtype=np.int32)
        return hashes, tfs, len(toks)

    def add_docs(self, texts) -> list:
        ids = []
        for text in texts:
            d = self.next_doc_id
            self.next_doc_id += 1
            hashes, tfs, n_tok = self._analyze(text)
            self.doc_terms[d] = (hashes, tfs)
            self.dl[d] = n_tok
            self.alive[d] = True
            for h, tf in zip(hashes.tolist(), tfs.tolist()):
                self.postings.setdefault(h, {})[d] = tf
                self.df[h] = self.df.get(h, 0) + 1
            ids.append(d)
        self._stale = True
        return ids

    def build(self, texts) -> list:
        return self.add_docs(texts)

    def delete_docs(self, doc_ids) -> None:
        for d in doc_ids:
            if not self.alive.get(d, False):
                continue
            self.alive[d] = False
            hashes, _ = self.doc_terms[d]
            for h in hashes.tolist():
                self.df[h] -= 1
        self._stale = True

    # ------------------------------------------------------------- stats
    @property
    def n_alive(self) -> int:
        return sum(1 for a in self.alive.values() if a)

    @property
    def total_len_alive(self) -> int:
        return sum(self.dl[d] for d, a in self.alive.items() if a)

    def _refresh(self) -> None:
        """Recompute idf table and (tfidf) per-doc inverse norms."""
        n = self.n_alive
        kind = self.config.scoring.kind
        max_df = max(self.df.values(), default=0)
        self._idf = spec.idf_table(kind, n, max(max_df, 1))
        if kind == "tfidf":
            for d, (hashes, tfs) in self.doc_terms.items():
                if not self.alive[d]:
                    continue
                dfs = np.array(
                    [self.df[h] for h in hashes.tolist()], dtype=np.int64
                )
                w = spec.doc_weights_tfidf(tfs, self._idf[dfs])
                sumsq = spec.seq_sumsq(w)  # hash-ascending order
                self._inv_norm[d] = spec.inv_norm_from_sumsq(sumsq)
        self._avgdl = spec.avgdl_of(self.total_len_alive, n)
        self._stale = False

    # ------------------------------------------------------------ search
    def _query_slots(self, query: str):
        toks = self.tokenizer(query)
        counts = Counter(self.hasher.hash_tokens(toks).tolist())
        hashes = np.array(sorted(counts), dtype=np.uint64)
        qtf = np.array([counts[h] for h in hashes.tolist()], dtype=np.int32)
        dfs = np.array(
            [self.df.get(h, 0) for h in hashes.tolist()], dtype=np.int64
        )
        idf_s = self._idf[np.minimum(dfs, len(self._idf) - 1)]
        idf_s = np.where(dfs > 0, idf_s, F32(0.0)).astype(F32)
        hashes, qtf, idf_s = spec.select_query_slots(
            hashes, qtf, idf_s, self.config.max_query_terms
        )
        a = spec.query_coeffs(self.config.scoring.kind, qtf, idf_s)
        return hashes, a

    def search(self, queries, k: int = 10):
        """Returns (ids, scores) int64 arrays of shape (nq, k).

        Ranking: fixed-point score desc, doc id asc; empty slots are
        id=-1/score=-1 (DESIGN.md §2).
        """
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if self._stale:
            self._refresh()
        cfg = self.config.scoring
        sb, mqt = cfg.scale_bits, self.config.max_query_terms
        n_docs = self.next_doc_id
        out_ids = np.full((len(queries), k), -1, dtype=np.int64)
        out_scores = np.full((len(queries), k), -1, dtype=np.int64)
        for qi, q in enumerate(queries):
            hashes, a = self._query_slots(q)
            scores = np.zeros(n_docs, dtype=np.int64)
            for h, a_s in zip(hashes.tolist(), a):
                if a_s == F32(0.0):
                    continue
                plist = self.postings.get(h)
                if not plist:
                    continue
                for d, tf in plist.items():
                    # Dead docs keep their postings until the engine is
                    # rebuilt; they must not score (and, for tfidf, have no
                    # refreshed inv_norm — iterating them would KeyError).
                    if not self.alive.get(d, False):
                        continue
                    if cfg.kind == "tfidf":
                        val = spec.val_tfidf(
                            np.int64(tf), self._inv_norm[d]
                        )
                    else:
                        val = spec.val_bm25(
                            np.int64(tf),
                            F32(self.dl[d]),
                            cfg.k1,
                            cfg.b,
                            self._avgdl,
                        )
                    c = (F32(a_s) * F32(val)).astype(F32)
                    scores[d] += int(spec.quantize_contrib(c, sb, mqt))
            for d in range(n_docs):
                if not self.alive.get(d, False):
                    scores[d] = -1
            kk = min(k, n_docs)
            order = np.lexsort((np.arange(n_docs), -scores))[:kk]
            out_ids[qi, :kk] = order
            out_scores[qi, :kk] = scores[order]
            # matching docs only (DESIGN.md §2): score <= 0 is excluded
            dead = out_scores[qi] <= 0
            out_ids[qi][dead] = -1
            out_scores[qi][dead] = -1
        return out_ids, out_scores
