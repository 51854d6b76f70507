"""Document-sharded index + SPMD search (BASELINE.json:5).

Each shard owns a contiguous global doc-id range and holds its own CSR
postings planes, padded to fleet-uniform shapes. Rows are indexed by the
CORPUS-GLOBAL sorted vocabulary: a term absent from a shard simply has
row length 0 there (its aligned planes are unchanged by this choice —
absent rows occupy zero aligned records). That one invariant buys the
whole serving path:

- ONE host vocab lookup per batch (not one per shard),
- ONE replicated (bq, S) rows/coeff table per bucket shipped to the
  mesh (not n_shards staged DMA-table triples),
- per-shard plan tables expanded ON DEVICE inside the SPMD program
  from the shard's resident global-row indptr/row_start tables.

One search step under `shard_map`: device plan expansion -> local
fixed-point scoring (the CUDA fused kernel on GPU meshes, the XLA twin
elsewhere) -> local ranked top-k -> `all_gather` of (score, gid)
candidates over the `docs` axis -> replicated k-way merge, "so
multi-chip corpora return one
global ranked list". Scores are integer fixed-point (DESIGN.md §2), so
rankings are bit-identical for every shard count — tested 1 vs N.

The sharded build is ONE SPMD job (SURVEY.md §3b): host analysis stages
stacked (global row, local doc, tf) triples with one sharded device_put,
and a single jit shard_map program sorts, packs the aligned planes,
materializes values, and computes the corpus-global df by `jax.lax.psum`
over the docs axis — O(1) dispatches per corpus, not O(shards).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import IndexConfig
from ..engine.query import QueryFrontend
from ..index import builder
from ..index.csr import GlobalStats, lookup_sorted, merge_stats, round_up
from ..ops.schedule import (
    DEFAULT_FAMILIES,
    FUSED_FAMILIES,
    plan_batch_sharded,
)
from ..ops.topk import merge_candidates
from ..oracle import spec
from .mesh import DOCS_AXIS, make_mesh

F32 = np.float32


@dataclass
class ShardedIndex:
    """Stacked per-shard aligned posting planes; axis 0 is the `docs`
    mesh axis (see index/csr.py SegmentDevice for the plane layout)."""

    post_doc: jnp.ndarray  # (n_shards, X, 128) i32
    post_val: jnp.ndarray  # (n_shards, X, 128) i32 bitcast f32
    # raw tfs in the same geometry: lets incremental updates
    # re-materialize vals ON DEVICE (O(docs) H2D, not O(nnz))
    post_tf: jnp.ndarray  # (n_shards, X, 128) i32
    alive: jnp.ndarray  # (n_shards, D_pad) bool
    doc_base: jnp.ndarray  # (n_shards, 1) i32
    # per-shard CSR lookup tables in the GLOBAL row space (module
    # docstring): indptr_g[i][r+1]-indptr_g[i][r] is shard i's postings
    # count for global term row r (0 when absent), row_start_d[i][r] its
    # aligned flat start in shard i's planes. Host copy for bucket
    # planning, sharded device copy for on-device plan expansion.
    indptr_g: np.ndarray  # host (n_shards, t_pad+1) i32
    indptr_d: jnp.ndarray  # (n_shards, t_pad+1) i32, sharded
    row_start_d: jnp.ndarray  # (n_shards, t_pad) i32, sharded
    hosts: list  # per-shard SegmentHost (numpy metadata)
    stats: GlobalStats
    n_shards: int
    d_pad: int
    t_pad: int  # padded GLOBAL vocab size (sizes incremental updates)
    # device-psum'd global df from the SPMD build (None for host
    # assembly); tests pin it equal to the host stats merge
    df_psum: np.ndarray | None = field(default=None, repr=False)


def _ensure_host_csr(h) -> None:
    """Device-built segments keep no host postings copies; re-derive
    them from the analyzed docs when a host-side reassembly needs them
    (same lexsort as the original pack — bit-identical)."""
    if h.post_doc is not None:
        return
    a = builder.AnalyzedDocs(
        hashes=h.doc_hashes, tfs=h.doc_tfs, doc_ptr=h.doc_ptr, dl=h.dl
    )
    nh = builder.build_host_segment(a, h.doc_base)
    h.indptr = nh.indptr
    h.post_doc = nh.post_doc
    h.post_tf = nh.post_tf


def _global_t_pad(stats: GlobalStats) -> int:
    """Padded global vocab size: ~25% growth headroom so incremental
    adds that introduce new terms fit without a shape change."""
    tg = len(stats.vocab)
    return round_up(tg + max(tg // 4, 64), 64)


def _global_tables_one(h, stats: GlobalStats, t_pad: int):
    """One shard's (indptr_g, row_start_g) in the global row space."""
    lens_g = np.zeros(t_pad, np.int64)
    rs = np.zeros(t_pad, np.int64)
    if h.n_terms:
        gmap = np.searchsorted(stats.vocab, h.term_hash)
        lens_g[gmap] = np.diff(h.indptr)
        rs[gmap] = h.row_start
    ip = np.zeros(t_pad + 1, np.int64)
    np.cumsum(lens_g, out=ip[1:])
    return ip.astype(np.int32), rs.astype(np.int32)


def _global_tables(hosts, stats: GlobalStats, t_pad: int):
    n_shards = len(hosts)
    ipg = np.zeros((n_shards, t_pad + 1), np.int32)
    rsg = np.zeros((n_shards, t_pad), np.int32)
    for i, h in enumerate(hosts):
        ipg[i], rsg[i] = _global_tables_one(h, stats, t_pad)
    return ipg, rsg


def assemble_sharded(hosts, config: IndexConfig, mesh: Mesh) -> ShardedIndex:
    """Pack per-shard host metadata into fleet-uniform padded device
    arrays with corpus-global stats; used by host build, checkpoint
    load/reshard and incremental fallbacks (the device arrays are fully
    derivable from SegmentHost)."""
    for h in hosts:
        _ensure_host_csr(h)
    n_shards = len(hosts)
    stats = merge_stats(hosts)
    t_pad = _global_t_pad(stats)
    # ~12.5% postings growth headroom so small incremental adds fit the
    # padded shapes and take the O(delta) last-shard update instead of a
    # full reassembly (_update_last_shard)
    d_pad = round_up(max(h.n_docs for h in hosts) + 1, config.docs_pad_to)
    geoms = [
        builder.aligned_geometry(h.indptr, config.nnz_pad_to)
        for h in hosts
    ]
    x_rows = max(x for _, x in geoms)
    x_rows = x_rows + max(x_rows // 8, 8)

    pd = np.zeros((n_shards, x_rows, 128), np.int32)
    pv = np.zeros((n_shards, x_rows, 128), np.int32)
    pt = np.zeros((n_shards, x_rows, 128), np.int32)
    al = np.zeros((n_shards, d_pad), bool)
    for i, (h, (row_start, xr)) in enumerate(zip(hosts, geoms)):
        h.row_start = row_start
        vals, _inv_norm = builder.segment_vals(h, config, stats)
        d2, v2, t2 = builder._host_planes(
            h.post_doc, vals, h.post_tf, h.indptr, row_start, x_rows,
            h.n_docs,
        )
        pd[i] = d2
        pv[i] = v2
        pt[i] = t2
        al[i, : h.n_docs] = h.alive

    ipg, rsg = _global_tables(hosts, stats, t_pad)
    shard0 = NamedSharding(mesh, P(DOCS_AXIS))
    return ShardedIndex(
        post_doc=jax.device_put(pd, shard0),
        post_val=jax.device_put(pv, shard0),
        post_tf=jax.device_put(pt, shard0),
        alive=jax.device_put(al, shard0),
        doc_base=jax.device_put(
            np.array(
                [h.doc_base for h in hosts], np.int32
            ).reshape(n_shards, 1),
            shard0,
        ),
        indptr_g=ipg,
        indptr_d=jax.device_put(ipg, shard0),
        row_start_d=jax.device_put(rsg, shard0),
        hosts=hosts,
        stats=stats,
        n_shards=n_shards,
        d_pad=d_pad,
        t_pad=t_pad,
    )


@partial(jax.jit, static_argnames=("kind",))
def _sharded_materialize_vals(
    post_doc,  # (n_shards, X, 128) i32
    post_tf,  # (n_shards, X, 128) i32
    k_doc,  # (n_shards, d_pad) f32
    inv_norm,  # (n_shards, d_pad) f32
    alive,  # (n_shards, d_pad) bool
    k1p1,  # f32 scalar
    kind: str,
):
    """Stacked-shard version of builder.device_materialize_vals: the
    sharding (docs axis 0) is preserved, so the O(nnz) planes never
    leave their shards; only the (n_shards, d_pad) inputs were shipped.
    Same bit-exact formula and the same host-computed K(dl) (see
    builder.device_materialize_vals for the FMA-contraction rationale).
    """

    def one(pd, pt, kd, inv, al):
        return _materialize_plane(pd, pt, kd, inv, al, k1p1, kind)

    return jax.vmap(one)(post_doc, post_tf, k_doc, inv_norm, alive)


def _materialize_plane(pd, pt, kd, inv, al, k1p1, kind: str):
    """Shared value-materialization body (DESIGN.md §2/§4 exactness
    notes live on builder.device_materialize_vals)."""
    tff = pt.astype(jnp.float32)
    if kind == "tfidf":
        val = tff * inv[pd]
    else:
        val = builder.exact_div(tff * k1p1, tff + kd[pd])
    # explicit select (not `val * alive`): padding exact_div(0,0)
    # is NaN; stored padding must be +0.0 bits (ADVICE.md round 2)
    val = jnp.where(al[pd], val, jnp.float32(0.0))
    return jax.lax.bitcast_convert_type(val, jnp.int32)


def build_sharded(
    texts, config: IndexConfig, mesh: Mesh, device_build: bool = True
) -> ShardedIndex:
    """Build a document-sharded index: contiguous doc ranges per shard,
    corpus-global vocabulary/df, fleet-uniform padded shapes.

    device_build (default): the ONE-SPMD-JOB build (build_sharded_spmd)
    — "index build is itself a jit-compiled batch job" (BASELINE.json:5)
    scaled over the mesh, global df by psum (SURVEY.md §3b). The host
    build remains as the tested-equal fallback."""
    texts = list(texts)
    if device_build:
        return build_sharded_spmd(texts, config, mesh)
    n_shards = mesh.devices.size
    n_docs = len(texts)
    per = -(-n_docs // n_shards) if n_docs else 1
    hosts = []
    for i in range(n_shards):
        lo, hi = min(i * per, n_docs), min((i + 1) * per, n_docs)
        a = builder.analyze_texts_fast(texts[lo:hi], config)
        hosts.append(builder.build_host_segment(a, lo))
    return assemble_sharded(hosts, config, mesh)


@partial(
    jax.jit,
    static_argnames=("x_rows", "t_pad", "d_pad", "kind", "mesh_"),
)
def _spmd_build_step(
    rows,  # (n_shards, cap) i32 GLOBAL term rows, padding = t_pad
    docs,  # (n_shards, cap) i32 local doc ids, padding = d_pad (OOB)
    tfs,  # (n_shards, cap) i32, padding = 0
    indptr_g,  # (n_shards, t_pad+1) i32
    row_start_g,  # (n_shards, t_pad) i32
    k_doc,  # (n_shards, d_pad) f32
    inv_norm,  # (n_shards, d_pad) f32
    alive,  # (n_shards, d_pad) bool
    k1p1,  # f32 scalar
    x_rows: int,
    t_pad: int,
    d_pad: int,
    kind: str,
    mesh_: Mesh,
):
    """ONE SPMD program for the whole sharded build: per shard, sort the
    (row, doc, tf) triples, scatter the aligned (X, 128) doc/tf planes,
    materialize the value plane, and count local df — then ONE
    `jax.lax.psum` over the docs axis yields the corpus-global df on
    every shard (SURVEY.md §3b's device-side all-reduce; tests pin it
    equal to the host vocab-union merge)."""

    def one(r, d, t, ip, rs, kd, iv, al):
        r, d, t = r[0], d[0], t[0]
        ip, rs, kd, iv, al = ip[0], rs[0], kd[0], iv[0], al[0]
        r, d, t = jax.lax.sort((r, d, t), num_keys=2)
        cap = r.shape[0]
        i = jnp.arange(cap, dtype=jnp.int32)
        nnz = ip[t_pad]  # true postings count (padding sorts last)
        r_c = jnp.minimum(r, t_pad - 1)
        pos = rs[r_c] + (i - ip[r_c])
        total = x_rows * 128
        pos = jnp.where(i < nnz, pos, total)  # OOB scatters are dropped
        doc2 = jnp.full(total, d_pad - 1, jnp.int32).at[pos].set(d)
        tf2 = jnp.zeros(total, jnp.int32).at[pos].set(t)
        # local df: one count per (term, doc) posting; padding rows carry
        # r == t_pad, out of bounds for (t_pad,) — dropped by the scatter
        df_l = jnp.zeros(t_pad, jnp.int32).at[r].add(1)
        df_g = jax.lax.psum(df_l, DOCS_AXIS)  # all-reduce over shards
        doc2 = doc2.reshape(x_rows, 128)
        tf2 = tf2.reshape(x_rows, 128)
        val2 = _materialize_plane(doc2, tf2, kd, iv, al, k1p1, kind)
        return doc2[None], tf2[None], val2[None], df_g[None]

    sh = P(DOCS_AXIS)
    return shard_map(
        one,
        mesh=mesh_,
        in_specs=(sh,) * 8,
        out_specs=(sh, sh, sh, sh),
        check_vma=False,
    )(rows, docs, tfs, indptr_g, row_start_g, k_doc, inv_norm, alive)


def build_sharded_spmd(
    texts, config: IndexConfig, mesh: Mesh
) -> ShardedIndex:
    """One-SPMD-job sharded build (module docstring): host analysis,
    then ONE sharded device_put of the stacked triples and ONE jit
    shard_map program for sort/pack/materialize/df-psum across every
    shard — O(1) dispatches per corpus, not O(shards)."""
    texts = list(texts)
    n_shards = mesh.devices.size
    n_docs = len(texts)
    per = -(-n_docs // n_shards) if n_docs else 1
    parts = []  # (doc_base, AnalyzedDocs)
    for i in range(n_shards):
        lo, hi = min(i * per, n_docs), min((i + 1) * per, n_docs)
        parts.append((lo, builder.analyze_texts_fast(texts[lo:hi], config)))
    return _build_sharded_from_parts(parts, config, mesh)


def _split_analyzed(a, n_shards: int):
    """Re-split one AnalyzedDocs into contiguous per-shard parts."""
    n_docs = a.n_docs
    per = -(-n_docs // n_shards) if n_docs else 1
    parts = []
    for i in range(n_shards):
        lo, hi = min(i * per, n_docs), min((i + 1) * per, n_docs)
        s, e = int(a.doc_ptr[lo]), int(a.doc_ptr[hi])
        parts.append(
            (
                lo,
                builder.AnalyzedDocs(
                    hashes=a.hashes[s:e],
                    tfs=a.tfs[s:e],
                    doc_ptr=a.doc_ptr[lo : hi + 1] - a.doc_ptr[lo],
                    dl=a.dl[lo:hi],
                ),
            )
        )
    return parts


def _build_sharded_from_parts(parts, config: IndexConfig, mesh: Mesh):
    n_shards = mesh.devices.size
    # per-shard host metadata with LOCAL vocab (the checkpoint format;
    # postings per term = df since (doc, term) pairs are unique)
    hosts = []
    for lo, a in parts:
        vocab, _rows_l, df_l = builder.segment_vocab(a)
        indptr_l = np.zeros(len(vocab) + 1, np.int32)
        np.cumsum(df_l, out=indptr_l[1:])
        row_start_l, _xr = builder.aligned_geometry(
            indptr_l, config.nnz_pad_to
        )
        hosts.append(
            builder.SegmentHost(
                term_hash=vocab,
                df=df_l,
                doc_base=lo,
                n_docs=a.n_docs,
                dl=a.dl.copy(),
                alive=np.ones(a.n_docs, dtype=bool),
                doc_hashes=a.hashes,
                doc_tfs=a.tfs,
                doc_ptr=a.doc_ptr,
                indptr=indptr_l,
                row_start=row_start_l,
                post_doc=None,  # device-built: planes live in HBM only
                post_tf=None,
            )
        )
    stats = merge_stats(hosts)
    t_pad = _global_t_pad(stats)
    d_pad = round_up(max(h.n_docs for h in hosts) + 1, config.docs_pad_to)
    geoms = [
        builder.aligned_geometry(h.indptr, config.nnz_pad_to)
        for h in hosts
    ]
    x_rows = max(x for _, x in geoms)
    x_rows = x_rows + max(x_rows // 8, 8)
    ipg, rsg = _global_tables(hosts, stats, t_pad)

    # stacked triples in the GLOBAL row space; padding sorts last and
    # its scatters fall out of bounds (dropped)
    cap = max(max(len(a.hashes) for _, a in parts), 1)
    rows_st = np.full((n_shards, cap), t_pad, np.int32)
    docs_st = np.full((n_shards, cap), d_pad, np.int32)
    tfs_st = np.zeros((n_shards, cap), np.int32)
    for i, (lo, a) in enumerate(parts):
        nnz = len(a.hashes)
        if nnz == 0:
            continue
        rows_st[i, :nnz] = stats.lookup(a.hashes)  # native-accelerated
        docs_st[i, :nnz] = np.repeat(
            np.arange(a.n_docs, dtype=np.int32),
            np.diff(a.doc_ptr).astype(np.int64),
        )
        tfs_st[i, :nnz] = a.tfs

    kd = np.zeros((n_shards, d_pad), F32)
    inv = np.zeros((n_shards, d_pad), F32)
    al = np.zeros((n_shards, d_pad), bool)
    for i, h in enumerate(hosts):
        k_doc, inv_norm, alive = builder.refresh_inputs(h, config, stats)
        kd[i, : h.n_docs] = k_doc
        inv[i, : h.n_docs] = inv_norm
        al[i, : h.n_docs] = alive

    shard0 = NamedSharding(mesh, P(DOCS_AXIS))
    pd, pt, pv, df_g = _spmd_build_step(
        jax.device_put(rows_st, shard0),
        jax.device_put(docs_st, shard0),
        jax.device_put(tfs_st, shard0),
        jax.device_put(ipg, shard0),
        jax.device_put(rsg, shard0),
        jax.device_put(kd, shard0),
        jax.device_put(inv, shard0),
        jax.device_put(al, shard0),
        jnp.float32(F32(config.scoring.k1 + 1.0)),
        x_rows=x_rows,
        t_pad=t_pad,
        d_pad=d_pad,
        kind=config.scoring.kind,
        mesh_=mesh,
    )
    idx = ShardedIndex(
        post_doc=pd,
        post_val=pv,
        post_tf=pt,
        alive=jax.device_put(al, shard0),
        doc_base=jax.device_put(
            np.array(
                [h.doc_base for h in hosts], np.int32
            ).reshape(n_shards, 1),
            shard0,
        ),
        indptr_g=ipg,
        indptr_d=jax.device_put(ipg, shard0),
        row_start_d=jax.device_put(rsg, shard0),
        hosts=hosts,
        stats=stats,
        n_shards=n_shards,
        d_pad=d_pad,
        t_pad=t_pad,
        df_psum=np.asarray(df_g[0]),  # replicated over the axis
    )
    return idx


def refresh_sharded_vals(idx: ShardedIndex, config: IndexConfig, mesh: Mesh):
    """Device-side val re-materialization for every shard after
    df/N/avgdl change: ships only (n_shards, d_pad) k_doc/inv_norm/alive
    — O(docs) H2D, the O(nnz) planes stay resident. Rebuilds the
    global-row lookup tables only when the global vocabulary changed."""
    old_vocab = idx.stats.vocab
    idx.stats = merge_stats(idx.hosts)
    if not np.array_equal(idx.stats.vocab, old_vocab):
        assert len(idx.stats.vocab) <= idx.t_pad, (
            "vocabulary outgrew t_pad — callers must reassemble instead"
        )
        shard0 = NamedSharding(mesh, P(DOCS_AXIS))
        ipg, rsg = _global_tables(idx.hosts, idx.stats, idx.t_pad)
        idx.indptr_g = ipg
        idx.indptr_d = jax.device_put(ipg, shard0)
        idx.row_start_d = jax.device_put(rsg, shard0)
    n_shards, d_pad = idx.n_shards, idx.d_pad
    kd = np.zeros((n_shards, d_pad), F32)
    inv = np.zeros((n_shards, d_pad), F32)
    al = np.zeros((n_shards, d_pad), bool)
    for i, h in enumerate(idx.hosts):
        k_doc, inv_norm, alive = builder.refresh_inputs(
            h, config, idx.stats
        )
        kd[i, : h.n_docs] = k_doc
        inv[i, : h.n_docs] = inv_norm
        al[i, : h.n_docs] = alive
    shard0 = NamedSharding(mesh, P(DOCS_AXIS))
    idx.alive = jax.device_put(al, shard0)
    idx.post_val = _sharded_materialize_vals(
        idx.post_doc,
        idx.post_tf,
        jax.device_put(kd, shard0),
        jax.device_put(inv, shard0),
        idx.alive,
        jnp.float32(F32(config.scoring.k1 + 1.0)),
        kind=config.scoring.kind,
    )


@partial(jax.jit, static_argnames=("p", "mesh_"))
def _sharded_quantiles(
    post_doc,  # (n_shards, X, 128) i32 aligned doc planes, sharded
    indptr_g,  # (n_shards, t_pad+1) i32 global-row tables, sharded
    row_start_g,  # (n_shards, t_pad) i32, sharded
    n_loc,  # (n_shards, 1) i32 true LOCAL doc counts, sharded
    p: int,
    mesh_: Mesh,
):
    """Per-shard (t_pad, P+1) doc-quantile tables in the global row
    space, ONE SPMD job: each shard binary-searches its resident doc
    plane against its OWN local-doc thresholds (traced — hence
    builder.device_row_doc_quantiles_b), so piece j of any query covers
    shard-local docs [j*n_s/P, (j+1)*n_s/P) on every shard s. Absent
    rows (zero length in this shard) yield all-zero offsets."""

    def local(pd, ipg, rsg, nl):
        j = jnp.arange(1, p, dtype=jnp.int32)
        # == host quantile_doc_bounds in i32 (callers assert
        # d_pad * P < 2^31, so the i64 host math agrees)
        bounds = (j * nl[0, 0]) // jnp.int32(p)
        return builder.device_row_doc_quantiles_b(
            pd[0], ipg[0], rsg[0], bounds
        )[None]

    sh = P(DOCS_AXIS)
    return shard_map(
        local,
        mesh=mesh_,
        in_specs=(sh, sh, sh, sh),
        out_specs=sh,
    )(post_doc, indptr_g, row_start_g, n_loc)


@partial(
    jax.jit,
    static_argnames=(
        "k", "plan", "d_pad", "scale", "clip", "mode", "mesh_", "split_p",
    ),
)
def _sharded_batch_step(
    post_doc,  # (n_shards, X, 128) i32 aligned doc planes
    post_val,  # (n_shards, X, 128) i32 aligned bitcast-f32 val planes
    doc_base,  # (n_shards, 1) i32
    indptr_g,  # (n_shards, t_pad+1) i32 global-row tables, sharded
    row_start_g,  # (n_shards, t_pad) i32, sharded
    rows_cat,  # (B_total, S) i32 — REPLICATED (rows are global)
    cbits_cat,  # (B_total, S) i32 bitcast-f32 coefficients, replicated
    k: int,
    plan,  # static: (s, ((n_blocks, block, bq), ...)) bucket layout
    d_pad: int,
    scale: float,
    clip: float,
    mode: str,  # "fused" (CUDA kernel where it fits) | "xla"
    mesh_: Mesh,
    cols_cat=None,  # (B_total, 2) i32 piece quantile cols, replicated
    quant=None,  # (n_shards, t_pad, P+1) i32 quantile tables, sharded
    n_loc=None,  # (n_shards, 1) i32 true local doc counts, sharded
    split_p: int = 0,  # static: quantile columns P (0 = splitting off)
):
    """One SPMD dispatch for a whole query batch: per shard, the DMA
    plan tables expand on device from the resident global-row tables,
    every bucket's scorer (the CUDA kernel where the bucket fits it, its
    bit-identical XLA twin otherwise) runs inside the same program,
    candidates are concatenated, and a single `all_gather` + replicated
    merge produce the global top-k.

    split_p > 0 (doc-range splitting, see SearchEngine.split_rows):
    plan rows are PIECES covering quantile columns [c0, c1); each
    shard's record ranges gather from its resident quantile table and
    its kernel masks arrivals to ITS local doc range [c*n_s/P ...) —
    the piece structure is fleet-uniform, the doc limits are per-shard
    (traced from n_loc)."""
    from ..ops.fused_cuda import score_bucket
    from ..ops.plan import expand_plan_tables

    s, buckets = plan

    def local(pd, pv, base, ipg, rsg, rows_cat, cbits_cat, *extra):
        pd, pv, ipg, rsg = pd[0], pv[0], ipg[0], rsg[0]
        if split_p:
            cols_all, qt, nl = extra[0], extra[1][0], extra[2][0, 0]
        parts_v, parts_g = [], []
        off = 0
        for n_blocks, block, bq, r_c in buckets:
            rows_b = jax.lax.slice_in_dim(rows_cat, off, off + bq)
            cbits_b = jax.lax.slice_in_dim(cbits_cat, off, off + bq)
            if split_p:
                cols_b = jax.lax.slice_in_dim(cols_all, off, off + bq)
                dlim = (
                    (cols_b * nl) // jnp.int32(split_p)
                ).reshape(bq, 1, 2)
            else:
                cols_b = dlim = None
            off += bq
            tables = expand_plan_tables(
                rsg, ipg, rows_b, cbits_b, n_blocks, block,
                offs_dev=qt if split_p else None,
                cols=cols_b,
            )
            # d_pad-1 is a safe uniform local sentinel: every shard's
            # real local ids are <= d_pad-2 (d_pad >= max local docs + 1)
            v, g = score_bucket(
                mode, pd, pv, tables, base[0, 0],
                n_blocks=n_blocks, block=block, s=s, k=k,
                n_docs=d_pad - 1, r_c=r_c, scale=scale, clip=clip,
                dlim=dlim,
            )
            parts_v.append(v)
            parts_g.append(g)
        vals = jnp.concatenate(parts_v, axis=0)  # (B_total, k)
        gids = jnp.concatenate(parts_g, axis=0)
        # the one collective: a gather of every shard's candidates
        vals_g = jax.lax.all_gather(vals, DOCS_AXIS)  # (S, B_total, k)
        gids_g = jax.lax.all_gather(gids, DOCS_AXIS)
        nq = vals.shape[0]
        vals_c = jnp.swapaxes(vals_g, 0, 1).reshape(nq, -1)
        gids_c = jnp.swapaxes(gids_g, 0, 1).reshape(nq, -1)
        mv, mg = merge_candidates(vals_c, gids_c, k=k)
        # Every shard computed the identical merge of the all-gathered
        # candidates; emit them stacked over the axis (sliced to one
        # replica by the caller) — keeps the vma replication check on.
        return mv[None], mg[None]

    sh = P(DOCS_AXIS)
    operands = (
        post_doc, post_val, doc_base, indptr_g, row_start_g, rows_cat,
        cbits_cat,
    )
    in_specs = (sh, sh, sh, sh, sh, P(), P())
    if split_p:
        operands += (cols_cat, quant, n_loc)
        in_specs += (P(), sh, sh)
    vals_all, gids_all = shard_map(
        local,
        mesh=mesh_,
        in_specs=in_specs,
        out_specs=(sh, sh),
        # ffi_call outputs carry no vma annotation, which the vma
        # check rejects; replication is still guaranteed by the
        # all-gather + identical merge (pinned by the shard-count
        # invariance tests)
        check_vma=False,
    )(*operands)
    # (n_shards, nq, k) of identical replicas -> one copy, stacked as
    # ONE (nq, 2k) output so the caller forces a SINGLE D2H read.
    return jnp.concatenate([vals_all[0], gids_all[0]], axis=1)


@partial(jax.jit, static_argnames=("mesh_",))
def _sharded_gather_dots(
    emb,  # (n_shards, d_pad, dim) i8, sharded over docs
    ssq,  # (n_shards, d_pad) i32, sharded
    doc_base,  # (n_shards, 1) i32, sharded
    n_docs_sh,  # (n_shards, 1) i32, sharded — true docs per shard
    qemb,  # (nq, dim) i8, replicated
    gids,  # (nq, K) i32 candidate global ids (-1 = dead), replicated
    mesh_: Mesh,
):
    """SPMD candidate rerank dots: each shard gathers + dots only
    the candidates whose global id falls in its doc range (others
    contribute exact zeros), then ONE integer psum over the docs axis
    assembles the full (nq, K) dots and candidate squared norms — the
    collective carries the tiny dots matrix, never the embeddings.
    All values are exact integers (ops/rerank.py exactness scheme)."""
    from ..ops.rerank import rerank_dots

    def local(e, sq, base, nd, q, g):
        e, sq, base, nd = e[0], sq[0], base[0, 0], nd[0, 0]
        loc = g - base
        mine = (g >= 0) & (loc >= 0) & (loc < nd)
        safe = jnp.where(mine, loc, 0)
        cand = jnp.where(
            mine[..., None], e[safe].astype(jnp.int8), jnp.int8(0)
        )
        dots = rerank_dots(q, cand)
        dots = jnp.where(mine, dots, 0)
        cs = jnp.where(mine, sq[safe], 0)
        return (
            jax.lax.psum(dots, DOCS_AXIS)[None],
            jax.lax.psum(cs, DOCS_AXIS)[None],
        )

    sh = P(DOCS_AXIS)
    dots_all, ssq_all = shard_map(
        local,
        mesh=mesh_,
        in_specs=(sh, sh, sh, sh, P(), P()),
        out_specs=(sh, sh),
        check_vma=False,
    )(emb, ssq, doc_base, n_docs_sh, qemb, gids)
    return dots_all[0], ssq_all[0]


class DistributedSearchEngine:
    """Multi-chip search engine over a `docs` mesh (same results as the
    single-process SearchEngine, bit-for-bit — tested)."""

    def __init__(self, config: IndexConfig | None = None, mesh: Mesh | None = None):
        self.config = config or IndexConfig()
        self.mesh = mesh or make_mesh()
        self.frontend = QueryFrontend(self.config)
        self.index: ShardedIndex | None = None
        # None = auto ("fused" CUDA kernel on GPU meshes, "xla"
        # elsewhere); see SearchEngine.scorer
        self.scorer: str | None = None
        # None = scorer-tuned block families (see SearchEngine)
        self.block_families = None
        # the ONE-SPMD-job build (build_sharded_spmd); host build kept
        # as the tested-equal fallback
        self.device_build: bool = True
        # smallest per-bucket n_blocks budget (see SearchEngine)
        self.plan_min_blocks: int = 4
        # Doc-range splitting (see SearchEngine.split_rows): heavy
        # queries become doc-disjoint pieces. The piece STRUCTURE is
        # fleet-uniform (it is part of the replicated plan, decided
        # from max-over-shards need); record ranges and doc limits are
        # per-shard, gathered on device from resident quantile tables
        # (_sharded_quantiles). Default OFF (see SearchEngine.split_rows);
        # the OFF path compiles the byte-identical pre-split programs.
        self.split_rows: int | None = None
        # stable compiled-plan layouts (ops/plan_cache.py; see
        # SearchEngine.plan_cache — one SPMD program per traffic shape
        # instead of one per batch)
        from ..ops.plan_cache import PlanLayoutCache

        self.plan_cache: PlanLayoutCache | None = PlanLayoutCache()

    def build(self, texts) -> None:
        self.index = build_sharded(
            texts, self.config, self.mesh, device_build=self.device_build
        )

    def build_streaming(self, batches) -> None:
        """Streaming sharded build (BASELINE.json:10): raw text is
        analyzed and released batch-by-batch (bounded text memory; the
        analyzed (hash, tf) arrays are ~10x smaller), then the docs are
        balanced into contiguous shard ranges and packed by the ONE
        SPMD build job. Bit-identical to bulk build (tested)."""
        analyzed = []
        for b in batches:
            b = list(b)
            if b:
                analyzed.append(builder.analyze_texts_fast(b, self.config))
        if not analyzed:
            self.index = None
            return
        ptr_parts = [np.zeros(1, np.int64)]
        acc = 0
        for a in analyzed:
            ptr_parts.append(a.doc_ptr[1:] + acc)
            acc += int(a.doc_ptr[-1])
        merged = builder.AnalyzedDocs(
            hashes=np.concatenate([a.hashes for a in analyzed]),
            tfs=np.concatenate([a.tfs for a in analyzed]),
            doc_ptr=np.concatenate(ptr_parts),
            dl=np.concatenate([a.dl for a in analyzed]),
        )
        self.index = _build_sharded_from_parts(
            _split_analyzed(merged, self.mesh.devices.size),
            self.config,
            self.mesh,
        )

    @property
    def n_docs_total(self) -> int:
        if self.index is None:
            return 0
        return max(
            h.doc_base + h.n_docs for h in self.index.hosts
        )

    def add_docs(self, texts) -> list:
        """Incremental add: new docs join the last shard (its global-id
        range stays contiguous); global stats and idf-dependent values
        refresh exactly (same semantics as SearchEngine.add_docs —
        tested bit-identical). Rebalancing across shards is `compact`
        (or a full `build`)."""
        texts = list(texts)
        if not texts:
            return []
        if self.index is None:
            self.build(texts)
            return list(range(len(texts)))
        hosts = self.index.hosts
        last = hosts[-1]
        base0 = self.n_docs_total
        a_new = builder.analyze_texts_fast(texts, self.config)
        merged = builder.AnalyzedDocs(
            hashes=np.concatenate([last.doc_hashes, a_new.hashes]),
            tfs=np.concatenate([last.doc_tfs, a_new.tfs]),
            doc_ptr=np.concatenate(
                [last.doc_ptr, last.doc_ptr[-1] + a_new.doc_ptr[1:]]
            ),
            dl=np.concatenate([last.dl, a_new.dl]),
        )
        new_last = builder.build_host_segment(merged, last.doc_base)
        new_last.alive[: last.n_docs] = last.alive
        # df must count alive docs only — the rebuilt shard counted all
        builder.recompute_alive_df(new_last)
        new_hosts = hosts[:-1] + [new_last]
        if not self._update_last_shard(new_hosts):
            # grew past the fleet-uniform padded shapes: full reassemble
            self.index = assemble_sharded(new_hosts, self.config, self.mesh)
        else:
            self.index.hosts = new_hosts
            self._refresh_sharded_vals()
        return list(range(base0, base0 + a_new.n_docs))

    def _update_last_shard(self, new_hosts) -> bool:
        """O(shard) in-place device update for an add that fits the
        existing padded shapes: ship ONE shard's new planes and lookup
        tables and dynamic-update the stacked arrays; every other
        shard's postings stay resident (their idf-dependent vals refresh
        separately; their global-row tables refresh only if the global
        vocabulary gained terms). Returns False when the shard or the
        vocabulary outgrew the allocation."""
        idx = self.index
        new_last = new_hosts[-1]
        t_pad = idx.t_pad
        x_rows = idx.post_doc.shape[1]
        row_start, xr = builder.aligned_geometry(
            new_last.indptr, self.config.nnz_pad_to
        )
        new_stats = merge_stats(new_hosts)
        if (
            len(new_stats.vocab) > t_pad
            or xr > x_rows
            or new_last.n_docs + 1 > idx.d_pad
        ):
            return False
        new_last.row_start = row_start
        d2, _v2, t2 = builder._host_planes(
            new_last.post_doc,
            np.zeros(0, np.float32),  # vals follow from the refresh
            new_last.post_tf,
            new_last.indptr,
            row_start,
            x_rows,
            new_last.n_docs,
        )
        i = idx.n_shards - 1
        idx.post_doc = idx.post_doc.at[i].set(d2)
        idx.post_tf = idx.post_tf.at[i].set(t2)
        if np.array_equal(new_stats.vocab, idx.stats.vocab):
            # vocabulary unchanged: only the last shard's rows moved
            ip_i, rs_i = _global_tables_one(new_last, new_stats, t_pad)
            idx.indptr_g[i] = ip_i
            idx.indptr_d = idx.indptr_d.at[i].set(ip_i)
            idx.row_start_d = idx.row_start_d.at[i].set(rs_i)
        # else: the vocab-change path is handled by refresh_sharded_vals
        # (every shard's global row indices shift — O(vocab) tables, the
        # O(nnz) planes stay resident)
        return True

    def _refresh_sharded_vals(self) -> None:
        refresh_sharded_vals(self.index, self.config, self.mesh)

    def delete_docs(self, global_ids) -> None:
        """Tombstone docs across shards with exact df/N/avgdl updates —
        vectorized like SearchEngine.delete_docs (one searchsorted over
        the shard bases, batched df decrements per shard; round-3
        VERDICT)."""
        if self.index is None:
            return
        from ..engine.engine import delete_from_hosts

        if delete_from_hosts(self.index.hosts, global_ids):
            # O(delta): postings stay resident; only per-doc arrays ship
            self._refresh_sharded_vals()

    def compact(self) -> None:
        """Physically drop tombstoned docs' postings across every shard.
        Global doc ids stay stable (dead ids keep empty slots and stay
        dead — the SearchEngine.compact contract); results are identical
        before and after (tested). Mechanism: per-shard host rebuild
        from the alive docs' analyzed terms + one reassembly."""
        if self.index is None:
            return
        new_hosts = []
        for h in self.index.hosts:
            lens = np.diff(h.doc_ptr).astype(np.int64)
            keep_doc = h.alive
            keep_post = np.repeat(keep_doc, lens)
            ptr = np.zeros(h.n_docs + 1, np.int64)
            np.cumsum(np.where(keep_doc, lens, 0), out=ptr[1:])
            a = builder.AnalyzedDocs(
                hashes=h.doc_hashes[keep_post],
                tfs=h.doc_tfs[keep_post],
                doc_ptr=ptr,
                dl=np.where(keep_doc, h.dl, 0).astype(np.int32),
            )
            nh = builder.build_host_segment(a, h.doc_base)
            nh.alive[:] = h.alive  # dead ids keep empty slots, stay dead
            new_hosts.append(nh)
        self.index = assemble_sharded(new_hosts, self.config, self.mesh)

    # ----------------------------------------------------- hybrid rerank
    def _sharded_embeddings(self, dim: int):
        """Per-shard device int8 feature-hash embeddings, stacked
        (n_shards, d_pad, dim) over the docs axis — each shard's rows
        are built from its resident posting planes (ops/rerank.py
        device builder; local vocab projection — cols/signs derive from
        term hashes, so rows are bit-identical to the single engine's).
        Cached until the next stats refresh."""
        from ..ops.rerank import device_doc_embeddings_int, term_projection

        idx = self.index
        cache = getattr(self, "_emb_cache", None)
        key = (dim, id(idx.post_val))  # refresh replaces post_val
        if cache is not None and cache[0] == key:
            return cache[1]
        d_pad = idx.d_pad
        embs, ssqs = [], []
        for i, h in enumerate(idx.hosts):
            if h.n_terms == 0 or h.n_docs == 0:
                embs.append(jnp.zeros((d_pad, dim), jnp.int8))
                ssqs.append(jnp.zeros((d_pad,), jnp.int32))
                continue
            col, sign = term_projection(h.term_hash, dim)
            e, ss = device_doc_embeddings_int(
                idx.post_doc[i],
                idx.post_val[i],
                jnp.asarray(h.row_start.astype(np.int32)),
                jnp.asarray(col),
                jnp.asarray(sign),
                n_docs=h.n_docs,
                dim=dim,
            )
            pad = d_pad - h.n_docs
            embs.append(jnp.pad(e, ((0, pad), (0, 0))))
            ssqs.append(jnp.pad(ss, (0, pad)))
        shard0 = NamedSharding(self.mesh, P(DOCS_AXIS))
        out = (
            jax.device_put(jnp.stack(embs), shard0),
            jax.device_put(jnp.stack(ssqs), shard0),
        )
        self._emb_cache = (key, out)
        return out

    def search_rerank(
        self,
        queries,
        k: int = 10,
        dim: int = 256,
        candidates: int = 64,
    ):
        """Sharded hybrid retrieval (BASELINE.json:11), bit-identical to
        SearchEngine.search_rerank (tested): lexical candidate gen, then
        ONE SPMD dispatch in which each shard dots the candidates it
        owns against its resident int8 embeddings and a psum over the
        docs axis assembles the exact integer dots; the f64 cosine +
        quantized ordering runs on host from those exact integers."""
        from ..ops.rerank import query_embeddings_int, rerank_order_int

        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        kk = max(k, candidates)
        nq = len(queries)
        if nq == 0 or self.index is None or self.n_docs_total == 0:
            gids, lex = self.search(queries, k=kk)
            ri = np.full((nq, k), -1, np.int64)
            return gids[:, :k], ri, lex[:, :k]
        idx = self.index
        # ONE frontend pass feeds both stages (round-3 VERDICT: the
        # rerank stage re-analyzed the batch the candidate-gen search
        # had just analyzed)
        analyzed = self.frontend.analyze_rows(queries, idx.stats)
        slot_h, coeff = analyzed[0], analyzed[1]
        gids, lex = self._collect(
            self._dispatch(queries, kk, analyzed=analyzed)
        )
        qemb, ssq_q = query_embeddings_int(slot_h, coeff, dim)
        emb, ssq = self._sharded_embeddings(dim)
        n_docs_sh = np.array(
            [h.n_docs for h in idx.hosts], np.int32
        ).reshape(idx.n_shards, 1)
        dots, cand_ssq = _sharded_gather_dots(
            emb,
            ssq,
            idx.doc_base,
            jax.device_put(
                np.asarray(n_docs_sh),
                NamedSharding(self.mesh, P(DOCS_AXIS)),
            ),
            jnp.asarray(qemb),
            jnp.asarray(gids.astype(np.int32)),
            mesh_=self.mesh,
        )
        return rerank_order_int(
            np.asarray(dots), ssq_q, np.asarray(cand_ssq), lex, gids, k
        )

    def save(self, path: str) -> None:
        from ..index.checkpoint import save_sharded

        save_sharded(self, path)

    @classmethod
    def load(cls, path: str, mesh: Mesh | None = None):
        from ..index.checkpoint import load_sharded

        return load_sharded(path, mesh=mesh)

    @property
    def scorer_mode(self) -> str:
        """Active scorer inside the SPMD step: "fused" (the CUDA kernel,
        GPU-mesh default) or "xla". Bit-identical (tested)."""
        from ..ops.fused_cuda import resolve_scorer

        return resolve_scorer(
            self.scorer, self.mesh.devices.flat[0].platform
        )

    def _families(self, mode):
        return self.block_families or (
            FUSED_FAMILIES if mode == "fused" else DEFAULT_FAMILIES
        )

    def search(self, queries, k: int = 10):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        nq = len(queries)
        if self.index is None or nq == 0:
            return (
                np.full((nq, k), -1, np.int64),
                np.full((nq, k), -1, np.int64),
            )
        fut = self._dispatch(queries, k)
        return self._collect(fut)

    def search_stream(self, query_batches, k: int = 10, depth: int = 2):
        """Pipelined sharded serving loop (same contract as
        SearchEngine.search_stream): one SPMD dispatch per batch, up to
        `depth` batches in flight; text analysis prefetched on a worker
        thread and re-run synchronously if the index was swapped between
        prefetch and dispatch (the prefetched row table is only valid
        for the index snapshot it was built from)."""
        from functools import partial as _partial

        from ..engine.engine import pipelined_stream

        def analyze_job(queries):
            idx = self.index  # snapshot: identity-checked at dispatch
            if len(queries) == 0 or idx is None:
                return None
            stats = idx.stats  # O(delta) updates replace stats in place
            return (
                (idx, stats),
                self.frontend.analyze_rows(queries, stats),
            )

        def dispatch_job(queries, res):
            if res is not None and (
                res[0][0] is not self.index
                or self.index.stats is not res[0][1]
            ):
                res = analyze_job(queries)  # index mutated mid-stream
            if res is None and len(queries) and self.index is not None:
                res = analyze_job(queries)  # built mid-stream
            if res is None:
                nq = len(queries)
                empty = (
                    np.full((nq, k), -1, np.int64),
                    np.full((nq, k), -1, np.int64),
                )
                return lambda e=empty: e
            fut = self._dispatch(queries, k, analyzed=res[1])
            return _partial(self._collect, fut)

        yield from pipelined_stream(
            query_batches, depth, analyze_job, dispatch_job
        )

    def _plan_key(self, s, k, mode):
        """Plan-layout cache key (see SearchEngine._plan_key): must be
        identical between preplan() and _dispatch()."""
        idx = self.index
        return (
            idx.n_shards, idx.d_pad, idx.t_pad,
            int(idx.post_doc.shape[1]), s, k, mode,
            self._families(mode), self.plan_min_blocks, self.split_rows,
        )

    def _split_active(self, k, families) -> bool:
        """Same gate as SearchEngine._split_active."""
        return (
            self.split_rows is not None
            and k <= 128
            and len(families) == 1
        )

    def _doc_quantiles(self):
        """(offs_h (n_shards, t_pad, P+1) numpy, offs_d sharded device
        copy, n_loc_d sharded (n_shards, 1) i32): per-shard doc-quantile
        tables, computed by ONE SPMD job against each shard's resident
        planes and read back ONCE for the host piece planner. Cached by
        plane/table identity — add/delete/compact swap those objects."""
        idx = self.index
        cache = getattr(self, "_quant_cache", None)
        # identity refs, not id(): a GC'd plane's id can be reused
        if (
            cache is not None
            and cache[0] is idx.post_doc
            and cache[1] is idx.indptr_d
        ):
            return cache[2], cache[3], cache[4]
        p = builder.SPLIT_QUANTILES
        # the device job computes thresholds j*n/P in i32; equal to the
        # host's i64 quantile_doc_bounds below this bound
        assert idx.d_pad * p < 2**31, "doc count overflows i32 quantiles"
        n_loc = np.array(
            [h.n_docs for h in idx.hosts], np.int32
        ).reshape(idx.n_shards, 1)
        n_loc_d = jax.device_put(
            n_loc, NamedSharding(self.mesh, P(DOCS_AXIS))
        )
        offs_d = _sharded_quantiles(
            idx.post_doc, idx.indptr_d, idx.row_start_d, n_loc_d,
            p=p, mesh_=self.mesh,
        )
        offs_h = np.asarray(offs_d)  # ONE D2H per index version
        self._quant_cache = (
            idx.post_doc, idx.indptr_d, offs_h, offs_d, n_loc_d,
        )
        return offs_h, offs_d, n_loc_d

    def _batch_plan(self, rows, found, a_all, mode, k, families):
        """Shared by preplan and _dispatch: the batch's natural plan
        plus (when splitting) the piece table. Returns (rows_p, a_p,
        cols, qidx, pno, natural); cols/qidx/pno are None when the plan
        rows are the queries themselves."""
        idx = self.index
        lens_sh = (
            idx.indptr_g[:, rows + 1] - idx.indptr_g[:, rows]
        ) * found[None]
        compact = mode == "fused" and k <= 128
        if not self._split_active(k, families):
            natural = plan_batch_sharded(
                lens_sh, families=families,
                min_blocks=self.plan_min_blocks, compact=compact,
            )
            return rows, a_all, None, None, None, natural
        from ..ops.schedule import split_pieces_sharded

        offs_h, _offs_d, _n_loc = self._doc_quantiles()
        qidx, pno, cols, lens_p_sh = split_pieces_sharded(
            lens_sh, rows, offs_h, self.split_rows, families[0][1],
            builder.SPLIT_QUANTILES,
        )
        natural = plan_batch_sharded(
            lens_p_sh, families=families,
            min_blocks=self.plan_min_blocks, compact=compact,
        )
        return rows[qidx], a_all[qidx], cols, qidx, pno, natural

    def preplan(self, query_batches, k: int = 10) -> None:
        """Host-only: converge the plan-layout cache over representative
        batches before the first SPMD dispatch (see
        SearchEngine.preplan) — one compiled program per traffic shape
        instead of one per layout generation."""
        from ..engine.engine import slice_active_slots

        if self.plan_cache is None or self.index is None:
            return
        idx = self.index
        mode = self.scorer_mode
        families = self._families(mode)
        per_key: dict = {}
        for queries in query_batches:
            slot_h, coeff, rows, found = self.frontend.analyze_rows(
                queries, idx.stats
            )
            n_slots = slot_h.shape[1]
            slot_h, coeff = slice_active_slots(slot_h, coeff)
            s = slot_h.shape[1]
            if s != n_slots:
                rows, found = rows[:, :s], found[:, :s]
            a_all = np.where(found, coeff, F32(0.0)).astype(F32)
            rows_p, _a_p, _cols, _qidx, _pno, natural = (
                self._batch_plan(rows, found, a_all, mode, k, families)
            )
            key = self._plan_key(s, k, mode)
            ent = per_key.setdefault(key, [0, []])
            ent[0] = max(ent[0], rows_p.shape[0])
            ent[1].append(natural)
        for key, (nq, naturals) in per_key.items():
            self.plan_cache.seed_plans(key, naturals, nq)

    def warmup(
        self,
        queries=None,
        nq: int = 8192,
        k: int = 10,
        terms_per_query: int = 8,
        seed: int = 0,
    ) -> None:
        """Precompile the SPMD serving program before traffic arrives
        (round-4 VERDICT #4: SearchEngine had warmup() but the sharded
        engine's first real batch compiled during serving). Same
        contract as SearchEngine.warmup: with `queries` this is one
        search; without, a synthetic df-weighted batch seeds the plan
        layout close to production traffic's. `terms_per_query` must
        match production traffic's active-slot width
        (slice_active_slots makes it a jit signature dimension)."""
        from ..engine.engine import synth_warmup_analysis

        if self.index is None or self.n_docs_total == 0:
            return
        if queries is not None:
            self.search(queries, k=k)
            return
        batch = synth_warmup_analysis(
            self.index.stats, self.config, nq, terms_per_query, seed
        )
        if batch is None:
            return
        # _dispatch only takes len() of `queries`; the analysis is
        # supplied pre-built
        self._collect(self._dispatch(range(nq), k, analyzed=batch))

    def _dispatch(self, queries, k: int, analyzed=None):
        """Host planning + ONE fused SPMD dispatch for a query batch.

        Rows are global, so the host does ONE vocab lookup — inside the
        frontend, which returns the row table with the dfs — and ships
        ONE replicated (B_total, S) rows/coeff-bits pair; per-shard DMA
        plan tables expand on device inside the SPMD program. Block
        budgets are scorer-tuned families, max-over-shards per bucket
        (uniform SPMD shapes)."""
        from ..engine.engine import slice_active_slots

        idx = self.index
        nq = len(queries)
        if analyzed is None:
            analyzed = self.frontend.analyze_rows(queries, idx.stats)
        slot_h, coeff, rows, found = analyzed
        n_slots = slot_h.shape[1]
        slot_h, coeff = slice_active_slots(slot_h, coeff)
        s = slot_h.shape[1]
        if s != n_slots:
            rows, found = rows[:, :s], found[:, :s]
        a_all = np.where(found, coeff, F32(0.0)).astype(F32)
        mode = self.scorer_mode
        families = self._families(mode)
        sc = self.config.scoring
        scale = float(F32(2.0**sc.scale_bits))
        clip = float(
            F32(int(spec.quant_clip_max(self.config.max_query_terms)))
        )
        split = self._split_active(k, families)
        rows_p, a_p, cols, qidx, pno, natural = self._batch_plan(
            rows, found, a_all, mode, k, families
        )
        n_rows_p = rows_p.shape[0]
        if self.plan_cache is not None:
            key = self._plan_key(s, k, mode)
            cells = self.plan_cache.canonicalize(key, natural, n_rows_p)
        else:
            cells = [
                (
                    idx_q, nb, blk, rc,
                    1 << int(np.ceil(np.log2(max(len(idx_q), 1)))),
                )
                for idx_q, nb, blk, rc in natural
            ]
        buckets, idxs, r_subs, a_subs, c_subs = [], [], [], [], []
        for idx_q, n_blocks, block, r_c, bq in cells:
            r_sub = np.zeros((bq, s), np.int32)
            a_sub = np.zeros((bq, s), F32)
            r_sub[: len(idx_q)] = rows_p[idx_q]
            a_sub[: len(idx_q)] = a_p[idx_q]
            r_subs.append(r_sub)
            a_subs.append(a_sub)
            if split:
                # padding rows take the whole-row piece (0, P) so
                # cols_cat stays aligned with the bucket offsets
                c_sub = np.zeros((bq, 2), np.int32)
                c_sub[:, 1] = builder.SPLIT_QUANTILES
                c_sub[: len(idx_q)] = cols[idx_q]
                c_subs.append(c_sub)
            buckets.append((n_blocks, block, bq, r_c))
            idxs.append((idx_q, bq))
        if split:
            _offs_h, offs_d, n_loc_d = self._doc_quantiles()
        out = _sharded_batch_step(
            idx.post_doc,
            idx.post_val,
            idx.doc_base,
            idx.indptr_d,
            idx.row_start_d,
            jnp.asarray(np.concatenate(r_subs, axis=0)),
            jnp.asarray(np.concatenate(a_subs, axis=0).view(np.int32)),
            k=k,
            plan=(s, tuple(buckets)),
            d_pad=idx.d_pad,
            scale=scale,
            clip=clip,
            mode=mode,
            mesh_=self.mesh,
            cols_cat=(
                jnp.asarray(np.concatenate(c_subs, axis=0))
                if split
                else None
            ),
            quant=offs_d if split else None,
            n_loc=n_loc_d if split else None,
            split_p=builder.SPLIT_QUANTILES if split else 0,
        )
        pm = (
            (qidx, pno, int(pno.max()) + 1 if len(pno) else 1, n_rows_p)
            if split
            else None
        )
        return out, idxs, pm, nq, k

    def _collect(self, fut):
        out, idxs, pm, nq, k = fut
        n_rows = nq if pm is None else pm[3]
        v = np.full((n_rows, k), -1, np.int64)
        g = np.full((n_rows, k), -1, np.int64)
        host = np.asarray(out)  # ONE D2H per batch (vals | gids stacked)
        off = 0
        for idx_q, bq in idxs:
            v[idx_q] = host[off : off + len(idx_q), :k]
            g[idx_q] = host[off : off + len(idx_q), k:]
            off += bq
        if pm is not None:
            # doc-range pieces: scatter piece rows to (nq, mmax, k)
            # slots and merge per query by (score desc, gid asc) —
            # pieces are doc-disjoint within every shard, so this IS
            # the unsplit ranking (SearchEngine._collect argument)
            qidx, pno, mmax, _n = pm
            if mmax > 1:
                pv = np.full((nq, mmax * k), -1, np.int64)
                pg = np.full((nq, mmax * k), -1, np.int64)
                pv.reshape(nq, mmax, k)[qidx, pno] = v
                pg.reshape(nq, mmax, k)[qidx, pno] = g
                order = np.lexsort((pg, -pv), axis=-1)[:, :k]
                v = np.take_along_axis(pv, order, axis=1)
                g = np.take_along_axis(pg, order, axis=1)
                g = np.where(v > 0, g, -1)
                v = np.where(v > 0, v, -1)
        return g[:nq], v[:nq]
