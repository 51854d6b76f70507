"""document_search_engine_tpu — a lexical retrieval stack on GPUs.

Framework with the capabilities of the small Python full-text search
engine `CodeOptimist/document-search-engine` (BASELINE.json:5), built as
a batched device engine: hashed-term analyzer, document-sharded CSR
term–document matrix in device memory, a fused CUDA TF-IDF/BM25 scoring
and ranking kernel over batched queries (an XLA twin elsewhere),
per-shard top-k + all-gather merge across devices. See DESIGN.md.
"""
from .config import AnalyzerConfig, IndexConfig, ScoringConfig

__version__ = "0.1.0"

__all__ = [
    "AnalyzerConfig",
    "IndexConfig",
    "ScoringConfig",
    "__version__",
]
