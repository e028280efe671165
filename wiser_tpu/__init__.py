"""wiser_tpu — an accelerator-resident full-text search engine in JAX.

Clean-slate rebuild of the capabilities of WiSER/Vacuum (FAST'20) for an
accelerator: columnar device-resident posting arrays and SPMD batched
query execution under jax.jit/shard_map, compiled by XLA. See
ARCHITECTURE.md.
"""

__version__ = "0.1.0"

from wiser_tpu.types import SearchQuery, SearchResult, SearchResultEntry, DocInfo

__all__ = [
    "SearchQuery",
    "SearchResult",
    "SearchResultEntry",
    "DocInfo",
    "__version__",
]
