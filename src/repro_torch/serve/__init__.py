"""repro_torch.serve — the serving-side state subsystem.

`repro_torch.serve.cache` owns every byte of KV decoding state: the
contiguous layout, the paged pool + block-table layout, and the
`CacheStore` that accounts for both. `repro_torch.serve.memory` is the
policy layer above it: refcounted prefix sharing with copy-on-write, LRU
eviction of cold indexed pages, and preemption victim selection.
`repro_torch.serve.router` scales out: heterogeneous data-parallel replicas
(each with its own store, memory manager and scheduler) behind a
topology-priced dispatch Router.

Router is imported lazily (`from repro_torch.serve.router import Router`)
to keep this package import light — it pulls in the Engine stack.
"""
from repro_torch.serve.cache import (CacheStore, PageLayout, cache_struct,
                                     init_cache, init_paged, is_paged,
                                     make_layout, paged_struct, serve_dtypes)
from repro_torch.serve.memory import MemoryManager, PrefixIndex

__all__ = ["CacheStore", "MemoryManager", "PageLayout", "PrefixIndex",
           "cache_struct", "init_cache", "init_paged", "is_paged",
           "make_layout", "paged_struct", "serve_dtypes"]
