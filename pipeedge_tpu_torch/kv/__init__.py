"""The paged KV plane: a shared page pool, a prompt-prefix trie and the
page-table backend the serving executors run on.

Port of the single-replica half of `pipeedge_tpu/kv`:

- `pool`:    `KvPagePool`: per-stage page arenas on the device, refcounts,
             the owner ledger, eviction
- `prefix`:  `PrefixTrie`: whole-page prompt matching + cold eviction
- `backend`: `PagedKvBackend`: the executors' gather/scatter cache
             provider, and the router's prefix export and install
- `ship`:    the frame half of KV shipping (wire-v2 bundles)

Dense per-request cache slots bound serving concurrency by SLOTS; this
package bounds it by TOKENS and shares prompt prefixes across requests.
Disaggregated prefill (`disagg`, `fleet`, the socket half of `ship`)
waits for ROADMAP A5.3b.
"""
from .backend import PagedKvBackend
from .pool import KvPagePool, PoolExhausted, pages_for
from .prefix import PrefixTrie

__all__ = ["KvPagePool", "PagedKvBackend", "PoolExhausted", "PrefixTrie",
           "pages_for"]
