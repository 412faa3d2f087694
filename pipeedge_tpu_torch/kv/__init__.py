"""The paged KV plane: a shared page pool, a prompt-prefix trie, the
page-table backend the serving executors run on, and disaggregated
prefill.

Port of `pipeedge_tpu/kv`:

- `pool`:    `KvPagePool`: per-stage page arenas on the device, refcounts,
             the owner ledger, eviction
- `prefix`:  `PrefixTrie`: whole-page prompt matching + cold eviction
- `backend`: `PagedKvBackend`: the executors' gather/scatter cache
             provider, the shipped-KV install, and the router's prefix
             export and install
- `ship`:    KV rows as wire-v2 frames (8-bit option, CRC, socket path)
- `disagg`:  `PrefillFleet`: prompt passes on a dedicated IN-PROCESS
             pipeline, results shipped into the decode fleet's pages
- `fleet`:   `RemotePrefillFleet`/`PrefillWorkerLoop`: the CROSS-PROCESS
             fleet (`python -m pipeedge_tpu_torch.prefill_worker` ranks
             over the port's DCN) with the fault-tolerant lease/ack ship
             protocol

Dense per-request cache slots bound serving concurrency by SLOTS; this
package bounds it by TOKENS, shares prompt prefixes across requests, and
lets a prefill fleet feed a decode fleet.
"""
from .backend import PagedKvBackend
from .disagg import PrefillFleet
from .fleet import (PrefillUnavailable, PrefillWorkerLoop,
                    RemotePrefillFleet)
from .pool import KvPagePool, PoolExhausted, pages_for
from .prefix import PrefixTrie

__all__ = [
    "KvPagePool", "PagedKvBackend", "PoolExhausted", "PrefillFleet",
    "PrefillUnavailable", "PrefillWorkerLoop", "PrefixTrie",
    "RemotePrefillFleet", "pages_for",
]
