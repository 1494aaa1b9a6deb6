"""KV memory beyond the slot rectangle: paged slot memory (``paging``), the
host-RAM prefix store (``prefix_store``) with its migration wire format
(``prefix_wire``), and the chunk-granular cache↔host movement both ride
(``kv_transfer``). The port's own copies of the JAX package's ``cache/``
modules."""

from quorum_tpu_torch.cache.prefix_store import DEFAULT_PREFIX_STORE_BYTES, PrefixStore

__all__ = ["DEFAULT_PREFIX_STORE_BYTES", "PrefixStore"]
