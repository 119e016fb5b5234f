from repro_torch.kvcache.paged_cache import (PagedKVCache,  # noqa: F401
                                             append_tokens, cache_create,
                                             fragmentation, gather_context,
                                             release_seqs, write_prefill)
from repro_torch.kvcache.shortcut_cache import ShortcutKVManager  # noqa: F401
