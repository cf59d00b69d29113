"""The serving path of the port: the paged KV cache over a DHash page
table (``kvcache``), the prefix cache and its eviction policy
(``prefix_cache``, ``eviction``) and the continuous-batching engine
(``engine``)."""
