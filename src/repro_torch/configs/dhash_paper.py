"""The paper's own workload as a config: a DHash service (lookup/insert/
delete batches + continuous rebuild), one shard per GPU."""
from dataclasses import dataclass


@dataclass(frozen=True)
class DHashServiceConfig:
    arch_id: str = "dhash-paper"
    backend: str = "linear"
    capacity_per_shard: int = 1 << 20     # ~1M entries per shard
    chunk: int = 4096                     # rebuild chunk (hazard buffer)
    lookups_per_step: int = 1 << 16       # per shard
    updates_per_step: int = 1 << 13       # per shard (insert + delete each)
    route_cap_factor: float = 0.0         # router cap (core/distributed.py)
    fwd_hazard: bool = False              # hazard via MIGRATED-slot forwarding


CONFIG = DHashServiceConfig()


def smoke() -> DHashServiceConfig:
    return DHashServiceConfig(capacity_per_shard=4096, chunk=256,
                              lookups_per_step=1024, updates_per_step=256)
