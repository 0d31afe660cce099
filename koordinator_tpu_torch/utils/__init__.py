"""Shared utility helpers."""

import hashlib


def stable_hash(key: str) -> int:
    """Process-stable 64-bit hash (blake2b — no PYTHONHASHSEED
    dependence). THE hash for every cross-process-deterministic ranking
    in the partitioned control plane: shard routing
    (``runtime.shards.ShardMap``) and rendezvous election
    (``leaderelection.rendezvous_score``) must agree on one function,
    or determinism guarantees silently diverge."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )
