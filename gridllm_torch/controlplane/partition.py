"""Deterministic job-id → scheduler-shard partitioning.

The whole scaled control plane rests on one agreement: every member —
gateway replicas, scheduler shards, adoption logic, tests — maps a job
id to the SAME shard index with no coordination. ``shard_of`` is a
stable content hash (blake2b, not Python's seeded ``hash()``) so the
mapping survives process restarts, mixed Python versions, and replays
from durable bus state. Changing M reshuffles the space; all members of
one fleet must agree on ``num_shards`` (``GRIDLLM_SHARD_COUNT``).

``ShardContext`` is the handle the JobScheduler duck-types (it is
injected, never imported, so scheduler/ stays import-free of
controlplane/): ownership = "this member holds the bus lease for the
job's partition", fencing = "and that lease is still provably fresh".
"""

from __future__ import annotations

import hashlib
from typing import Any


def shard_of(job_id: str, num_shards: int) -> int:
    """Stable partition index of a job id in [0, num_shards)."""
    if num_shards <= 1:
        return 0
    digest = hashlib.blake2b(job_id.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "big") % num_shards


class ShardContext:
    """One scheduler shard's view of the partition space: which shards
    this member currently holds leases for, and whether those leases are
    fresh enough to act on. Backed by a ShardLeaseManager (lease.py)."""

    def __init__(self, num_shards: int, member_id: str, lease: Any):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self.member_id = member_id
        self.lease = lease

    def shard_for(self, job_id: str) -> int:
        return shard_of(job_id, self.num_shards)

    def held(self) -> list[int]:
        """Partition indices this member currently holds leases for."""
        return self.lease.held_shards()

    def owns(self, job_id: str) -> bool:
        """Partition-set membership: the job's shard is leased by this
        member (possibly stale — use fenced_job before mutating)."""
        return self.lease.holds(self.shard_for(job_id))

    def fenced_job(self, job_id: str) -> bool:
        """Lease-fenced ownership: held AND renewed within the TTL. The
        JobScheduler consults this on every mutating path; a deposed or
        partitioned shard answers False and refuses the operation."""
        return self.lease.fenced(self.shard_for(job_id))

    def identity(self) -> dict[str, Any]:
        """The shard-identity block stamped into get_stats()/admin views."""
        return {
            "role": "shard",
            "member": self.member_id,
            "shards": self.held(),
            "numShards": self.num_shards,
            "epochs": self.lease.epochs(),
        }
