"""Horizontally scaled control plane (the JAX package's controlplane/):
N stateless gateway replicas in front of M scheduler shards, each owning
a deterministic partition of the job-id space via bus-backed leases
fenced by epoch.

Modules (import them directly — ``client``/``shard`` pull in the
scheduler, so this package ``__init__`` stays dependency-light):

- ``partition``: ``shard_of`` job-id mapping + the ``ShardContext`` the
  JobScheduler duck-types;
- ``lease``: bus-backed ownership leases (acquire/renew/adopt, epoch
  bump per transfer, self-fencing on missed renewals);
- ``client``: ``GatewaySubmitter`` — the stateless replica's scheduler
  facade (publishes on ``ctrl:submit``, awaits the durable per-job
  result/stream channels);
- ``shard``: ``SchedulerShard`` — one partition owner: full scheduler +
  lease manager + submission fan-in + failover adoption;
- ``status``: ``StatusPublisher``/``FleetView`` — the thin aggregation
  layer behind the fleet-wide ``/metrics``, ``/admin/slo``,
  ``/admin/dump``, and ``/health/workers`` views.

Run a shard process with ``python -m gridllm_torch.controlplane``; run
gateway replicas with ``GRIDLLM_CONTROLPLANE=gateway python -m
gridllm_torch.gateway``.
"""

from gridllm_torch.controlplane.partition import ShardContext, shard_of

__all__ = ["ShardContext", "shard_of"]
