"""The torch worker runtime: the JAX package's worker/ on the port's
engine (registration, heartbeats, job execution, streaming)."""

from gridllm_torch.worker.service import WorkerService

__all__ = ["WorkerService"]
