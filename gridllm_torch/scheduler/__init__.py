from gridllm_torch.scheduler.registry import WorkerRegistry
from gridllm_torch.scheduler.scheduler import JobScheduler

__all__ = ["WorkerRegistry", "JobScheduler"]
