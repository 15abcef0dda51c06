"""Worker-group runtime: the torch.distributed process group of one logical
worker.

The counterpart of the JAX package's parallel/distributed.py. There one
process drives every device of its host and `jax.distributed` joins the
hosts; here one process drives one device, so a tensor-parallel group of N
devices is N processes, each a rank of one `torch.distributed` process
group (a TCP store at the coordinator's address). The bus protocol still
sees one logical worker, spoken for by process 0, the liaison
(worker/group.py, worker/plan.py).

Env contract (all optional; absent → one process, no group):
  GRIDLLM_COORD_ADDR   host:port of process 0 (the group's TCP store)
  GRIDLLM_NUM_PROCS    total processes in the group
  GRIDLLM_PROC_ID      this process's id (0 = liaison)

The backend is the caller's choice and nothing switches it quietly: NCCL
with rank r on ``cuda:{r % device_count}``, gloo on the CPU, and gloo on
CUDA tensors only where the caller asks for it (several ranks on one
device, where NCCL refuses to put two ranks of a group).
"""

from __future__ import annotations

import dataclasses
import datetime

import torch

from gridllm_torch.utils.config import env_int, env_raw
from gridllm_torch.utils.logging import get_logger

log = get_logger("parallel.distributed")

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class GroupConfig:
    """Shape of one logical worker's process group."""

    coordinator: str | None = None   # host:port of process 0
    num_processes: int = 1
    process_id: int = 0

    @staticmethod
    def from_env() -> "GroupConfig":
        return GroupConfig(
            coordinator=env_raw("GRIDLLM_COORD_ADDR") or None,
            num_processes=env_int("GRIDLLM_NUM_PROCS"),
            process_id=env_int("GRIDLLM_PROC_ID"),
        )

    @property
    def is_group(self) -> bool:
        return self.num_processes > 1

    @property
    def is_liaison(self) -> bool:
        """Process 0 speaks the bus protocol for the whole group."""
        return self.process_id == 0


def rank_device(backend: str, rank: int, device: str | None = None) -> torch.device:
    """The device rank `rank` runs on: NCCL puts rank r on
    cuda:{r % device_count}; gloo runs on the CPU unless `device` names a
    CUDA device (gloo moves CUDA tensors through the host)."""
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA; pass backend='gloo' "
                               "to run the group on the CPU")
        return torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "gloo":
        return torch.device(device or "cpu")
    raise ValueError(f"backend {backend!r} (have {BACKENDS})")


def initialize_group(cfg: GroupConfig | None = None, backend: str = "nccl",
                     device: str | None = None,
                     timeout_s: float = 600.0) -> GroupConfig:
    """Join the group's torch.distributed process group (a no-op for one
    process) on `backend`; `device` is gloo's device (see rank_device).
    Returns the group config."""
    cfg = cfg or GroupConfig.from_env()
    if not cfg.is_group:
        return cfg
    if not cfg.coordinator:
        raise ValueError(
            "GRIDLLM_NUM_PROCS > 1 requires GRIDLLM_COORD_ADDR (host:port of "
            "process 0): a group cannot form without a coordinator")
    if not 0 <= cfg.process_id < cfg.num_processes:
        raise ValueError(f"GRIDLLM_PROC_ID={cfg.process_id} outside the group of "
                         f"{cfg.num_processes}")
    import torch.distributed as dist

    dev = rank_device(backend, cfg.process_id, device)
    kw = {"device_id": dev} if backend == "nccl" else {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{cfg.coordinator}", world_size=cfg.num_processes,
        rank=cfg.process_id, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    log.info("joined worker group", coordinator=cfg.coordinator, backend=backend,
             process=f"{cfg.process_id}/{cfg.num_processes}", device=str(dev))
    return cfg


def shutdown_group(cfg: GroupConfig) -> None:
    """Tear the process group down (a no-op for one process)."""
    if not cfg.is_group:
        return
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    try:
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 — already torn down, or a rank gone
        log.warning("distributed shutdown failed", error=str(e))
