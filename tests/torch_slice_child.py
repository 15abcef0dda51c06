"""One process of a two-process torch worker group, for
tests/test_torch_multihost.py: `gridllm_torch.worker.main.run` on gloo on
the CPU, with the group and the worker set up by the environment
(GRIDLLM_NUM_PROCS, GRIDLLM_PROC_ID, GRIDLLM_COORD_ADDR,
GRIDLLM_MESH_SHAPE, GRIDLLM_BUS_URL, GRIDLLM_MODELS, WORKER_ID, ...).

    python tests/torch_slice_child.py
"""

import asyncio
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gridllm_torch.worker.main import run  # noqa: E402

if __name__ == "__main__":
    asyncio.run(run(backend="gloo", device="cpu"))
