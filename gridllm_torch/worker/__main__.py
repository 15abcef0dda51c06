"""``python -m gridllm_torch.worker`` — start a torch worker on the bus that
GRIDLLM_BUS_URL names (the JAX worker's environment; see worker/main.py)."""

from gridllm_torch.worker.main import main

if __name__ == "__main__":
    main()
