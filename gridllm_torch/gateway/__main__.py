"""``python -m gridllm_torch.gateway``: the gateway server, a local
scheduler or, with ``GRIDLLM_CONTROLPLANE=gateway``, a stateless replica
in front of the scheduler shards (the bus, host and port come from the
environment, see utils/config.py load_config)."""

from gridllm_torch.gateway.app import main

if __name__ == "__main__":  # pragma: no cover
    main()
