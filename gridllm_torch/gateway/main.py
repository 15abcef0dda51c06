"""Console-script entry for the gateway server."""

from gridllm_torch.gateway.app import main

if __name__ == "__main__":  # pragma: no cover
    main()
