"""The HTTP gateway of the port (the JAX package's gateway/): the Ollama,
OpenAI and native inference surfaces, health, metrics and admin routes, the
rate limiter and model administration, in front of the port's scheduler.
The one package of the port that imports aiohttp at module level."""

from gridllm_torch.gateway.app import GatewayServer, create_app

__all__ = ["GatewayServer", "create_app"]
