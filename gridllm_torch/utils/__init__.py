"""Configuration, logging, events and the bus wire types of the port."""

from gridllm_torch.utils.logging import get_logger

__all__ = ["get_logger"]
