"""The continuous-batching inference engine."""

from gridllm_torch.engine.engine import (
    EngineConfig,
    GenerationRequest,
    GenerationResult,
    InferenceEngine,
)

__all__ = ["EngineConfig", "GenerationRequest", "GenerationResult", "InferenceEngine"]
