"""Continuous-batching LLM serving: the engine, its KV-block allocator, the
draft proposers of speculative decoding and the repository model that
wraps them."""

from client_tpu_torch.llm.engine import (
    EngineConfig,
    EngineRecoveringError,
    LlmEngine,
    Sequence,
)
from client_tpu_torch.llm.kv_cache import (
    TRASH_BLOCK,
    BlockAllocator,
    CacheCapacityError,
)
from client_tpu_torch.llm.speculation import (
    DraftModelProposer,
    NgramProposer,
    build_proposer,
)

__all__ = [
    "BlockAllocator",
    "CacheCapacityError",
    "DraftModelProposer",
    "EngineConfig",
    "EngineRecoveringError",
    "LlmEngine",
    "NgramProposer",
    "Sequence",
    "TRASH_BLOCK",
    "build_proposer",
]
