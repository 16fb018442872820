"""Continuous-batching LLM serving: the engine, its KV-block allocator and
the repository model that wraps them."""
