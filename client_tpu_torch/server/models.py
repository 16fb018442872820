"""Shape bucketing shared by the engine's device calls."""


def pad_batch_bucket(rows: int, minimum: int = 1) -> int:
    """Next power-of-two bucket at or above ``rows`` (and ``minimum``):
    the engine pads batches and prompts to it, which bounds the set of
    shapes the device sees."""
    bucket = max(minimum, 1)
    while bucket < rows:
        bucket *= 2
    return bucket
