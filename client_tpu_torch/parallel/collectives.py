"""Collectives between the shards of a mesh that one process owns.

The reference inserts these through XLA (a ``psum`` over the contracted
axis becomes an all-reduce on the interconnect, ``ppermute`` a ring
hop). In the port every shard is a tensor on a ``torch.device`` of this
process, and a collective is a reduction or a copy between them:

- :func:`all_reduce` sums one partial per shard in fp32 and casts once;
- :func:`all_gather` concatenates the shards' blocks along a dim;
- :func:`ppermute` rotates blocks around the ring of shards;
- :func:`vocab_parallel_embedding` looks tokens up in a table sharded by
  vocabulary rows.

Each returns one tensor per shard, on that shard's device. On a device
that appears more than once the shards share one result tensor (a
"replicated" tensor there is one tensor, not a copy). This module is the
one seam that a multi-process mesh swaps for ``torch.distributed``.
"""

from typing import Dict, List, Sequence

import torch


def _on_each(value: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``value`` on every device of ``devices``, one copy per distinct
    device."""
    copies: Dict[torch.device, torch.Tensor] = {value.device: value}
    out = []
    for device in devices:
        device = torch.device(device)
        if device not in copies:
            copies[device] = value.to(device)
        out.append(copies[device])
    return out


def all_reduce(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of ``parts`` (one partial per shard, all of one shape and
    dtype) on each shard's device. The sum runs in fp32 on the first
    shard's device and is cast back to the parts' dtype once, so a bf16
    model rounds once per reduction, whatever the shard count. One part
    is returned as it is."""
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} parts for {len(devices)} devices")
    if len(parts) == 1:
        return [parts[0]]
    home = torch.device(devices[0])
    total = parts[0].to(home, torch.float32)
    for part in parts[1:]:
        total = total + part.to(home, torch.float32)
    return _on_each(total.to(parts[0].dtype), devices)


def all_gather(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
               dim: int) -> List[torch.Tensor]:
    """The shards' blocks concatenated along ``dim`` (in shard order), on
    each shard's device."""
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} parts for {len(devices)} devices")
    if len(parts) == 1:
        return [parts[0]]
    home = torch.device(devices[0])
    return _on_each(torch.cat([p.to(home) for p in parts], dim=dim), devices)


def ppermute(blocks: Sequence[torch.Tensor], devices: Sequence[torch.device],
             shift: int = 1) -> List[torch.Tensor]:
    """Rotate ``blocks`` around the ring of shards: shard ``(i + shift) %
    n`` receives shard ``i``'s block, on its own device."""
    n = len(blocks)
    if n != len(devices):
        raise ValueError(f"{n} blocks for {len(devices)} devices")
    out: List[torch.Tensor] = [None] * n  # type: ignore[list-item]
    for i, block in enumerate(blocks):
        j = (i + shift) % n
        out[j] = block.to(torch.device(devices[j]))
    return out


def vocab_parallel_embedding(tables: Sequence[torch.Tensor],
                             tokens: torch.Tensor) -> List[torch.Tensor]:
    """``tokens``' rows of the embedding table whose vocabulary rows are
    split over the shards (``tables[i]`` holds rows ``i*R .. (i+1)*R``),
    on each shard's device: each shard looks up the tokens in its range
    and zeroes the others, and the shards' rows are all-reduced (every
    token is non-zero on one shard only, so the sum is exact). One table
    is an ordinary lookup."""
    if len(tables) == 1:
        return [tables[0][tokens.long()]]
    devices = [t.device for t in tables]
    rows = tables[0].shape[0]
    parts = []
    for i, (table, device) in enumerate(zip(tables, devices)):
        local = tokens.to(device).long() - i * rows
        hit = ((local >= 0) & (local < rows))[..., None]
        found = table[local.clamp(0, rows - 1)]
        parts.append(torch.where(hit, found, torch.zeros((), dtype=found.dtype, device=device)))
    return all_reduce(parts, devices)
