"""ShardedExecutor: the device-placement half of sharded serving.

One instance per loaded sharded model (built in ``warmup()`` beside the
sharded parameters). Per execution it:

1. pads each declared input's leading (batch) dim to the mesh's
   divisibility requirement (a batch of 1 on a ``dp=2`` mesh pads to 2 —
   the padded rows compute garbage the gather step slices back off);
2. places each input on the mesh: device ``i`` gets its block of the
   input under the declared spec (an undeclared input is replicated), so
   ``fn`` never pays an implicit host-to-device copy;
3. runs ``fn`` and waits for the mesh's cards;
4. gathers each output's blocks back into one host numpy array (one
   device-to-host copy per distinct block) and trims the padding.

Above this seam a sharded model is indistinguishable from a plain one:
``execute()`` still maps name->ndarray to name->ndarray, so every
ServerCore execution path (batcher, direct, single-async, decoupled)
serves it unchanged.

Phase timings (device_put / compute / gather) accumulate on the executor
and feed ``debug_state()``'s devices block. The clock is injectable
(``clock_ns``), as the repo's clock lint requires of this package.
"""

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from client_tpu_torch.parallel.sharding import MeshPlan
from client_tpu_torch.utils import numpy_to_tensor


def place_global(array: np.ndarray, plan: MeshPlan, spec) -> List[torch.Tensor]:
    """A host array placed on ``plan``'s mesh under ``spec`` (a declared
    name or a spec tuple): one block per device, in grid order. Blocks
    with the same index on the same device are one tensor. (The
    reference's multi-process placement collapses to this: one process
    owns every device.)"""
    array = np.asarray(array)
    placed: Dict[tuple, torch.Tensor] = {}
    blocks = []
    for device, index in zip(plan.devices, plan.shard_slices(spec, array.shape)):
        key = (device, tuple((s.start, s.stop) for s in index))
        if key not in placed:
            block = np.asarray(array[index])
            placed[key] = numpy_to_tensor(block, device).reshape(block.shape)
        blocks.append(placed[key])
    return blocks


def gather_global(blocks, plan: MeshPlan, spec) -> np.ndarray:
    """The host numpy array whose per-device blocks (grid order, as
    :func:`place_global` lays them out) are ``blocks``; each distinct
    block is read back once. A single tensor is read back as it is."""
    if torch.is_tensor(blocks):
        return blocks.detach().cpu().numpy()
    counts = plan.blocks_per_dim(spec, blocks[0].dim())
    shape = [extent * n for extent, n in zip(blocks[0].shape, counts)]
    if counts == [1] * len(counts):
        return blocks[0].detach().cpu().numpy()
    out = None
    done = set()
    for block, index in zip(blocks, plan.shard_slices(spec, shape)):
        key = tuple(s.start for s in index)
        if key in done:
            continue
        host = block.detach().cpu().numpy()
        if out is None:
            out = np.empty(shape, dtype=host.dtype)
        out[index] = host
        done.add(key)
    return out


class ShardedExecutor:
    """Runs ``fn`` under a resolved
    :class:`~client_tpu_torch.parallel.sharding.MeshPlan`.

    Parameters
    ----------
    plan:
        The resolved mesh.
    fn:
        ``fn(inputs: Dict[str, List[torch.Tensor]]) -> Dict[str,
        List[torch.Tensor]]``: each input as its per-device blocks, each
        output as its per-device blocks under the output's declared spec
        (an undeclared output: one tensor, or its replicated blocks).
        Typically a closure over the model's sharded parameters.
    clock_ns:
        Injectable monotonic clock (fake-clock tests).
    """

    def __init__(
        self,
        plan: MeshPlan,
        fn: Callable[[Dict[str, List[torch.Tensor]]], Dict[str, Any]],
        clock_ns: Callable[[], int] = time.monotonic_ns,
    ):
        self.plan = plan
        self._fn = fn
        self._clock_ns = clock_ns
        self._lock = threading.Lock()
        self._executions = 0
        self._device_put_ns = 0
        self._compute_ns = 0
        self._gather_ns = 0

    # -- placement ----------------------------------------------------------

    def _place(self, inputs: Dict[str, np.ndarray]) -> Dict[str, List[torch.Tensor]]:
        """Place every input on its declared spec (replicated when
        undeclared), padding batch dims to the mesh multiple."""
        placed: Dict[str, List[torch.Tensor]] = {}
        for name, array in inputs.items():
            array = np.asarray(array)
            multiple = self.plan.batch_multiple(name)
            if multiple > 1 and array.shape[0] % multiple:
                pad = multiple - array.shape[0] % multiple
                array = np.concatenate(
                    [array, np.zeros((pad,) + array.shape[1:], dtype=array.dtype)]
                )
            placed[name] = place_global(array, self.plan, name)
        return placed

    def _synchronize(self) -> None:
        for device in dict.fromkeys(self.plan.devices):
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    # -- execution ----------------------------------------------------------

    def __call__(
        self, inputs: Dict[str, np.ndarray], rows: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        """One sharded execution. ``rows`` (default: the leading dim of
        the first input) is the true batch size declared outputs are
        trimmed to after the gather — padding added by :meth:`_place`
        never reaches the wire."""
        if rows is None:
            rows = next(
                (int(np.shape(a)[0]) for a in inputs.values() if np.ndim(a)), 0
            )
        t0 = self._clock_ns()
        placed = self._place(inputs)
        t1 = self._clock_ns()
        with torch.inference_mode():
            raw = self._fn(placed)
        self._synchronize()
        t2 = self._clock_ns()
        outputs: Dict[str, np.ndarray] = {}
        for name, value in raw.items():
            array = gather_global(value, self.plan, name)
            if (
                rows
                and array.ndim
                and name in self.plan.spec.outputs
                and array.shape[0] > rows
            ):
                array = array[:rows]
            outputs[name] = array
        t3 = self._clock_ns()
        with self._lock:
            self._executions += 1
            self._device_put_ns += t1 - t0
            self._compute_ns += t2 - t1
            self._gather_ns += t3 - t2
        return outputs

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative phase accounting: how much of the sharded path's
        wall time is placement vs compute vs readback."""
        with self._lock:
            return {
                "executions": self._executions,
                "device_put_ns": self._device_put_ns,
                "compute_ns": self._compute_ns,
                "gather_ns": self._gather_ns,
            }
