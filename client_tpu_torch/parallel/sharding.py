"""Declare-and-validate layer for sharded (multi-device) serving.

A repository model opts into multi-device execution by declaring a mesh
on the class (the serving twin of the ``param_specs`` convention the
model zoo follows)::

    class MyModel(Model):
        mesh = {
            "axes": {"dp": 2, "tp": 2},           # ordered; dp*tp devices
            "inputs": {"INPUT_IDS": ["dp", None]},  # spec per input
            "outputs": {"EMBEDDING": ["dp", None]},
        }

At load time the declaration is parsed into a :class:`MeshSpec` (pure
validation, no device touched) and resolved against a list of
``torch.device`` into a :class:`MeshPlan`: the devices laid out as a grid
in axis order. Resolution failures are *load* failures with
operator-grade reasons ("mesh requires 4 devices, host has 1"), surfaced
through the repository index (state UNAVAILABLE, reason ``load failed:
...``) instead of a 500 at first infer.

Spec entries follow the reference's ``PartitionSpec`` form: each element
of an input/output spec is ``None`` (a replicated dim), an axis name, or
a list of axis names (a dim sharded over several axes). A sharded tensor
is a list of per-device blocks in grid order; :meth:`MeshPlan.shard_slices`
says which block of a tensor each device holds.

One process owns the whole mesh, unless the process is a pod member
(``client_tpu_torch.pod``): then a mesh resolved without an explicit
device list spans the pod's global device list, each process holds the
shards of its own positions, and the plan carries the
``torch.distributed`` group its collectives run over. A device may
appear more than once in an explicit device list: its shards then share
the card and run in turn on its current stream.
"""

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from client_tpu_torch.utils import InferenceServerException, resolve_device

SpecEntry = Any  # None | str | tuple of str (post-validation)


class MeshDeclarationError(ValueError):
    """The model's ``mesh`` declaration is malformed (a config bug —
    distinct from :class:`MeshUnavailableError`, which is a property of
    the host the model landed on)."""


class MeshUnavailableError(ValueError):
    """The declared mesh cannot be built on this host. ``str(exc)`` is
    the canonical operator-facing reason (``"mesh requires N devices,
    host has M"``) that rides into the repository index verbatim."""


def _validate_spec(
    name: str, spec: Any, axes: Dict[str, int], kind: str
) -> Tuple[SpecEntry, ...]:
    """One input/output PartitionSpec declaration -> normalized tuple."""
    if not isinstance(spec, (list, tuple)):
        raise MeshDeclarationError(
            f"mesh {kind} spec for '{name}' must be a list of dims "
            f"(got {type(spec).__name__})"
        )
    normalized: List[SpecEntry] = []
    for dim, entry in enumerate(spec):
        if entry is None:
            normalized.append(None)
            continue
        parts = entry if isinstance(entry, (list, tuple)) else (entry,)
        for axis in parts:
            if not isinstance(axis, str) or axis not in axes:
                raise MeshDeclarationError(
                    f"mesh {kind} spec for '{name}' dim {dim} names "
                    f"unknown axis {axis!r} (declared axes: "
                    f"{sorted(axes)})"
                )
        normalized.append(
            tuple(parts) if isinstance(entry, (list, tuple)) else entry
        )
    return tuple(normalized)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A validated mesh declaration (no devices touched yet).

    ``axes`` preserves declaration order — it becomes the mesh's axis
    order, so the declaring model controls which axis is innermost.
    """

    axes: Tuple[Tuple[str, int], ...]
    inputs: Dict[str, Tuple[SpecEntry, ...]]
    outputs: Dict[str, Tuple[SpecEntry, ...]]

    @property
    def device_count(self) -> int:
        n = 1
        for _name, size in self.axes:
            n *= size
        return n

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    @staticmethod
    def parse(declaration: Any) -> "MeshSpec":
        """Validate a raw ``model.mesh`` dict; raises
        :class:`MeshDeclarationError` with the first problem found."""
        if not isinstance(declaration, dict):
            raise MeshDeclarationError(
                f"mesh declaration must be a dict, got "
                f"{type(declaration).__name__}"
            )
        axes_raw = declaration.get("axes")
        if not isinstance(axes_raw, dict) or not axes_raw:
            raise MeshDeclarationError(
                "mesh declaration needs a non-empty 'axes' dict "
                '(e.g. {"axes": {"dp": 2, "tp": 2}})'
            )
        axes: List[Tuple[str, int]] = []
        for name, size in axes_raw.items():
            if not isinstance(name, str) or not name:
                raise MeshDeclarationError(
                    f"mesh axis names must be strings, got {name!r}"
                )
            if isinstance(size, bool) or not isinstance(size, int) or size < 1:
                raise MeshDeclarationError(
                    f"mesh axis '{name}' size must be a positive int, "
                    f"got {size!r}"
                )
            axes.append((name, size))
        axis_sizes = dict(axes)
        unknown = set(declaration) - {"axes", "inputs", "outputs"}
        if unknown:
            raise MeshDeclarationError(
                f"unknown mesh declaration key(s): {sorted(unknown)}"
            )
        inputs = {
            name: _validate_spec(name, spec, axis_sizes, "input")
            for name, spec in (declaration.get("inputs") or {}).items()
        }
        outputs = {
            name: _validate_spec(name, spec, axis_sizes, "output")
            for name, spec in (declaration.get("outputs") or {}).items()
        }
        return MeshSpec(axes=tuple(axes), inputs=inputs, outputs=outputs)


def device_label(device: torch.device) -> str:
    """The metric/debug label of a resolved device: ``cuda:N`` or its
    type (``cpu``), as the server's per-device metrics spell it."""
    if device.type == "cuda":
        return f"cuda:{device.index}"
    return device.type


@dataclasses.dataclass
class MeshPlan:
    """A :class:`MeshSpec` resolved against devices: ``devices`` is the
    grid flattened in axis order (the last axis innermost), and the
    topology description the metadata/debug surfaces serve."""

    spec: MeshSpec
    devices: Tuple[torch.device, ...]
    #: pod topology: how many OS processes the mesh's devices span and
    #: how many of them this process holds
    process_count: int = 1
    local_device_count: int = -1  # -1: single-process, all devices local
    #: the pod process that holds each device (empty: this process holds
    #: them all), this process's index, and the group that spans them
    owners: Tuple[int, ...] = ()
    process_index: int = 0
    group: Any = None

    @property
    def spans_processes(self) -> bool:
        """True when the mesh crosses process boundaries: its devices
        belong to several pod members."""
        return self.process_count > 1

    @property
    def local_indices(self) -> List[int]:
        """The flat indices of the devices this process holds."""
        if not self.owners:
            return list(range(len(self.devices)))
        return [i for i, owner in enumerate(self.owners) if owner == self.process_index]

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        """The devices this process holds, in grid order."""
        return tuple(self.devices[i] for i in self.local_indices)

    @property
    def device_labels(self) -> Tuple[str, ...]:
        """Per-device metric/debug labels, in grid order (a repeated
        device repeats its label)."""
        return tuple(device_label(d) for d in self.devices)

    def axis_size(self, axis: str) -> int:
        """The size of ``axis`` (1 for an axis the mesh does not have)."""
        return self.spec.axis_sizes.get(axis, 1)

    def coords(self, index: int) -> Dict[str, int]:
        """Grid coordinates of flat device ``index``, by axis name."""
        names = [name for name, _ in self.spec.axes]
        sizes = [size for _, size in self.spec.axes]
        return dict(zip(names, (int(c) for c in np.unravel_index(index, sizes))))

    def groups(self, axis: str) -> List[List[int]]:
        """The flat device indices along ``axis``, one list per setting of
        the other axes (each list in ``axis`` order): the devices one
        collective over ``axis`` spans."""
        names = [name for name, _ in self.spec.axes]
        sizes = [size for _, size in self.spec.axes]
        grid = np.arange(len(self.devices)).reshape(sizes)
        if axis not in names:
            return [[int(i)] for i in grid.reshape(-1)]
        moved = np.moveaxis(grid, names.index(axis), -1)
        return [[int(i) for i in row] for row in moved.reshape(-1, moved.shape[-1])]

    def batch_multiple(self, name: str) -> int:
        """The divisibility requirement the executor pads an input's
        leading (batch) dim to: the product of axis sizes sharding dim 0
        (1 when dim 0 is replicated or the input is undeclared)."""
        spec = self.spec.inputs.get(name)
        if not spec or spec[0] is None:
            return 1
        parts = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        sizes = self.spec.axis_sizes
        multiple = 1
        for axis in parts:
            multiple *= sizes[axis]
        return multiple

    def _spec(self, spec: Union[str, Sequence[SpecEntry]], ndim: int) -> Tuple[SpecEntry, ...]:
        """``spec`` (a declared name, or a spec) padded with ``None`` to
        ``ndim`` dims; an undeclared name replicates."""
        if isinstance(spec, str):
            spec = self.spec.inputs.get(spec, self.spec.outputs.get(spec, ()))
        return tuple(spec) + (None,) * (ndim - len(spec))

    def blocks_per_dim(self, spec: Union[str, Sequence[SpecEntry]], ndim: int) -> List[int]:
        """How many blocks each dim of a tensor splits into under ``spec``."""
        return [
            1 if entry is None else math.prod(
                self.axis_size(a) for a in (entry if isinstance(entry, tuple) else (entry,)))
            for entry in self._spec(spec, ndim)
        ]

    def shard_slices(
        self, spec: Union[str, Sequence[SpecEntry]], shape: Sequence[int]
    ) -> List[Tuple[slice, ...]]:
        """Per device (grid order), the index of its block of a tensor of
        ``shape`` under ``spec``: an input or output name the plan
        declares, or a spec tuple. A dim sharded over axes ``(a, b)``
        splits into ``size(a) * size(b)`` equal blocks, ``a`` major; a
        dim that does not divide raises ``ValueError``. An undeclared
        name replicates, and an axis the plan does not have has size 1
        (as :meth:`axis_size`), so a model's specs cut over any plan."""
        spec = self._spec(spec, len(shape))
        result = []
        for index in range(len(self.devices)):
            coords = self.coords(index)
            block = []
            for dim, (entry, extent) in enumerate(zip(spec, shape)):
                if entry is None:
                    block.append(slice(None))
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                parts = math.prod(self.axis_size(a) for a in axes)
                if extent % parts:
                    raise ValueError(
                        f"dim {dim} of size {extent} does not split into "
                        f"{parts} shards over {list(axes)}"
                    )
                position = 0
                for a in axes:
                    position = position * self.axis_size(a) + coords.get(a, 0)
                step = extent // parts
                block.append(slice(position * step, (position + 1) * step))
            result.append(tuple(block))
        return result

    def describe(self) -> Dict[str, Any]:
        """The topology block metadata/debug surfaces serve: axes, the
        devices the model occupies, and the declared shardings."""

        def _spec_doc(spec: Tuple[SpecEntry, ...]) -> List[Any]:
            return [
                list(entry) if isinstance(entry, tuple) else entry
                for entry in spec
            ]

        local = self.local_device_count
        if local < 0:
            local = len(self.devices)
        return {
            "axes": {name: size for name, size in self.spec.axes},
            "device_count": len(self.devices),
            "devices": list(self.device_labels),
            "process_count": self.process_count,
            "local_device_count": local,
            "spans_processes": self.spans_processes,
            "inputs": {
                name: _spec_doc(spec)
                for name, spec in self.spec.inputs.items()
            },
            "outputs": {
                name: _spec_doc(spec)
                for name, spec in self.spec.outputs.items()
            },
        }


def shard_tree(tree: Any, specs: Any, plan: MeshPlan) -> List[Any]:
    """A tree (dicts and lists) of tensors cut per ``specs`` (its twin
    tree of spec tuples) over the devices of ``plan`` that this process
    holds: one tree per such device, each tensor its block, contiguous,
    on that device, as a :class:`~client_tpu_torch.parallel.collectives.ShardList`
    carrying the plan's process group. Devices with the same block share
    one tensor, and a replicated tensor on the device it lives on is that
    tensor, not a copy — except under a plan that spans processes, whose
    blocks are copies, so that dropping the unsharded tree frees it."""
    from client_tpu_torch.parallel.collectives import ShardList

    local = plan.local_indices
    n = len(local)
    copy = plan.spans_processes
    cut: Dict[tuple, torch.Tensor] = {}

    def walk(node, spec):
        if isinstance(node, dict):
            parts = {key: walk(value, spec[key]) for key, value in node.items()}
            return [{key: value[i] for key, value in parts.items()} for i in range(n)]
        if isinstance(node, (list, tuple)):
            parts = [walk(value, s) for value, s in zip(node, spec)]
            return [[value[i] for value in parts] for i in range(n)]
        blocks = []
        slices = plan.shard_slices(spec, node.shape)
        for i in local:
            device, index = plan.devices[i], slices[i]
            key = (id(node), device, tuple((s.start, s.stop) for s in index))
            if key not in cut:
                cut[key] = node[index].to(device, copy=copy).contiguous()
            blocks.append(cut[key])
        return blocks

    return ShardList(walk(tree, specs), plan.group)


def mesh_devices(device=None, devices=None):
    """A sharded model's ``(device, devices)``: ``devices`` (an explicit
    mesh device list, or None for the host's) as ``torch.device`` s, and
    ``device`` resolved, defaulting to the first of ``devices``."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if device is None and devices:
            device = devices[0]
    return resolve_device(device), devices


def host_devices(device=None) -> List[torch.device]:
    """The devices a mesh resolves against by default: every card of the
    process (``cuda:0`` … ``cuda:N-1``), or the one CPU when ``device``
    (the caller's device; ``cuda`` by default, which raises without a
    card) is the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve(spec: MeshSpec, devices: Optional[Sequence] = None,
            device=None) -> MeshPlan:
    """Build the :class:`MeshPlan` for ``spec`` over ``devices`` (default:
    the pod's global device list in a pod member, else
    :func:`host_devices` of ``device``). An explicit list may repeat a
    device, and is this process's alone. Raises
    :class:`MeshUnavailableError` with the canonical reason when there
    are too few devices, or when a pod mesh would leave out a member."""
    from client_tpu_torch.pod.runtime import current

    pod = current() if devices is None else None
    owners: Tuple[int, ...] = ()
    if pod is not None:
        devices, owners = pod.devices, pod.owners
    elif devices is None:
        devices = host_devices(device)
    needed = spec.device_count
    if len(devices) < needed:
        # pod members append their topology, so "host has 2" reads as
        # "2 of the pod's devices"
        msg = f"mesh requires {needed} devices, host has {len(devices)}"
        if pod is not None and pod.process_count > 1:
            msg += (
                f" (pod of {pod.process_count} processes, "
                f"{pod.local_device_count} devices local to this one)"
            )
        raise MeshUnavailableError(msg)
    used = []
    for d in devices[:needed]:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        used.append(d)
    if pod is None:
        return MeshPlan(spec=spec, devices=tuple(used), local_device_count=needed)
    owners = tuple(owners[:needed])
    spanned = len(set(owners))
    if 1 < spanned < pod.process_count:
        raise MeshUnavailableError(
            f"mesh of {needed} devices spans {spanned} of the pod's "
            f"{pod.process_count} processes; a pod mesh spans every member"
        )
    group = None
    if spanned > 1:
        import torch.distributed as dist

        group = dist.group.WORLD
    return MeshPlan(
        spec=spec, devices=tuple(used), process_count=spanned,
        local_device_count=sum(1 for o in owners if o == pod.process_index),
        owners=owners, process_index=pod.process_index, group=group,
    )


def plan_for_model(model, devices: Optional[Sequence] = None) -> Optional[MeshPlan]:
    """Resolve a repository model's ``mesh`` declaration (None when the
    model declares none) against ``devices`` (default: the host's devices
    of the model's ``device``). Raises :class:`InferenceServerException`
    — which the repository load path records as ``load failed: <reason>``
    — on a malformed declaration or an unsatisfiable mesh, so a model
    that cannot execute is UNAVAILABLE at load time, never a 500 at
    first infer."""
    declaration = getattr(model, "mesh", None)
    if declaration is None:
        return None
    try:
        spec = MeshSpec.parse(declaration)
        return resolve(spec, devices, getattr(model, "device", None))
    except (MeshDeclarationError, MeshUnavailableError) as e:
        raise InferenceServerException(str(e)) from e
