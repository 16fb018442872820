"""The port's proto3 runtime held to the real protobuf library.

For every message type of both ``.proto`` files, seeded random instances
(scalars at their edges: negative 32- and 64-bit integers, float32
values, empty and non-empty strings and bytes, present but empty
submessages, ``oneof`` members set to their default, maps of several
keys) are built twice, once with the JAX package's protoc classes and once
with ``client_tpu_torch.grpc._proto``. Their bytes must equal
``SerializeToString(deterministic=True)``, each side must parse the
other's bytes back to the same message, and ``as_json`` must equal
``json_format.MessageToDict(..., preserving_proto_field_name=True)``.
"""

import numpy as np
import pytest
from google.protobuf import json_format

from client_tpu.grpc._generated import grpc_service_pb2 as ref_pb
from client_tpu.grpc._generated import model_config_pb2 as ref_mc
from client_tpu_torch.grpc import _proto
from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb
from client_tpu_torch.grpc._generated import model_config_pb2 as mc

ALL_TYPES = sorted(_proto.MODULE.classes)


def _ref_class(full_name):
    parts = full_name.split(".")[1:]
    top = getattr(ref_pb, parts[0], None) or getattr(ref_mc, parts[0])
    for part in parts[1:]:
        top = getattr(top, part)
    return top


_INT_EDGES = {
    "int32": [0, 1, -1, 2**31 - 1, -(2**31), 300, -300],
    "int64": [0, 1, -1, 2**63 - 1, -(2**63), 2**40, -(2**40)],
    "uint32": [0, 1, 2**32 - 1, 127, 128, 16384],
    "uint64": [0, 1, 2**64 - 1, 2**63, 2**35],
}


def _scalar(rng, spec):
    kind = spec.kind
    if kind in _INT_EDGES:
        edges = _INT_EDGES[kind]
        return int(edges[rng.integers(len(edges))]) if rng.random() < 0.6 else int(
            rng.integers(-1000 if kind.startswith("int") else 0, 100000))
    if kind == "bool":
        return bool(rng.integers(2))
    if kind == "float":
        return float(np.float32(rng.choice([0.0, 1.5, -2.25, 0.1, 3.4e38, 1e-38,
                                            float(rng.normal())])))
    if kind == "double":
        return float(rng.choice([0.0, -0.5, 1e300, float(rng.normal()), 0.1]))
    if kind == "string":
        return rng.choice(["", "a", "héllo", "INPUT0", "x" * 200, "\x00z"])
    if kind == "bytes":
        return bytes(rng.integers(0, 256, size=int(rng.integers(0, 40)), dtype=np.uint8))
    if kind == "enum":
        values = spec.enum_type.values()
        return int(values[rng.integers(len(values))])
    raise AssertionError(kind)


def _fill(rng, ours, theirs, depth=0):
    """Set the same random fields on both messages."""
    desc = ours.DESCRIPTOR
    oneof_done = set()
    for spec in desc.fields:
        if rng.random() < 0.35:
            continue
        if spec.oneof is not None:
            if spec.oneof in oneof_done:
                continue
            oneof_done.add(spec.oneof)
        if spec.is_map:
            for _ in range(int(rng.integers(0, 4))):
                key = _scalar(rng, spec.map_key)
                if spec.map_value.kind == "message":
                    if depth < 3:
                        _fill(rng, getattr(ours, spec.name)[key],
                              getattr(theirs, spec.name)[key], depth + 1)
                else:
                    value = _scalar(rng, spec.map_value)
                    getattr(ours, spec.name)[key] = value
                    getattr(theirs, spec.name)[key] = value
        elif spec.repeated and spec.kind == "message":
            for _ in range(int(rng.integers(0, 3)) if depth < 3 else 0):
                _fill(rng, getattr(ours, spec.name).add(),
                      getattr(theirs, spec.name).add(), depth + 1)
        elif spec.repeated:
            values = [_scalar(rng, spec) for _ in range(int(rng.integers(0, 5)))]
            getattr(ours, spec.name).extend(values)
            getattr(theirs, spec.name).extend(values)
        elif spec.kind == "message":
            if depth < 3:
                getattr(ours, spec.name).SetInParent()
                getattr(theirs, spec.name).SetInParent()
                _fill(rng, getattr(ours, spec.name), getattr(theirs, spec.name), depth + 1)
        else:
            value = _scalar(rng, spec)
            if spec.oneof is not None and rng.random() < 0.3:
                value = spec.default()  # a oneof member set to its default
            setattr(ours, spec.name, value)
            setattr(theirs, spec.name, value)


def _pair(full_name, seed):
    rng = np.random.default_rng(seed)
    ours = _proto.MODULE.classes[full_name]()
    theirs = _ref_class(full_name)()
    _fill(rng, ours, theirs)
    return ours, theirs


@pytest.mark.parametrize("full_name", ALL_TYPES)
def test_serialize_equals_protobuf_deterministic(full_name):
    for seed in range(12):
        ours, theirs = _pair(full_name, seed)
        assert ours.SerializeToString() == theirs.SerializeToString(deterministic=True), seed


@pytest.mark.parametrize("full_name", ALL_TYPES)
def test_parse_round_trips_both_ways(full_name):
    cls = _proto.MODULE.classes[full_name]
    for seed in range(12):
        ours, theirs = _pair(full_name, 100 + seed)
        want = theirs.SerializeToString(deterministic=True)
        # their bytes parsed by us, and ours by them
        assert cls.FromString(want).SerializeToString() == want
        back = _ref_class(full_name)()
        back.ParseFromString(ours.SerializeToString())
        assert back == theirs


@pytest.mark.parametrize("full_name", ALL_TYPES)
def test_as_json_equals_message_to_dict(full_name):
    for seed in range(12):
        ours, theirs = _pair(full_name, 200 + seed)
        assert _proto.message_to_dict(ours) == json_format.MessageToDict(
            theirs, preserving_proto_field_name=True), seed


@pytest.mark.parametrize("case", ["unpacked_repeated", "unknown_fields", "oneof_last_wins",
                                  "map_entry_without_value"])
def test_parser_reads_what_protobuf_writes_by_hand(case):
    """Wire forms a deterministic writer never makes but a peer may send."""
    if case == "unpacked_repeated":
        # shape [3, -1] as two unpacked varints (field 3, wire type 0)
        data = b"\n\x01a\x18\x03\x18" + b"\xff" * 9 + b"\x01"
        msg = pb.ModelMetadataResponse.TensorMetadata.FromString(data)
        assert list(msg.shape) == [3, -1]
    elif case == "unknown_fields":
        theirs = ref_pb.ServerLiveResponse(live=True).SerializeToString()
        data = b"\xa8\x06\x07" + b"\xb2\x06\x02hi" + theirs + b"\xbd\x06\x00\x00\x00\x00"
        assert pb.ServerLiveResponse.FromString(data).live is True
    elif case == "oneof_last_wins":
        data = b"\x08\x01\x1a\x01x"
        msg = pb.InferParameter.FromString(data)
        assert msg.WhichOneof("parameter_choice") == "string_param"
        assert msg.string_param == "x" and not msg.bool_param
    else:
        data = b"\x22\x03\x0a\x01k"  # parameters {key: "k"}, no value
        msg = pb.ModelInferRequest.FromString(data)
        ref = ref_pb.ModelInferRequest.FromString(data)
        assert msg.SerializeToString() == ref.SerializeToString(deterministic=True)


def test_message_api_matches_generated_classes():
    ours = mc.ModelConfig(name="m", max_batch_size=8)
    theirs = ref_mc.ModelConfig(name="m", max_batch_size=8)
    for msg, mod in ((ours, mc), (theirs, ref_mc)):
        msg.input.add(name="IN", data_type=mod.DataType.Value("TYPE_FP32"), dims=[-1, 4])
        msg.model_transaction_policy.decoupled = False
        msg.sequence_batching.SetInParent()
        step = msg.ensemble_scheduling.step.add(model_name="simple", model_version=-1)
        step.input_map.update({"INPUT0": "a", "INPUT1": "b"})
        msg.parameters["mesh"].string_value = "{}"
    assert ours.WhichOneof("scheduling_choice") == theirs.WhichOneof("scheduling_choice")
    assert ours.HasField("model_transaction_policy") and not ours.HasField("version_policy")
    assert ours.SerializeToString() == theirs.SerializeToString(deterministic=True)
    assert mc.TYPE_BF16 == ref_mc.TYPE_BF16 and mc.DataType.Name(11) == "TYPE_FP32"
    assert mc.ModelInstanceGroup.KIND_TPU == ref_mc.ModelInstanceGroup.KIND_TPU
    with pytest.raises(ValueError):
        pb.ServerLiveRequest(nope=1)
    with pytest.raises(AttributeError):
        ours.input = []
