"""The port's shared-memory data plane against the JAX package's, on the CPU.

- Client modules: a system region one package creates the other maps by
  its key; a TPU region's raw handle is the same JSON document; writes past
  a region's end and ``create_only`` conflicts fail alike; torch tensors
  staged by the port read back through the JAX package's functions.
- Server manager: the port's ``SharedMemoryManager`` and the JAX one give
  the same status documents and the same errors for conflicts, bounds,
  kinds and malformed handles.
- Servers: the port's (``ServerCore`` + HTTP front-end) and the JAX
  ``InProcessServer``, both on the CPU, answer the same
  ``client_tpu.http`` requests alike: ``simple`` and ``identity_fp32``
  with inputs and outputs in system and TPU regions (made by either
  package), the small ``image_classifier`` (ResNet18Thin at 64 x 64 on the
  same seed-0 weights) with a TPU-shm input and ``class_count=3``, the
  status lists, unregister semantics, the ``cuda`` refusal and a
  too-small output region. An output asked for in a region is found there
  and not inline. In the port's dynamic batch each request writes its own
  rows into its own region.

Every region key and name carries a ``uuid``: test files run in parallel
processes that share ``/dev/shm``.
"""

import asyncio
import json
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import client_tpu.http as httpclient
from client_tpu.models import resnet as jax_resnet
from client_tpu.models.serving import ImageClassifierModel as JaxImageClassifierModel
from client_tpu.server import shm as jax_server_shm
from client_tpu.testing import InProcessServer
from client_tpu.utils import InferenceServerException as ClientError
from client_tpu.utils import shared_memory as jax_shm
from client_tpu.utils import tpu_shared_memory as jax_tpushm
from client_tpu_torch.models import resnet
from client_tpu_torch.models.serving import ImageClassifierModel
from client_tpu_torch.server import shm as port_server_shm
from client_tpu_torch.server.core import CoreRequest, CoreRequestedOutput, ServerCore
from client_tpu_torch.server.model_repository import ModelRepository
from client_tpu_torch.server.models import AddSubModel, register_builtin_models
from client_tpu_torch.utils import InferenceServerException, bfloat16
from client_tpu_torch.utils import shared_memory as shm
from client_tpu_torch.utils import tpu_shared_memory as tpushm
from test_torch_kserve import PortServer

torch.set_num_threads(1)

IMAGE_SIZE = 64
MAKERS = {"port": (shm, tpushm), "jax": (jax_shm, jax_tpushm)}


def _tag():
    return uuid.uuid4().hex[:16]


class _Regions:
    """Regions made by one package's client modules, destroyed on close."""

    def __init__(self, maker):
        self.system, self.tpu = MAKERS[maker]
        self.made = []

    def create(self, kind, name, size):
        if kind == "system":
            handle = self.system.create_shared_memory_region(name, f"ctt_{name}", size)
        else:
            handle = self.tpu.create_shared_memory_region(name, size)
        self.made.append((kind, handle))
        return handle

    def write(self, kind, handle, arrays):
        (self.system if kind == "system" else self.tpu).set_shared_memory_region(handle, arrays)

    def close(self):
        for kind, handle in self.made:
            (self.system if kind == "system" else self.tpu).destroy_shared_memory_region(handle)


def _register(client, kind, handle):
    if kind == "system":
        client.register_system_shared_memory(handle.name(), handle.key(), handle.byte_size())
    else:
        raw = (tpushm if isinstance(handle, tpushm.TpuSharedMemoryRegion)
               else jax_tpushm).get_raw_handle(handle)
        client.register_tpu_shared_memory(handle.name(), raw, 0, handle.byte_size())


def _unregister(client, kind, name=""):
    getattr(client, f"unregister_{kind}_shared_memory")(name)


class _SeededJaxClassifier(JaxImageClassifierModel):
    """The reference's small ``image_classifier`` on the given seed-0
    variables: its own warmup draws the same weights through an unjitted
    init that takes 15 s on a CPU."""

    def __init__(self, variables):
        super().__init__("image_classifier", image_size=IMAGE_SIZE, small=True)
        self._given = variables

    def warmup(self):
        self._variables = self._given
        self._apply = jax_resnet.make_apply_fn(jax_resnet.ResNet18Thin(1000))
        dummy = np.zeros([1, IMAGE_SIZE, IMAGE_SIZE, 3], np.float32)
        jax.block_until_ready(self._apply(self._variables, dummy))


@pytest.fixture(scope="module")
def servers():
    model = jax_resnet.ResNet18Thin(1000)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, IMAGE_SIZE, IMAGE_SIZE, 3), jnp.float32))
    variables = jax.tree.map(np.asarray, variables)
    reference = InProcessServer(grpc=False).start()
    reference.core.repository.add_model(_SeededJaxClassifier(variables))
    repository = ModelRepository()
    register_builtin_models(repository, device="cpu")
    config = resnet.resnet18_thin()
    repository.add_model(ImageClassifierModel(
        image_size=IMAGE_SIZE, config=config,
        params=resnet.params_from_jax(variables, config, "cpu"), device="cpu"))
    port = PortServer(repository)
    clients = {"jax": httpclient.InferenceServerClient(reference.http_url),
               "torch": httpclient.InferenceServerClient(f"127.0.0.1:{port.port}")}
    yield clients
    for client in clients.values():
        client.close()
    port.close()
    reference.stop()


# ---------------------------------------------------------------------------
# client modules
# ---------------------------------------------------------------------------


def test_system_regions_map_across_packages():
    tag = _tag()
    data = np.arange(32, dtype=np.float32)
    ours = shm.create_shared_memory_region(f"a_{tag}", f"ctt_a_{tag}", 256, create_only=True)
    try:
        shm.set_shared_memory_region(ours, [data])
        theirs = jax_shm.create_shared_memory_region(f"b_{tag}", f"ctt_a_{tag}", 256)
        try:
            np.testing.assert_array_equal(
                jax_shm.get_contents_as_numpy(theirs, np.float32, [32]), data)
            # a BYTES read runs to the region's end: the 15 serialized bytes
            # fill its last 15
            strings = np.array([b"x", b"", "é".encode()], dtype=object)
            jax_shm.set_shared_memory_region(theirs, [strings], offset=256 - 15)
            assert list(shm.get_contents_as_numpy(ours, np.object_, [3], offset=256 - 15)) == \
                list(strings)
            assert f"a_{tag}" in shm.mapped_shared_memory_regions()
        finally:
            jax_shm.destroy_shared_memory_region(theirs)
    finally:
        shm.destroy_shared_memory_region(ours)
    assert f"a_{tag}" not in shm.mapped_shared_memory_regions()


def test_tpu_raw_handles_are_the_same_document():
    tag = _tag()
    ours = tpushm.create_shared_memory_region(f"t_{tag}", 96, device_id=1)
    theirs = jax_tpushm.create_shared_memory_region(f"u_{tag}", 96, device_id=1)
    try:
        doc, ref = (json.loads(m.get_raw_handle(h)) for m, h in
                    ((tpushm, ours), (jax_tpushm, theirs)))
        assert doc.keys() == ref.keys() and doc["kind"] == ref["kind"] == "tpu-host-pinned"
        assert (doc["byte_size"], doc["device_id"]) == (ref["byte_size"], ref["device_id"])
        assert doc["shm_key"] == ours.key() and doc["shm_key"].startswith("client_tpu_shm_")
        # each package reads what the other wrote, through either handle
        values = np.random.default_rng(0).normal(size=[12]).astype(np.float32)
        tpushm.set_shared_memory_region(ours, [values.astype(bfloat16)])
        np.testing.assert_array_equal(
            jax_tpushm.get_contents_as_numpy(ours, "BF16", [12]).astype(np.float32),
            values.astype(bfloat16).astype(np.float32))
        jax_tpushm.set_shared_memory_region(theirs, [values])
        np.testing.assert_array_equal(tpushm.get_contents_as_numpy(theirs, "FP32", [12]),
                                      values)
        assert f"t_{tag}" in tpushm.allocated_shared_memory_regions()
    finally:
        tpushm.destroy_shared_memory_region(ours)
        jax_tpushm.destroy_shared_memory_region(theirs)
    assert f"t_{tag}" not in tpushm.allocated_shared_memory_regions()


def test_client_bound_and_conflict_errors_match():
    tag = _tag()
    errors = []
    for module in (shm, jax_shm):
        region = module.create_shared_memory_region(f"c_{tag}", f"ctt_c_{tag}", 16,
                                                    create_only=True)
        try:
            with pytest.raises(module.SharedMemoryException) as conflict:
                module.create_shared_memory_region(f"d_{tag}", f"ctt_c_{tag}", 16,
                                                   create_only=True)
            with pytest.raises(module.SharedMemoryException) as past_end:
                module.set_shared_memory_region(region, [np.zeros(5, np.float32)])
            with pytest.raises(module.SharedMemoryException) as not_a_list:
                module.set_shared_memory_region(region, np.zeros(2, np.float32))
            errors.append((str(conflict.value), str(past_end.value), str(not_a_list.value)))
        finally:
            module.destroy_shared_memory_region(region)
    assert errors[0] == errors[1]
    errors = []
    for module in (tpushm, jax_tpushm):
        region = module.create_shared_memory_region(f"e_{tag}", 16)
        try:
            with pytest.raises(Exception) as past_end:
                module.set_shared_memory_region(region, [np.zeros(5, np.float32)])
            with pytest.raises(Exception) as not_a_list:
                module.set_shared_memory_region(region, np.zeros(2, np.float32))
            errors.append([(type(e.value).__name__, str(e.value))
                           for e in (past_end, not_a_list)])
        finally:
            module.destroy_shared_memory_region(region)
    assert errors[0] == errors[1]
    assert errors[0][0][0] == "SharedMemoryException"
    assert errors[0][1][0] == "TpuSharedMemoryException"


def test_torch_staging_reads_back_through_the_jax_functions():
    """Host torch tensors (and DLPack exporters) staged by the port land
    back to back; ``as_shared_memory_tensor`` is a zero-copy view and
    ``as_torch_tensor`` a copy on the asked-for device."""
    region = tpushm.create_shared_memory_region(f"s_{_tag()}", 64)
    try:
        a = torch.arange(6, dtype=torch.float32)
        b = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
        c = np.array([7, -8], dtype=np.int32)
        tpushm.set_shared_memory_region_from_torch(region, [a, b])
        tpushm.set_shared_memory_region_from_dlpack(region, [c], offset=30)
        np.testing.assert_array_equal(jax_tpushm.get_contents_as_numpy(region, "FP32", [6]),
                                      a.numpy())
        np.testing.assert_array_equal(
            jax_tpushm.get_contents_as_numpy(region, "BF16", [3], offset=24)
            .astype(np.float32), b.float().numpy())
        np.testing.assert_array_equal(jax_tpushm.get_contents_as_numpy(region, "INT32", [2],
                                                                      offset=30), c)
        view = tpushm.as_shared_memory_tensor(region, "FP32", [2, 3])
        copy = tpushm.as_torch_tensor(region, "FP32", [2, 3], device="cpu")
        tpushm.set_shared_memory_region(region, [np.full(6, 9.0, np.float32)])
        assert torch.all(view == 9.0) and torch.equal(copy, a.reshape(2, 3))
        assert torch.equal(torch.from_dlpack(view), view)
        assert tpushm.as_shared_memory_tensor(region, "BF16", [3], offset=24).dtype == \
            torch.bfloat16
        with pytest.raises(InferenceServerException, match="DLPack"):
            tpushm.as_shared_memory_tensor(region, "BYTES", [1])
        with pytest.raises(shm.SharedMemoryException, match="beyond its size"):
            tpushm.set_shared_memory_region_from_torch(region, [torch.zeros(17)])
        del view
    finally:
        tpushm.destroy_shared_memory_region(region)


# ---------------------------------------------------------------------------
# the server-side manager
# ---------------------------------------------------------------------------


def _manager_outcomes(module, key, tpu_key):
    """What one package's SharedMemoryManager says to the same sequence of
    calls: error messages or results, in order."""
    manager = module.SharedMemoryManager()
    handle = json.dumps({"kind": "tpu-host-pinned", "shm_key": tpu_key,
                         "byte_size": 64, "device_id": 0}).encode()
    calls = [
        lambda: manager.register_system("r", key, 0, 32),
        lambda: manager.register_system("r", key, 0, 32),  # idempotent
        lambda: manager.register_system("r", key, 8, 32),  # conflict
        lambda: manager.register_system("big", key, 40, 32),  # past the file's end
        lambda: manager.register_tpu("t", handle, 0, 64),
        lambda: manager.register_tpu("t2", handle, 0, 65),  # over the handle's size
        lambda: manager.register_tpu("t3", b"not json", 0, 8),
        lambda: manager.register_tpu("t4", b'{"byte_size": 8}', 0, 8),
        lambda: manager.status("system"),
        lambda: manager.status("tpu"),
        lambda: manager.status("tpu", "t"),
        lambda: bytes(manager.read("r", 4, 8)),
        lambda: manager.read("r", 30, 8),  # past the region
        lambda: manager.read("nope", 0, 1),
        lambda: manager.write("t", 60, b"12345"),
        lambda: manager.unregister("nope"),
        lambda: manager.unregister("r", kind="tpu"),
        lambda: manager.unregister_all(kind="system"),
        lambda: manager.status("system"),
        lambda: manager.unregister_all(),
        lambda: manager.status("tpu"),
    ]
    outcomes = []
    for call in calls:
        try:
            outcomes.append(("ok", call()))
        except Exception as e:  # noqa: BLE001 - the outcome under comparison
            outcomes.append(("error", str(e).split(":")[0]))
    return outcomes


def test_server_managers_agree():
    tag = _tag()
    sys_region = shm.create_shared_memory_region(f"m_{tag}", f"ctt_m_{tag}", 64,
                                                 create_only=True)
    tpu_region = tpushm.create_shared_memory_region(f"n_{tag}", 64)
    try:
        shm.set_shared_memory_region(sys_region, [np.arange(16, dtype=np.int32)])
        ours = _manager_outcomes(port_server_shm, sys_region.key(), tpu_region.key())
        theirs = _manager_outcomes(jax_server_shm, sys_region.key(), tpu_region.key())
    finally:
        shm.destroy_shared_memory_region(sys_region)
        tpushm.destroy_shared_memory_region(tpu_region)
    assert ours == theirs
    assert [kind for kind, _ in ours].count("error") == 9
    assert ours[11] == ("ok", np.arange(1, 3, dtype=np.int32).tobytes())


# ---------------------------------------------------------------------------
# the two servers over client_tpu.http
# ---------------------------------------------------------------------------


CASES = {
    "simple": (lambda rng: [("INPUT0", rng.integers(-99, 99, [1, 16], dtype=np.int32), "INT32"),
                            ("INPUT1", rng.integers(-99, 99, [1, 16], dtype=np.int32), "INT32")],
               ["OUTPUT0", "OUTPUT1"]),
    "identity_fp32": (lambda rng: [("INPUT0", rng.normal(size=[16]).astype(np.float32),
                                    "FP32")], ["OUTPUT0"]),
}


@pytest.mark.parametrize("maker", sorted(MAKERS))
@pytest.mark.parametrize("kind", ["system", "tpu"])
@pytest.mark.parametrize("model", sorted(CASES))
def test_shm_inputs_and_outputs_answer_as_the_jax_server(servers, model, kind, maker):
    """Inputs in one region (back to back), outputs in another at an
    offset: both servers write the same bytes into their output regions,
    send no inline data for them and the same output parameters."""
    make_inputs, output_names = CASES[model]
    arrays = make_inputs(np.random.default_rng(hash((model, kind, maker)) % 2**32))
    nbytes = [a.nbytes for _, a, _ in arrays]
    tag = _tag()
    regions = _Regions(maker)
    responses, written = {}, {}
    try:
        source = regions.create(kind, f"in_{tag}", sum(nbytes))
        regions.write(kind, source, [a for _, a, _ in arrays])
        for side, client in servers.items():
            target = regions.create(kind, f"out_{side}_{tag}", 8 + 64 * len(output_names))
            _register(client, kind, source)
            # the same region name on both servers, each backed by its own
            client_name = f"out_{tag}"
            if kind == "system":
                client.register_system_shared_memory(client_name, target.key(),
                                                     target.byte_size())
            else:
                raw = (tpushm if maker == "port" else jax_tpushm).get_raw_handle(target)
                client.register_tpu_shared_memory(client_name, raw, 0, target.byte_size())
            inputs, offset = [], 0
            for (name, array, datatype), size in zip(arrays, nbytes):
                tensor = httpclient.InferInput(name, list(array.shape), datatype)
                tensor.set_shared_memory(source.name(), size, offset=offset)
                inputs.append(tensor)
                offset += size
            outputs = []
            for i, name in enumerate(output_names):
                output = httpclient.InferRequestedOutput(name)
                output.set_shared_memory(client_name, 64, offset=8 + 64 * i)
                outputs.append(output)
            result = client.infer(model, inputs, outputs=outputs)
            responses[side] = result.get_response()
            for name in output_names:
                assert result.as_numpy(name) is None  # in the region, not inline
            written[side] = bytes(target.buf(0, target.byte_size()))
            _unregister(client, kind, source.name())
            _unregister(client, kind, client_name)
    finally:
        regions.close()
    assert responses["torch"]["outputs"] == responses["jax"]["outputs"]
    for out in responses["torch"]["outputs"]:
        assert "data" not in out and out["parameters"]["shared_memory_region"] == f"out_{tag}"
    assert written["torch"] == written["jax"]
    if model == "simple":
        a, b = arrays[0][1], arrays[1][1]
        assert written["torch"][8:72] == (a + b).tobytes()
        assert written["torch"][72:136] == (a - b).tobytes()
    else:
        assert written["torch"][8:8 + nbytes[0]] == arrays[0][1].tobytes()


def test_image_classifier_with_a_tpu_input_and_class_count(servers):
    """The small classifier (bf16, the same seed-0 weights on both) reads
    its image from a TPU region; its top 3 over ``class_count=3`` agree
    with the reference's logits within 2 % of the largest |logit|."""
    image = np.random.default_rng(11).normal(
        size=[1, IMAGE_SIZE, IMAGE_SIZE, 3]).astype(np.float32)
    region = tpushm.create_shared_memory_region(f"img_{_tag()}", image.nbytes)
    answers = {}
    try:
        tpushm.set_shared_memory_region_from_torch(region, [torch.from_numpy(image)])
        for side, client in servers.items():
            _register(client, "tpu", region)
            tensor = httpclient.InferInput("INPUT", list(image.shape), "FP32")
            tensor.set_shared_memory(region.name(), image.nbytes)
            top = client.infer("image_classifier", [tensor], outputs=[
                httpclient.InferRequestedOutput("OUTPUT", class_count=3)]).as_numpy("OUTPUT")
            logits = client.infer("image_classifier", [tensor]).as_numpy("OUTPUT")
            answers[side] = ([s.decode().split(":") for s in top.reshape(-1)], logits[0])
            _unregister(client, "tpu", region.name())
    finally:
        tpushm.destroy_shared_memory_region(region)
    ours, (theirs, logits) = answers["torch"], answers["jax"]
    tol = 2e-2 * np.abs(logits).max()
    np.testing.assert_allclose(ours[1], logits, rtol=0, atol=tol)
    assert len(ours[0]) == len(theirs) == 3
    for (value, index), (ref_value, _) in zip(ours[0], theirs):
        assert abs(float(value) - logits[int(index)]) <= tol  # a reference logit
        assert abs(float(value) - float(ref_value)) <= tol  # the same rank's value


def test_status_unregister_and_cuda_refusal_answer_as_the_jax_server(servers):
    tag = _tag()
    regions = _Regions("port")
    statuses = {}
    try:
        sys_region = regions.create("system", f"st_{tag}", 48)
        tpu_region = regions.create("tpu", f"tt_{tag}", 48)
        for side, client in servers.items():
            _register(client, "system", sys_region)
            _register(client, "system", sys_region)  # idempotent
            _register(client, "tpu", tpu_region)
            with pytest.raises(ClientError, match="different parameters"):
                client.register_system_shared_memory(sys_region.name(), sys_region.key(), 16)
            with pytest.raises(ClientError, match="TPU or system shared memory"):
                client.register_cuda_shared_memory(f"cu_{tag}", b"\x00" * 64, 0, 48)
            with pytest.raises(ClientError, match="not 'tpu'"):
                client.unregister_tpu_shared_memory(sys_region.name())
            client.unregister_system_shared_memory(f"never_{tag}")  # unknown: a no-op
            statuses[side] = {
                "system": [r for r in client.get_system_shared_memory_status()
                           if r["name"].endswith(tag)],
                "system_one": client.get_system_shared_memory_status(sys_region.name()),
                "tpu": [r for r in client.get_tpu_shared_memory_status()
                        if r["name"].endswith(tag)],
                "tpu_one": client.get_tpu_shared_memory_status(tpu_region.name()),
                "cuda": client.get_cuda_shared_memory_status(),
            }
            client.unregister_system_shared_memory(sys_region.name())
            client.unregister_tpu_shared_memory()
            statuses[side]["after"] = (client.get_system_shared_memory_status(sys_region.name()),
                                       client.get_tpu_shared_memory_status())
    finally:
        regions.close()
    assert statuses["torch"] == statuses["jax"]
    ours = statuses["torch"]
    assert ours["system"] == ours["system_one"] == [
        {"name": sys_region.name(), "key": sys_region.key(), "offset": 0, "byte_size": 48}]
    assert ours["tpu"] == [{"name": tpu_region.name(), "device_id": 0, "byte_size": 48,
                            "key": tpu_region.key()}]
    assert ours["cuda"] == [] and ours["after"] == ([], [])


@pytest.mark.parametrize("kind,body", [
    ("system", b"{not json"),
    ("system", b'{"byte_size": 4}'),
    ("system", b'{"key": 5, "byte_size": 4}'),
    ("system", b'{"key": "ctt_no_such_key", "byte_size": 4}'),
    ("tpu", b'{"raw_handle": {"b64": "!!"}, "byte_size": 4}'),
    ("tpu", b'{"raw_handle": "x", "byte_size": 4}'),
    ("tpu", b'{"raw_handle": {"b64": "bm90IGpzb24="}, "byte_size": 4}'),
])
def test_malformed_registrations_are_a_400(kind, body):
    """The port answers a registration it cannot use with a 400 and an
    error, whatever part of the body is wrong."""
    import http.client

    server = PortServer(ModelRepository())
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        conn.request("POST", f"/v2/{kind}sharedmemory/region/bad/register", body=body)
        response = conn.getresponse()
        assert response.status == 400
        assert "error" in json.loads(response.read())
        conn.close()
        assert server.core.shm.status(kind) == {}
    finally:
        server.close()


def test_a_too_small_output_region_fails_on_both_servers(servers):
    values = np.arange(10, dtype=np.float32)
    regions = _Regions("port")
    try:
        target = regions.create("system", f"small_{_tag()}", 64)
        for client in servers.values():
            _register(client, "system", target)
            tensor = httpclient.InferInput("INPUT0", [10], "FP32")
            tensor.set_data_from_numpy(values)
            output = httpclient.InferRequestedOutput("OUTPUT0")
            output.set_shared_memory(target.name(), 16)
            with pytest.raises(ClientError, match="too small: need 40 bytes, have 16"):
                client.infer("identity_fp32", [tensor], outputs=[output])
            _unregister(client, "system", target.name())
    finally:
        regions.close()


# ---------------------------------------------------------------------------
# the port's core
# ---------------------------------------------------------------------------


def test_a_dynamic_batch_writes_each_request_into_its_own_region():
    core = ServerCore(ModelRepository(), max_workers=2)
    core.repository.add_model(AddSubModel(device="cpu"))
    tag = _tag()
    regions = [shm.create_shared_memory_region(f"b{i}_{tag}", f"ctt_b{i}_{tag}", 128,
                                               create_only=True) for i in range(4)]
    try:
        requests = []
        for i, region in enumerate(regions):
            core.shm.register_system(region.name(), region.key(), 0, 128)
            a = np.full([1, 16], i, dtype=np.int32)
            b = np.arange(16, dtype=np.int32)[None]
            inputs = [core.decode_input("INPUT0", "INT32", [1, 16], raw=a.tobytes()),
                      core.decode_input("INPUT1", "INT32", [1, 16], raw=b.tobytes())]
            outputs = [CoreRequestedOutput("OUTPUT0", shm_region=region.name(),
                                           shm_byte_size=64),
                       CoreRequestedOutput("OUTPUT1", shm_region=region.name(),
                                           shm_byte_size=64, shm_offset=64)]
            requests.append(CoreRequest("simple", inputs=inputs, outputs=outputs))

        async def run_all():
            return await asyncio.gather(*(core.infer(r) for r in requests))

        responses = asyncio.run(run_all())
        stats = core.statistics("simple")["model_stats"][0]
        assert (stats["inference_count"], stats["execution_count"]) == (4, 1)
        for i, (region, response) in enumerate(zip(regions, responses)):
            assert response.shm_outputs == {"OUTPUT0": (region.name(), 64, 0),
                                            "OUTPUT1": (region.name(), 64, 64)}
            np.testing.assert_array_equal(shm.get_contents_as_numpy(region, np.int32, [16]),
                                          i + np.arange(16))
            np.testing.assert_array_equal(
                shm.get_contents_as_numpy(region, np.int32, [16], offset=64), i - np.arange(16))
    finally:
        core.close()
        for region in regions:
            shm.destroy_shared_memory_region(region)


def test_an_shm_input_is_a_read_only_view_of_the_region():
    core = ServerCore(ModelRepository(), max_workers=1)
    region = shm.create_shared_memory_region(f"v_{_tag()}", f"ctt_v_{_tag()}", 64,
                                             create_only=True)
    try:
        core.shm.register_system(region.name(), region.key(), 16, 48)
        shm.set_shared_memory_region(region, [np.arange(4, dtype=np.float32)], offset=20)
        tensor = core.decode_input("X", "FP32", [4], shm_region=region.name(),
                                   shm_byte_size=16, shm_offset=4)
        assert not tensor.data.flags.writeable
        np.testing.assert_array_equal(tensor.data, np.arange(4, dtype=np.float32))
        shm.set_shared_memory_region(region, [np.full(4, 5.0, np.float32)], offset=20)
        np.testing.assert_array_equal(tensor.data, np.full(4, 5.0, np.float32))  # zero-copy
        with pytest.raises(InferenceServerException, match="exceeds region size"):
            core.decode_input("X", "FP32", [12], shm_region=region.name(),
                              shm_byte_size=48, shm_offset=4)
        with pytest.raises(InferenceServerException, match="expected 16 bytes"):
            core.decode_input("X", "FP32", [4], shm_region=region.name(), shm_byte_size=8)
        del tensor
    finally:
        core.close()
        shm.destroy_shared_memory_region(region)
