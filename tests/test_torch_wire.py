"""The port's wire codec (`nomad_tpu_torch/wire.py`) against the JAX
package's (`nomad_tpu/wire.py`) and the C++ shim (`native/`).

Every sample of `tests/test_wire.py` round-trips through the port's
codec, encodes to the same bytes as the JAX package's, and the native
library (built with `make -C native` into a private directory, skipped
without a C++ toolchain) decodes and encodes the same bytes.  Across the
process seam: a JAX client calls a port service, a port client calls a
JAX service, and the native client calls a port service.
"""
import socket
import struct
import subprocess

import pytest

from nomad_tpu import mock as jmock
from nomad_tpu import wire as jwire
from nomad_tpu.server import Server as JServer
from nomad_tpu.server.bridge_service import BridgeService as JBridge
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch import wire as twire
from nomad_tpu_torch.server import Server as TServer
from nomad_tpu_torch.server.bridge_service import BridgeService as TBridge
from test_wire import SAMPLES

NATIVE_DIR = twire._NATIVE_PATH.rsplit("/", 1)[0]


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    lib = tmp_path_factory.mktemp("native") / "libnomadwire.so"
    try:
        subprocess.run(
            ["make", "-C", NATIVE_DIR, f"TARGET={lib}"],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.CalledProcessError) as exc:
        pytest.skip(f"native toolchain unavailable: {exc}")
    return twire.NativeWire(str(lib))


@pytest.mark.parametrize("value", SAMPLES)
def test_port_codec_roundtrip(value):
    assert twire.decode(twire.encode(value)) == value


@pytest.mark.parametrize("value", SAMPLES + [b"\x00\xff", (1, "t")])
def test_port_codec_bytes_equal_jax(value):
    encoded = twire.encode(value)
    assert encoded == jwire.encode(value)
    assert twire.decode(encoded) == jwire.decode(encoded)


@pytest.mark.parametrize("value", SAMPLES)
def test_native_codec_matches_port(native, value):
    encoded = twire.encode(value)
    assert native.encode_json(value) == encoded
    assert native.decode_json(encoded) == value


def test_native_version(native):
    assert native.version().startswith("nomad-tpu-wire/")


def test_native_path_is_the_repositorys():
    assert twire._NATIVE_PATH == jwire._NATIVE_PATH


def test_decode_rejects_bad_input():
    with pytest.raises(ValueError, match="trailing"):
        twire.decode(twire.encode(1) + b"\x00")
    with pytest.raises(ValueError, match="unknown wire tag"):
        twire.decode(b"\xc1")
    with pytest.raises(TypeError):
        twire.encode(object())


def test_frames_and_their_cap():
    a, b = socket.socketpair()
    try:
        twire.send_frame(a, b"hello")
        assert twire.recv_frame(b) == b"hello"
        a.sendall(struct.pack(">I", twire.MAX_FRAME + 1))
        with pytest.raises(ValueError, match="cap"):
            twire.recv_frame(b)
        a.close()
        assert twire.recv_frame(b) is None
    finally:
        a.close()
        b.close()


BODY = {"evals": [
    {"eval_id": "x1", "seed": 7, "count": 3, "cpu": 500, "memory_mb": 256},
    {"eval_id": "x2", "seed": 8, "count": 2, "cpu": 200, "memory_mb": 128},
]}


@pytest.fixture
def bridges():
    """A JAX and a port service over ten nodes with the same ids, in the
    same order."""
    jserver = JServer(num_schedulers=0, heartbeat_ttl=1e9, seed=55)
    tserver = TServer(num_schedulers=0, heartbeat_ttl=1e9, seed=55,
                      device="cpu")
    for i in range(10):
        jserver.store.upsert_node(jmock.node(id=f"wire-{i:02d}"))
        tserver.store.upsert_node(tmock.node(id=f"wire-{i:02d}"))
    services = (JBridge(jserver, port=0), TBridge(tserver, port=0))
    for svc in services:
        svc.start()
    yield services
    for svc in services:
        svc.stop()


def _call(module, service, method, body):
    sock = socket.create_connection(("127.0.0.1", service.port))
    try:
        return module.call(sock, method, body)
    finally:
        sock.close()


def test_jax_client_calls_port_service(bridges):
    jsvc, tsvc = bridges
    got = _call(jwire, tsvc, "TPUScheduler.ScoreBatch", BODY)
    assert got == _call(jwire, jsvc, "TPUScheduler.ScoreBatch", BODY)
    assert [len(r["nodes"]) for r in got["results"]] == [3, 2]
    assert _call(jwire, tsvc, "TPUScheduler.Ping", {})["nodes"] == 10


def test_port_client_calls_jax_service(bridges):
    jsvc, tsvc = bridges
    got = _call(twire, jsvc, "TPUScheduler.ScoreBatch", BODY)
    assert got == _call(twire, tsvc, "TPUScheduler.ScoreBatch", BODY)
    assert "error" in _call(twire, jsvc, "Nope.Nope", {})


def test_native_client_calls_port_service(native, bridges):
    """The full seam: C++ shim -> framed wire -> the port's service ->
    K7's twin -> C++ -> caller."""
    _jsvc, tsvc = bridges
    fd = native.connect("127.0.0.1", tsvc.port)
    try:
        assert native.call_json(fd, "TPUScheduler.Ping", {})["ok"] is True
        got = native.call_json(fd, "TPUScheduler.ScoreBatch", BODY)
    finally:
        native.close(fd)
    assert got == _call(twire, tsvc, "TPUScheduler.ScoreBatch", BODY)
