"""The negative cases of ``tests/test_negative.py`` on the port — invalid
properties, bad options, unknown subplugins, malformed wire data: each
error is typed and descriptive on the port as in the JAX package, and
where both packages raise, the port raises the same type. The query
server's garbage-connection case runs over 127.0.0.1. Every launch string
runs on the CPU.
"""

import numpy as np
import pytest

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.pipeline.element import FlowError


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return e
    return None


def _run(desc):
    """Run ``desc`` on the port. The JAX package runs it first; when the
    port raises, the JAX package must have raised the same type."""
    jax_err = _raised(lambda: jnt.parse_launch(desc).run(timeout=30))
    pipe = parse_launch(desc)
    try:
        msg = pipe.run(timeout=30)
    except Exception as e:
        assert jax_err is not None, f"the JAX package ran {desc!r}"
        assert type(e).__name__ == type(jax_err).__name__, (e, jax_err)
        raise
    return pipe, msg


class TestParseErrors:
    def test_unknown_element(self):
        with pytest.raises(ValueError, match="bogus_element"):
            parse_launch("bogus_element ! tensor_sink")

    def test_unknown_property_lists_valid_ones(self):
        with pytest.raises(KeyError, match="has:"):
            parse_launch("videotestsrc nonexist=1 ! tensor_sink")


class TestFilterErrors:
    def test_unknown_framework(self):
        with pytest.raises(ValueError, match="no filter backend"):
            _run("videotestsrc num-buffers=1 ! tensor_converter ! "
                 "tensor_filter framework=nope model=x ! tensor_sink")

    def test_unknown_jax_model(self):
        with pytest.raises(ValueError, match="cannot load model"):
            _run("videotestsrc num-buffers=1 ! tensor_converter ! "
                 "tensor_filter framework=jax model=missing ! tensor_sink")

    def test_filter_without_model(self):
        with pytest.raises((ValueError, FlowError)):
            _run("videotestsrc num-buffers=1 ! tensor_converter ! "
                 "tensor_filter framework=jax ! tensor_sink")

    def test_custom_unknown_name(self):
        with pytest.raises((ValueError, FlowError), match="custom"):
            _run("videotestsrc num-buffers=1 ! tensor_converter ! "
                 "tensor_filter framework=custom model=nope ! tensor_sink")


class TestTransformDecoderErrors:
    def test_bad_transform_mode(self):
        with pytest.raises(FlowError, match="unknown transform mode"):
            _run("videotestsrc num-buffers=1 ! tensor_converter ! "
                 "tensor_transform mode=wat option=1 ! tensor_sink")

    def test_bad_arithmetic_op(self):
        with pytest.raises(FlowError, match="unknown arithmetic op"):
            _run("videotestsrc num-buffers=1 ! tensor_converter ! "
                 "tensor_transform mode=arithmetic option=frobnicate:2 ! "
                 "tensor_sink")

    def test_unknown_decoder_mode(self):
        with pytest.raises(FlowError, match="no decoder subplugin"):
            _run("videotestsrc num-buffers=1 ! tensor_converter ! "
                 "tensor_decoder mode=nope ! tensor_sink")

    def test_bounding_boxes_unknown_submode(self):
        from nnstreamer_tpu_torch.decoders.bounding_boxes import BoundingBoxes
        from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

        dec = BoundingBoxes()
        with pytest.raises(ValueError, match="unknown mode"):
            dec.decode(TensorBuffer([np.zeros((4, 4), np.float32)]),
                       None, {"option1": "wat"})


class TestTypeErrors:
    def test_bad_dim_string(self):
        from nnstreamer_tpu_torch.tensors.types import TensorsInfo

        with pytest.raises(ValueError):
            TensorsInfo.from_str("x:y", "uint8")

    def test_bad_type_string(self):
        from nnstreamer_tpu_torch.tensors.types import TensorsInfo

        with pytest.raises(ValueError, match="uint99"):
            TensorsInfo.from_str("4", "uint99")

    def test_too_many_tensors(self):
        from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
        from nnstreamer_tpu_torch.tensors.types import NNS_TENSOR_SIZE_LIMIT

        with pytest.raises(ValueError, match="exceeds"):
            TensorBuffer([np.zeros(1)] * (NNS_TENSOR_SIZE_LIMIT + 1))


class TestRegistryErrors:
    def test_unknown_subplugin_returns_none(self):
        from nnstreamer_tpu_torch.registry import get_subplugin

        assert get_subplugin("filter", "zzz_not_there") is None

    def test_unregister_missing_returns_false(self):
        from nnstreamer_tpu_torch.registry import unregister_subplugin

        assert unregister_subplugin("filter", "zzz_not_there") is False


class TestProtocolRobustness:
    def test_server_survives_garbage_connection(self):
        """Garbage bytes on the query port must not kill the server; a
        well-behaved client connecting afterwards still works."""
        import socket

        from nnstreamer_tpu_torch.filters import register_custom_easy
        from nnstreamer_tpu_torch.tensors.types import TensorsInfo

        info = TensorsInfo.from_str("3:8:8:1", "uint8")
        register_custom_easy("passthrough_n",
                             lambda ins: [np.asarray(ins[0])], info, info)
        server = parse_launch(
            "tensor_query_serversrc name=ssrc port=0 ! "
            "tensor_filter framework=custom-easy model=passthrough_n ! "
            "tensor_query_serversink")
        server.start()
        try:
            port = server.get("ssrc").port
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            s.sendall(b"\xde\xad\xbe\xef" * 64)
            s.close()

            client = parse_launch(
                "videotestsrc num-buffers=2 width=8 height=8 ! "
                "tensor_converter ! "
                f"tensor_query_client dest-host=127.0.0.1 dest-port={port} ! "
                "tensor_sink name=out")
            msg = client.run(timeout=30)
            assert msg is not None and msg.kind == "eos", msg
            assert len(client.get("out").buffers) == 2
        finally:
            server.stop()
            from nnstreamer_tpu_torch.filters.custom import unregister_custom_easy
            unregister_custom_easy("passthrough_n")

    def test_sparse_decode_garbage(self):
        from nnstreamer_tpu_torch.elements.sparse import sparse_decode

        with pytest.raises((ValueError, IndexError)):
            sparse_decode(b"\x01\x02\x03")
