"""Converter subplugins (reference ext/nnstreamer/tensor_converter/):
parse other media into tensor streams for ``tensor_converter
mode=custom-code:<name>``. Protocol (duck-typed):
``get_out_config(caps) -> TensorsConfig | None`` and
``convert(buf, in_caps) -> TensorBuffer``. The port has the ``python3``
converter and the reference serialization codecs: ``flexbuf`` and
``nnstpu-flex`` (``converters/flexbuf.py``), ``protobuf``
(``converters/protobuf_codec.py``) and ``flatbuf``, whose converter lives
with its decoder in ``decoders/flatbuf_codec.py``."""
