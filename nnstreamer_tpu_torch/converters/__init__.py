"""Converter subplugins (reference ext/nnstreamer/tensor_converter/):
parse other media into tensor streams for ``tensor_converter
mode=custom-code:<name>``. Protocol (duck-typed):
``get_out_config(caps) -> TensorsConfig | None`` and
``convert(buf, in_caps) -> TensorBuffer``. The port has the ``python3``
converter; the flexbuf and protobuf codecs wait for ROADMAP 26d."""
