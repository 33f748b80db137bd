"""L5 decoder subplugins (reference ext/nnstreamer/tensor_decoder/)."""
