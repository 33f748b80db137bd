"""Plain PyTorch references, one file a configuration (``<config>.py``),
and what they share (``mobilenet.py``). They import nothing of the port
and take nothing the port made: the benchmark hands them the same seeded
weights and frames it hands the port."""
