"""Distributed query transport: wire protocol and server core (the classic
wire of the JAX package's ``query`` package)."""
