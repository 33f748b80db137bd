"""Distributed query transport: wire protocol and server core (the classic
wire of the JAX package's ``query`` package), the reference two-port wire,
and the pub/sub layer: the shim and MQTT brokers, SNTP clock correction and
broker discovery."""
