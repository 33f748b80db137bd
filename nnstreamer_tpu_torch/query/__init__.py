"""Distributed query transport: wire protocol and server core (the JAX
package's ``query`` wire, classic and resilient), the reference two-port
wire, the resilience primitives and the fleet balancer, and the pub/sub
layer: the shim and MQTT brokers, SNTP clock correction and broker
discovery."""
