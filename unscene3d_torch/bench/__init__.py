"""Prototype entry points of the port (counterparts of benchmarks/proto_*.py):
each times one hand-written kernel on the bench scene's level 0."""
