"""Distribution layer of the port.  Only ``stats`` (the analytic collective
counts; a copy of the JAX package's module) is here yet: interval sharding,
document sharding across devices and multi-host serving are still to port
(ROADMAP.md)."""
