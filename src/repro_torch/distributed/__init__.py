"""Distributed runtime of the port. So far only ``checkpoint`` (atomic,
keep-K, namespaced checkpoints), which the serving tier publishes its
snapshots through."""
