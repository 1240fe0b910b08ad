"""The system: DBSCAN's round drivers, the engine registry, the grid engine
and its CSR layout, union-find and label helpers."""
