"""The system: DBSCAN's round drivers, the engine registry, the grid,
grid-hash and brute engines and their layouts, union-find and label
helpers."""
