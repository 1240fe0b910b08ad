"""Baseline DBSCAN implementations the paper compares against (§V-B).

  * ``brute.reference_dbscan`` — faithful sequential Algorithm 1 (numpy);
    the correctness oracle for everything else.
  * ``fdbscan`` — FDBSCAN (Prokopenko et al.): BVH traversal + union-find,
    optional early traversal termination (§VI-B).
  * ``gdbscan`` — G-DBSCAN (Andrade et al.): materialized adjacency + BFS;
    O(n²) memory, faithful to its >100K-point OOM behavior.
  * ``dclust`` — CUDA-DClust+-style incremental label propagation
    (chain growth without union-find; O(diameter) rounds).
"""
# Submodules are imported directly (``from repro_torch.baselines import
# brute``); no eager imports here, so the package import stays light.
