"""Launchers of the port: the clustering driver CLI (``cluster``), the
training driver CLI (``train``) and device meshes (``mesh``)."""
