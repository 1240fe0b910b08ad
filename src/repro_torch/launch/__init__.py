"""Launchers of the port: the clustering driver CLI (``cluster``)."""
