"""Launchers of the port: the clustering driver CLI (``cluster``), the
training driver CLI (``train``), device meshes (``mesh``) and the multi-pod
dry run (``dryrun``, with the card's roofline model in ``analysis`` and the
eager cost counter ``op_costs``)."""
