"""The entries of the program that a call drives, one module each, named
by a traffic mix's ``op``. Each has ``setup(ctx)``, run once at set-up
with the pooled datasets (``harness.Context``), and ``call(ctx, job,
span)``, which runs call ``job`` (``harness.Job``: dataset, ε, minPts),
marks its parts with ``span(name)`` and returns a ``harness.Output``
with the labels on the host."""
