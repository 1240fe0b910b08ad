"""Dataset substrate: synthetic analogues of the paper's evaluation
datasets (``synth``, a numpy copy of the reference's)."""
