"""Training substrate (the port of ``repro.train``): ``optimizer`` (AdamW
with global-norm clipping and a cosine schedule) and ``trainer`` (the
train step with microbatch accumulation, the loop with checkpoint and
exact resume, and the straggler watchdog). Plain PyTorch and autograd,
as the reference computes them in plain ``jnp`` and ``jax.grad``."""
