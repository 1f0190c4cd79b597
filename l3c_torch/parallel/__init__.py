"""Parallel paths: data-parallel training, the codec fan-out, sharded eval
and spatial (height) sharding.

Port of `l3c_tpu/parallel/`. The JAX package runs all of them in one
process over `jax.devices()`. Here training is DDP with one process a
card (`mesh`), and the fan-out, sharded eval and spatial sharding stay in
one process over a list of device slots (`mesh.local_devices`), each slot
running the same kernels as the single-device path on its card's default
stream.
"""
