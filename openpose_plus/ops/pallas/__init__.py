"""Pallas kernels (Triton route, GPU) for the grouping stage's serial tail.

Taken by the decoder when it is lowered for CUDA (postproc.decode.
serial_tail, jax.lax.platform_dependent); the CPU runs their XLA twins:
  merge.assemble_pallas        sequential CMU subset merge, dynamic trip count
  greedy.greedy_assign_pallas  per-limb greedy assignment, rounds unrolled
"""
