"""Hopper kernels of the port, their plain versions and the ops that
dispatch between them. Importing this package builds nothing: a kernel
is compiled the first time a CUDA tensor reaches it."""
