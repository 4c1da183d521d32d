"""Sparse-conv ops: host topology (hashing, kernel maps), the kernel
wrappers (conv3 forward and backward, k_apply, segment_pool) with their
plain twins, and the conv and segment ops built on them, differentiable
through autograd Functions."""
