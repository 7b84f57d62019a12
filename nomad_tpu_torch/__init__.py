"""nomad_tpu_torch: the PyTorch/CUDA port of nomad_tpu's scheduler.

The JAX package `nomad_tpu` is the reference and is not imported here.
This package carries its own copies of the host modules it needs
(structs, state store, oracle iterator chain, reconciler, schedulers)
and rewrites the device programs in PyTorch, with hand-written CUDA
kernels for the H100 (`csrc/`) behind wrappers that fall back to a
plain-PyTorch twin only for tensors that lie on the CPU.

Entry points run on `cuda` unless the caller passes ``device="cpu"``.
"""
