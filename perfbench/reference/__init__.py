"""The plain reference: straightforward PyTorch of the published
architectures, in float32 (TF32 off), with no kernel, cache or batching
trick.  It imports neither JAX nor the JAX package nor anything of the
program (``repro_torch``), and takes nothing the program made: the
benchmark hands it the weights and tokens it drew itself."""
