"""Utilities: checkpoints (packed format, async saver, ``.pth`` interop),
the weight carrier from the JAX package, the run logger, profiling and
console meters."""
