"""BN folding and weight import from the JAX package's pytrees."""
