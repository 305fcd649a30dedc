"""BN folding, weight import from the JAX package's pytrees, npz
checkpoints, logging and seeding."""
