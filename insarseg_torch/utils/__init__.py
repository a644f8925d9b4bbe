"""Training history files and debugging switches."""
