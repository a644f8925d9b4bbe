"""Training history files."""
