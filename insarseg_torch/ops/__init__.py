"""Layers, blocks and numeric primitives of the port (NCHW inside)."""
