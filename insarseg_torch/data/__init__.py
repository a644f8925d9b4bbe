"""Scene tiling and stitching."""
