"""Camera, tile-binned rasterizer, shading, shadow and the compact pipeline."""
