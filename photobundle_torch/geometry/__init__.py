"""SE(3) and pinhole-camera geometry (twin of photobundle_tpu.geometry)."""
