"""Image sampling and patches (twin of photobundle_tpu.image)."""
