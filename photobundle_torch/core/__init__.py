"""The solve: residuals, Schur complement, LM (twin of photobundle_tpu.core)."""
