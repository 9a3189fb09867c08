"""Config overrides, logging and timing (port of rec_tpu/utils)."""
