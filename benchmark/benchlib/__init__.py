"""The benchmark harness of rec_tpu_torch: what every cell shares (the
manifest, the device trace, the yardstick, the result line) and one driver
per kind of traffic.  Nothing here imports JAX or the JAX package."""
