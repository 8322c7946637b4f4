"""Per-layer metrics: one reader a file, ``read(run)`` -> value or None."""
