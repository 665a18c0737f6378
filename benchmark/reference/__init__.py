"""Part of the benchmark (see ../README.md)."""
