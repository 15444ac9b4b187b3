"""The drivers: one a kind of configuration, found by its ``kind``."""
