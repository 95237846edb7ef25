"""One reader per metric: ``read(record) -> float | None``."""
