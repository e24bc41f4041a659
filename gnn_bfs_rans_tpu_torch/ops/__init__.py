"""The non-banded aggregation backends: ``segment`` (COO) and ``dense``."""
