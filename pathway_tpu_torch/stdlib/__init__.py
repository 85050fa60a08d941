"""The standard library: retrieval indexes (``stdlib.indexing``)."""
