"""Data pipeline: tokenized corpora, packing, sharded batches."""
