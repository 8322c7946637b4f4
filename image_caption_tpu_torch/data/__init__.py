"""Feature splits, decode batches and detokenization."""
