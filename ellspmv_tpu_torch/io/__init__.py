"""Matrix Market input and output."""
