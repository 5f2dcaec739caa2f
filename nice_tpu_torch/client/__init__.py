"""Search client: claim -> process -> submit, and offline benchmarks."""
