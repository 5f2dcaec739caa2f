"""Graceful degradation of the client's submit path: the on-disk submission
spool (spool.py)."""
