"""Deterministic fault injection (injector.py: `fire(site, **ctx)`, armed
by the client's --faults) and graceful degradation of the client's submit
path: the on-disk submission spool (spool.py)."""
