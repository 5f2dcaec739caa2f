"""Static analysis of the port: nicelint and cudalint.

nicelint (``rules/``) holds the port's tree to the invariants the
reference's nicelint holds ``nice_tpu/`` to, where they bear on the port:

==== =====================================================================
D1   device-sync discipline: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
     ``.numpy()`` / ``synchronize()`` only at ``# nicelint: fence`` sites
     in ``ops/engine.py`` and ``parallel/mesh.py``
M1   metrics discipline: every ``nice_*`` series name used in the port is
     declared in ``obs/series.py``, with literal (bounded) label sets
K1   no environment read anywhere in the port: knobs are flags/arguments
A1   atomic-write discipline: state files written only via
     ``nice_tpu_torch.utils.fsio``
==== =====================================================================

cudalint (``cudarules/``, over the registry in ``kernelspec.py``) is the
twin of the reference's jaxlint J2 and J6, which trace jaxprs and so
cannot read a CUDA kernel:

==== =====================================================================
C2   the int32 budget: every declared accumulator bound and scalar domain
     of K1-K5, checked by integer arithmetic over the spec's domain
C6   spec drift: coverage of every C entry point a wrapper loads, the
     plain versions' shapes, the constants and tier capacities written in
     Python and in CUDA, and the ctypes ABI against the C prototypes
==== =====================================================================

Both ratchet against ``analysis/baseline.json`` (empty) and share the
escapes ``# nicelint: allow <RULE> (reason)`` and ``# nicelint: fence``
and the S1 dead-suppression audit. The modules import only the standard
library (and the port's own stdlib-only modules); C6's shape check alone
imports torch, to run the plain versions. Nothing here needs a card or
nvcc. Run ``python -m nice_tpu_torch.scripts.nicelint --strict`` and
``python -m nice_tpu_torch.scripts.cudalint --strict``.
"""
