"""nice-tpu-torch: the PyTorch/CUDA port of nice-tpu, for one NVIDIA H100.

The JAX package `nice_tpu` stays beside this one as the reference; this
package imports nothing of it (nor JAX) and keeps its own cut-down copies of
the jax-free modules it needs, under the same relative paths.

Layer map (mirrors `nice_tpu`):
  core/    domain types, base-range math, near-miss cutoff, benchmark fields
  ops/     Python-int oracle (scalar.py), plain PyTorch twins of the kernels
           (vector_engine.py), the hand-written CUDA kernels (../csrc, built
           by cuda_build.py, wrapped by cuda_engine.py) and the field engine
  client/  claim -> process -> submit CLI against the coordination server

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU; a missing card raises instead of falling back.
"""

__version__ = "0.1.0"

CLIENT_VERSION = __version__
