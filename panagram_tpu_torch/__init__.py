"""panagram_tpu_torch: the pan-genome k-mer index build in PyTorch + CUDA.

The port of panagram_tpu (JAX on a TPU) to PyTorch on an NVIDIA H100.  It
runs the ``index`` build on one device or a mesh: per-genome canonical
k-mer counting, the presence-mask dictionary, the bucketed hash table,
anchoring of every anchor genome and genome distances, and writes the same
index files as panagram_tpu for the same readers; ``Index(index_dir)``
reads them back.  The anchor chunk's four device steps are CUDA kernels
written for Hopper (``csrc/``, wrapped in ``ops/kernels.py``), each with a
plain torch version that runs on the CPU.  The package and its ``ops``,
``io`` and ``parallel`` subpackages export panagram_tpu's names; every
function with a ``device`` argument defaults to the card.

The package needs only torch, numpy and the standard library; it imports
no jax, pandas, yaml or scikit-learn.  u64 k-mer keys live in int64 tensors
as the same bit patterns (see ``ops/codec.py``).
"""

from .__about__ import __version__
from .index import Index

__all__ = ["Index", "__version__"]
