"""ebwt2indel on PyTorch and CUDA: reference-free SNP/indel discovery from
the extended BWT of a read collection, ported from the JAX package
``ebwt2indel_tpu`` (which stays in the repository as the reference).

Modes 1, 2 and 3 run end to end, as do the host tools of the evaluation
path (``tools/``) and the piece-parallel ``pebwt2indel``; every rank query
goes through the hand-written CUDA kernel ``csrc/rank_decode.cu`` on the
card. Entry points take ``device`` (default ``"cuda"``) and raise without a
GPU unless ``device="cpu"`` is asked for.
"""

__version__ = "0.1.0"
