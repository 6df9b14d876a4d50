"""ebwt2indel on PyTorch and CUDA: reference-free SNP/indel discovery from
the extended BWT of a read collection, ported from the JAX package
``ebwt2indel_tpu`` (which stays in the repository as the reference).

Mode 1 (genotyping one collection) runs end to end; every rank query of it
goes through the hand-written CUDA kernel ``csrc/rank_decode.cu`` on the card.
Entry points take ``device`` (default ``"cuda"``) and raise without a GPU
unless ``device="cpu"`` is asked for.
"""

__version__ = "0.1.0"
