"""The benchmark of ``ebwt2indel_torch`` on NVIDIA GPUs; see README.md."""
