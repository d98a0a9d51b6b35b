"""The benchmark of detjax_torch on one NVIDIA H100: see README.md."""
