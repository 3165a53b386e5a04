"""The benchmark of ``deconv3d_tpu_torch`` on one NVIDIA H100: see
``README.md`` and ``BENCHMARK.json`` at the repository's root."""
