"""The benchmark of the PyTorch/CUDA port (``stencilstream_tpu_torch``).

One run is one process and one cell of ``BENCHMARK.json``::

    python3 -m benchmark.run --workload hotspot-8192 --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it
(:mod:`benchmark.spec`). Nothing here imports JAX or the JAX package.
"""
