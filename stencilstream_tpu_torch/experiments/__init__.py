"""The port of the JAX package's ``experiments/`` kernel microbenchmarks.

Two CUDA kernels stand for the five TPU kernels there: :mod:`.strip`
(``csrc/micro_strip.cu``) for ``micro_shifts.py``, ``micro_operands.py``
and ``micro_order.py``, and :mod:`.linecache` (``csrc/micro_linecache.cu``)
for ``micro_linecache.py`` and ``lc_bisect.py``. Each script has an entry
point of its name here (``python -m
stencilstream_tpu_torch.experiments.<script>``), which runs on the card
(``--device cuda``, the default) and on the CPU only through the plain
versions (``--device cpu``, for the tests).
"""
