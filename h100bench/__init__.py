"""The H100 benchmark of the PyTorch and CUDA port (``proteingym_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that belongs
to one configuration, traffic mix, per-layer metric or cell lives in files
of its own that the harness finds by name: ``configs/``, ``traffic/``,
``metrics/``, ``checks/``, with a model family's adapter in ``families/``
and each kind of traffic's generator and entry call in ``kinds/``.
"""
