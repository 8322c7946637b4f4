"""The benchmark of ``image_caption_tpu_torch`` on NVIDIA H100 cards.

``run.py`` runs one cell of ``BENCHMARK.json``; everything a cell needs is
found by name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``.  ``reference/`` is the
plain PyTorch reference that decides ``correct``; it imports nothing of the
program.
"""
