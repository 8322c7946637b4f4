"""Plain PyTorch references of what the benchmark's cells run.

Nothing here imports the program under test (``image_caption_tpu_torch``)
or JAX.  Parameters are handed in as the nested dicts of tensors that
``benchmark/data/weights.py`` makes from the seed, the same objects the
program is given.
"""
