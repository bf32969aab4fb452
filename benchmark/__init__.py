"""The benchmark of jda_tpu_torch (see run.py)."""
