"""The benchmark of tfhe_tpu_torch (see run.py)."""
