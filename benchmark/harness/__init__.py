"""The benchmark harness of efficientdet_tpu_torch (see ../run.py)."""
