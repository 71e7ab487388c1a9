"""The benchmark of ``slc_tpu_torch`` on one CUDA card (see run.py)."""
