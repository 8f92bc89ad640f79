"""Part of the benchmark of relp_tpu_torch (see portbench/__init__.py)."""
