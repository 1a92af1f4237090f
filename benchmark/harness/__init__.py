"""The benchmark harness of navdv_torch (see ``benchmark/run.py``)."""
