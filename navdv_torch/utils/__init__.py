"""Utilities (counterpart of the JAX package's ``navdv_tpu.utils``).

:mod:`navdv_torch.utils.profiling` holds the port's spans, the step's
stage marks and the recording that reads them, and traces a run and ranks
its operations.
The JAX package's ``compile_cache`` has no counterpart: it keeps XLA
executables across processes, and the port compiles nothing at run time
except its CUDA kernels, which ``navdv_torch._build`` already keeps in a
content-hashed cache under ``build/``.
"""
