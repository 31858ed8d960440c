"""Hand-written CUDA kernels of the port, one package per TPU kernel
family, after the `repro.kernels` convention: ``ops.py`` is the public
wrapper (it dispatches on the tensors' device), ``ref.py`` the plain
PyTorch version of the same function, and the CUDA source lives in
``src/repro_torch/csrc/``. Every wrapper counts its launches in a
``launches`` attribute, so a run can show which kernels it went through.
"""
