"""mimo_tpu_torch — the PyTorch/CUDA port of mimo_tpu for NVIDIA Hopper.

Module names and public function names follow ``mimo_tpu`` so each module's
counterpart is easy to find. This package imports ``torch`` and never
``jax`` or ``mimo_tpu``. Hand-written CUDA kernels live in ``csrc/`` and are
built at first use by ``ops/_build.py``.
"""
