"""cruise_control_tpu_torch — the PyTorch/CUDA port of ``cruise_control_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``model/tensor_model.py`` here is the counterpart of
``cruise_control_tpu/model/tensor_model.py``) and imports neither ``jax``
nor anything of the JAX package.  Plain tensor code is PyTorch; the hot
device programs of the main path are CUDA C++ kernels for Hopper
(``csrc/*.cu``), each with a plain PyTorch twin in the module of its
wrapper.  The twin is what runs for CPU tensors; a CUDA tensor always goes
through the kernel.

Entry points (``model.generator.generate_cluster``,
``analyzer.optimizer.optimize``, ``convert.model_from_numpy``) default to
``device="cuda"`` and raise when CUDA is absent; pass ``device="cpu"`` to run
the plain path.
"""

__version__ = "0.1.0"
