"""genestrip_tpu_torch — the PyTorch/CUDA port of genestrip_tpu.

The JAX package `genestrip_tpu` is the reference; this package mirrors its
layout and module names so that each module's counterpart is easy to find.

Rules the port keeps:
  * It imports torch and never jax, and never `genestrip_tpu` either:
    `genestrip_tpu/__init__.py` imports jax unconditionally, and the GPU
    machine has no JAX. The pure-numpy host modules it needs are therefore
    carried over as copies (utils/, io/, tax/, match/results.py, report/,
    config.py, project.py) that differ from their originals only in the
    import prefix; tests/test_torch_vendored.py guards against drift.
  * Devices are explicit: every entry point takes a `torch.device`. Nothing
    picks a device by probing. A kernel wrapper runs its plain PyTorch
    version only for tensors on the CPU; for a CUDA tensor it launches the
    hand-written kernel or raises.
  * Importing a module does no CUDA work and builds no kernel; kernels are
    compiled on first use (ops/_build.py).
"""

__version__ = "0.1.0"
