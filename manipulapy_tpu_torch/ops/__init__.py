"""Kernels and their plain PyTorch versions: the step-program emitter
(``cgen``, ``fd_step``), the CUDA rollout (``cuda_rollout``) and the
engine choice (``dispatch``)."""
