"""distributed_pipeline_tpu_torch: the PyTorch/CUDA port of
``distributed_pipeline_tpu`` for NVIDIA H100 GPUs.

Module names and layout follow the JAX package, so each module has a
counterpart there. The port imports torch and numpy, never JAX, and nothing
of the JAX package. Its entry points run on CUDA unless the caller asks for
the CPU. This slice serves GPT-2 through continuous batching; the
decode-step attention is a hand-written CUDA kernel (ops/csrc/).
"""
